"""Shared utilities: timing and profiling, progress reporting, the device
switch and the kernels' build."""

from metric_depth_video_toolbox_tpu_torch.utils.timer import (  # noqa: F401
    Progress, timer)
