"""Parallelism (PyTorch port of ``parallel/``).

- ``mesh``:      the ("data", "model") ``DeviceMesh`` of the train step, and
                 the frame mesh of the inference engines
- ``sharding``:  the TP plan over heads and MLP hidden dims, the batch's
                 DP slice, and the engines' frame replicas
- ``train``:     the scale-shift-invariant loss and the DP x TP train step
- ``scheduler``: scene-level fan-out over threads, processes and hosts
"""

from metric_depth_video_toolbox_tpu_torch.parallel import mesh  # noqa: F401
from metric_depth_video_toolbox_tpu_torch.parallel import \
    sharding  # noqa: F401
