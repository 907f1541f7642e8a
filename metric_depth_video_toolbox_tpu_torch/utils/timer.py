"""Device profiling for the port's commands (the counterpart of the JAX
package's ``utils/timer.py::device_trace``)."""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def device_trace(log_dir=None):
    """Trace a block with ``torch.profiler`` (CPU and, where there is a
    card, CUDA activity) and write a Chrome trace, ``trace_<pid>_<ns>.json``,
    into ``log_dir`` (open it in chrome://tracing or Perfetto). Does
    nothing when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
