"""Timing, progress and device profiling (PyTorch port of the JAX
package's ``utils/timer.py``): a wall-clock block timer, a per-frame
progress line with an ETA, per-stage frames/s with a JSON report, and a
``torch.profiler`` trace of a block."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


@contextlib.contextmanager
def timer(name="task", out=None):
    """``with timer('stage'):`` prints the block's wall time on exit; with
    ``out`` (a dict) it also adds the time under ``name``."""
    start = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - start
        if out is not None:
            out[name] = out.get(name, 0.0) + dt
        print(f"{name} took: {dt:.4f} s")


class Progress:
    """A per-frame progress line: percent, ETA and the last batch's
    latency and rate."""

    def __init__(self, total, label="frame", stream=sys.stdout):
        self.total = total
        self.done = 0
        self.label = label
        self.start = time.perf_counter()
        self.last = self.start
        self.stream = stream

    def step(self, n=1):
        self.done += n
        now = time.perf_counter()
        pct = 100.0 * self.done / self.total if self.total else 0.0
        avg = (now - self.start) / max(self.done, 1)
        rem = avg * max(self.total - self.done, 0)
        self.stream.write(
            f"[{pct:5.1f}%] {self.label} {self.done}/{self.total} | "
            f"eta {int(rem) // 60}m{int(rem) % 60:02d}s | "
            f"last batch {now - self.last:6.3f}s "
            f"({n / max(now - self.last, 1e-9):.2f}/s)\r")
        self.stream.flush()
        self.last = now

    def close(self):
        dt = time.perf_counter() - self.start
        self.stream.write(
            f"\n{self.done} {self.label}s in {dt:.2f}s "
            f"({self.done / max(dt, 1e-9):.2f}/s)\n")


class StageMetrics:
    """Frames and seconds per stage, reported with frames/s as a dict or
    a JSON file."""

    def __init__(self):
        self.stages = {}

    def record(self, stage, frames, seconds):
        s = self.stages.setdefault(stage, {"frames": 0, "seconds": 0.0})
        s["frames"] += frames
        s["seconds"] += seconds

    def report(self):
        return {k: {**v, "fps": v["frames"] / max(v["seconds"], 1e-9)}
                for k, v in self.stages.items()}

    def dump(self, path):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.report(), f, indent=2)


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
