"""Timing, progress and device profiling (PyTorch port of the JAX
package's ``utils/timer.py``): a wall-clock block timer, a per-frame
progress line with an ETA, a ``torch.profiler`` trace of a block, and the
program's spans.

Spans (``span``, ``add``, ``spans``, ``take``) record only while a
``torch.profiler`` session is active in the process (``--profile DIR``,
or the benchmark's traced runs); otherwise a span costs one check and
records nothing. A record holds the span's name, the index of the span it
opened in (``parent``), its host start and end from ``time.time_ns()``
(the clock of the profiler's events, so that the card's activities can be
laid against the spans), its attributes (counts set where the work
happens) and, for a span given a CUDA ``device``, the device milliseconds
between two CUDA events recorded on the current stream at entry and exit,
read once the records are asked for: the span never synchronises. Each
span also enters ``torch.profiler.record_function`` under its name, so
its name shows in a ``device_trace``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import torch

# the most records kept; spans past it are counted in ``dropped()``
MAX_RECORDS = 1_000_000


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


@contextlib.contextmanager
def device_trace(log_dir=None):
    """Trace a block with ``torch.profiler`` (CPU and, where there is a
    card, CUDA activity) and write a Chrome trace, ``trace_<pid>_<ns>.json``,
    into ``log_dir`` (open it in chrome://tracing or Perfetto); the
    program's spans show in it under their names. Does nothing when
    ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class _Log:
    """The process's span records, and each thread's open spans."""

    def __init__(self):
        self.records = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self):
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_LOG = _Log()


class span:
    """``with span("depth.encoder", device=x.device, frames=n):`` records
    one span of the program while a profiler session is active (see the
    module's docstring). ``device``: the device the block's work runs on;
    a CUDA device adds the block's device milliseconds to the record.
    Keyword arguments are the record's attributes; ``add`` adds to them
    from inside the block."""

    __slots__ = ("name", "device", "attrs", "_rec", "_rf")

    def __init__(self, name, device=None, **attrs):
        self.name = name
        self.device = device
        self.attrs = attrs
        self._rec = None

    def __enter__(self):
        if not torch.autograd._profiler_enabled():
            return self
        stack = _LOG.stack()
        rec = {"name": self.name,
               "parent": stack[-1]["index"] if stack else None,
               "index": None, "start_ns": time.time_ns(), "end_ns": None,
               "attrs": dict(self.attrs), "events": None}
        with _LOG.lock:
            if len(_LOG.records) < MAX_RECORDS:
                rec["index"] = len(_LOG.records)
                _LOG.records.append(rec)
            else:
                _LOG.dropped += 1
        dev = self.device
        if getattr(dev, "type", None) == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record(torch.cuda.current_stream(dev))
            rec["events"] = ev
        stack.append(rec)
        self._rec = rec
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is None:
            return False
        self._rec = None
        self._rf.__exit__(*exc)
        if rec["events"] is not None:
            rec["events"][1].record(torch.cuda.current_stream(self.device))
        rec["end_ns"] = time.time_ns()
        stack = _LOG.stack()
        if stack and stack[-1] is rec:
            stack.pop()
        return False


def add(key, n):
    """Add ``n`` to the attribute ``key`` of the innermost span open in
    this thread (nothing when none records)."""
    stack = getattr(_LOG.local, "stack", None)
    if stack:
        attrs = stack[-1]["attrs"]
        attrs[key] = attrs.get(key, 0) + n


def _resolved(rec):
    out = {k: v for k, v in rec.items() if k != "events"}
    out["attrs"] = dict(rec["attrs"])
    ev = rec["events"]
    out["device_ms"] = None
    if ev is not None and rec["end_ns"] is not None:
        ev[1].synchronize()
        out["device_ms"] = ev[0].elapsed_time(ev[1])
    return out


def spans():
    """The records of every closed span so far, in the order they opened:
    dicts of ``name``, ``index``, ``parent`` (an index, or None),
    ``start_ns``, ``end_ns``, ``attrs`` and ``device_ms`` (None without a
    CUDA device). Reading waits for the spans' device work."""
    with _LOG.lock:
        recs = list(_LOG.records)
    return [_resolved(r) for r in recs if r["end_ns"] is not None]


def take():
    """``spans()``, and clear the records."""
    out = spans()
    with _LOG.lock:
        _LOG.records = []
        _LOG.dropped = 0
    return out


def dropped():
    """Spans not recorded since the last ``take()`` because
    ``MAX_RECORDS`` were held."""
    return _LOG.dropped
