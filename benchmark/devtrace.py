"""The device's timeline over the measured window, from ``torch.profiler``
recording the card's activity alone (no host operator events, whose
teardown costs more than the window), in one session per shot.

Within a session, each benchmark span after the first starts with a
marker kernel (``torch.cuda._sleep``, "spin_kernel" on the timeline)
launched after the previous span has synchronised, so the kernels and
copies between two markers belong to the span the first one opened, and
those before the first marker to the session's first span: no clock has
to be matched between the host and the card. No marker sits at a
session's edge, where the profiler may drop an activity that its clock
puts outside the session. Busy time is the union of kernel, copy and set
intervals, not a sum.
"""

from __future__ import annotations

import contextlib
import time

import torch

MARKER = "spin_kernel"


def mark():
    """Open a span on the device's timeline."""
    torch.cuda._sleep(1)


def _kind(name):
    low = name.lower()
    if low.startswith("memcpy"):
        return "copy"
    if low.startswith("memset"):
        return "set"
    return "kernel"


def _events(prof):
    """(start_ns, end_ns, name, kind) of each device activity, in order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append((start, start + dur, e.name(),
                    _kind(e.name())))
    out.sort()
    return out


def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class Timeline:
    """The traced window: ``parts`` is a list of (events, labels), one per
    profiler session, the events holding one marker fewer than the labels.
    ``segments`` is a list of (label, [events]) in order, one per benchmark
    span, the markers left out. A session's window runs from its first
    activity on the card to its last; the time between sessions (the
    tracer's own start and stop, the hand-off of a shot) is no part of
    it."""

    def __init__(self, parts):
        self.segments = []
        self.window_ns = 0
        self._gaps = {}
        for events, labels in parts:
            marks = [i for i, ev in enumerate(events) if MARKER in ev[2]]
            if len(marks) != len(labels) - 1:
                raise RuntimeError(f"{len(marks)} markers on the timeline "
                                   f"for {len(labels)} spans")
            bounds = [-1] + marks + [len(events)]
            segs = [(lab, events[bounds[j] + 1:bounds[j + 1]])
                    for j, lab in enumerate(labels)]
            if events:
                self.window_ns += max(e for _, e, _, _ in events) \
                    - events[0][0]
            for ns, lab in _gaps(segs):
                self._gaps[lab] = self._gaps.get(lab, 0) + ns
            self.segments += segs

    @property
    def window_s(self):
        return self.window_ns / 1e9

    def busy_s(self, label=None, kinds=("kernel", "copy", "set")):
        iv = [(s, e) for lab, evs in self.segments
              if label is None or lab == label
              for s, e, _, k in evs if k in kinds]
        return union_ns(iv) / 1e9

    def total_s(self, kinds):
        return sum(e - s for _, evs in self.segments
                   for s, e, _, k in evs if k in kinds) / 1e9

    def top_ops(self, n=10):
        by = {}
        for _, evs in self.segments:
            for s, e, name, _ in evs:
                by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: kv[1], reverse=True)[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n=10):
        """Time with nothing on the card, summed by the span the host was
        in ("after <span>" from a span's last activity to the next span's
        first), the largest first."""
        top = sorted(self._gaps.items(), key=lambda kv: kv[1],
                     reverse=True)[:n]
        return [[lab, ns / 1e9] for lab, ns in top]


def _gaps(segments):
    """(ns, label) of each idle gap of one session's segments."""
    out = []
    prev_end, prev_lab = None, None
    for lab, evs in segments:
        first = evs[0][0] if evs else None
        if prev_end is not None and first is not None and first > prev_end:
            out.append((first - prev_end, f"after {prev_lab}"))
        if evs:
            prev_end = max(e for _, e, _, _ in evs)
            prev_lab = lab
    for lab, evs in segments:
        end = None
        for s, e, _, _ in evs:
            if end is not None and s > end:
                out.append((s - end, lab))
            end = e if end is None else max(end, e)
    return out


class Recorder:
    """The card's activity, traced by ``torch.profiler`` in one session
    per ``session()`` block (a shot), when ``enabled``, so that no session
    holds more device records than the profiler's bounded buffers keep.
    ``span(label)`` opens a span. ``overhead_s`` is the host time that the
    sessions' starts and stops took, which the window leaves out."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.parts = []
        self.overhead_s = 0.0
        self._labels = None

    def span(self, label):
        if self.enabled:
            if self._labels:
                mark()
            self._labels.append(label)

    @contextlib.contextmanager
    def session(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        self._labels = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        self.parts.append((_events(prof), self._labels))
        self.overhead_s += (t1 - t0) + (time.perf_counter() - t2)

    def timeline(self):
        return Timeline(self.parts) if self.parts else None
