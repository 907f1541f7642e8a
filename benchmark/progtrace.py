#!/usr/bin/env python3
"""The program's own spans, read after a traced run's window.

The port records spans (``utils/timer.py``: ``span``, ``spans``) only
while a ``torch.profiler`` session is active, so in a ``--trace 1`` run
they cover the window's shots and nothing else, and a ``--trace 0`` run
has none. A record holds its name, its parent's index, its host start and
end on ``time.time_ns()`` (the clock of the profiler's device activities),
its counts (``frames``, ``bytes``, ``views``, ...) and, for spans of work
on the card, the device milliseconds between two CUDA events. Where the
program records no spans (a checkout without them), every reader gets
nothing to read and returns None.

The device's idle time is laid against the spans on the shared clock:
each gap between the card's activities inside a profiler session goes to
the innermost span open on the host at that moment, and the time between
two sessions (the tracer's start and stop, the hand-off of a shot) counts
for nothing, as in the traced window of ``devtrace.py``.

    python3 benchmark/progtrace.py --workload <cell> --seed <n> \
        --seconds <s>

runs one traced run of the cell (``run.py --trace 1``) and prints, after
its result line, one JSON line: each span name's count, host and device
milliseconds and summed counts, and the device's idle seconds by
innermost span.
"""

from __future__ import annotations

import bisect
import importlib
import json
import sys

TIMER = "metric_depth_video_toolbox_tpu_torch.utils.timer"


def records():
    """The program's span records, or [] where it records none."""
    try:
        mod = importlib.import_module(TIMER)
    except ImportError:
        return []
    read = getattr(mod, "spans", None)
    return read() if callable(read) else []


def named(recs, name, outside=None):
    """The records called ``name``, less those inside a span called
    ``outside``."""
    by_index = {r["index"]: r for r in recs}

    def within(r):
        p = by_index.get(r["parent"])
        while p is not None:
            if p["name"] == outside:
                return True
            p = by_index.get(p["parent"])
        return False
    return [r for r in recs if r["name"] == name
            and (outside is None or not within(r))]


def per_frame(run, total):
    """``total`` over the window's source frames, or None."""
    if total is None or not run.frames:
        return None
    return total / run.frames


def device_ms(recs, name, outside=None):
    """The summed device milliseconds of the spans called ``name``, or
    None where there is none or one has no device time."""
    got = [r["device_ms"] for r in named(recs, name, outside)]
    if not got or any(ms is None for ms in got):
        return None
    return sum(got)


def host_ms(recs, name):
    got = named(recs, name)
    if not got:
        return None
    return sum(r["end_ns"] - r["start_ns"] for r in got) / 1e6


def attr_sum(recs, name, key):
    got = [r["attrs"][key] for r in named(recs, name) if key in r["attrs"]]
    return sum(got) if got else None


def sessions(timeline):
    """The events of each profiler session, in order: the benchmark opens
    every session with a span of the same label, so a session starts at
    each segment with the first segment's label. None where the sessions
    so found do not make up the timeline's window."""
    segs = timeline.segments
    if not segs:
        return None
    out = []
    for label, evs in segs:
        if label == segs[0][0] or not out:
            out.append([])
        out[-1].extend(evs)
    window = sum(max(e for _, e, _, _ in evs) - min(s for s, _, _, _ in evs)
                 for evs in out if evs)
    return out if window == timeline.window_ns else None


def idle_intervals(timeline):
    """(start_ns, end_ns) of each stretch with nothing on the card inside
    a session, or None (see ``sessions``)."""
    parts = sessions(timeline)
    if parts is None:
        return None
    gaps = []
    for evs in parts:
        end = None
        for s, e, _, _ in sorted(evs):
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
    return gaps


def innermost(recs):
    """(start_ns, end_ns, name) pieces of host time, in order, each with
    the innermost span open over it: of the spans open, the one opened
    last."""
    marks = []
    for r in recs:
        if r["end_ns"] > r["start_ns"]:
            marks.append((r["start_ns"], 1, r["index"]))
            marks.append((r["end_ns"], 0, r["index"]))
    marks.sort()
    by_index = {r["index"]: r for r in recs}
    out, open_, prev = [], {}, None
    for t, opens, i in marks:
        if open_ and prev is not None and t > prev:
            top = max(open_.values(),
                      key=lambda r: (r["start_ns"], r["index"]))
            out.append((prev, t, top["name"]))
        if opens:
            open_[i] = by_index[i]
        else:
            open_.pop(i, None)
        prev = t
    return out


def idle_by_span(run, recs=None):
    """{innermost span name: device idle ns} over the traced window; the
    idle time outside every span under None. None without a timeline or
    records."""
    recs = records() if recs is None else recs
    if run.timeline is None or not recs:
        return None
    gaps = idle_intervals(run.timeline)
    if gaps is None:
        return None
    pieces = innermost(recs)
    starts = [p[0] for p in pieces]
    out = {}
    for g0, g1 in gaps:
        covered = 0
        j = max(bisect.bisect_right(starts, g0) - 1, 0)
        while j < len(pieces) and pieces[j][0] < g1:
            p0, p1, name = pieces[j]
            ov = min(g1, p1) - max(g0, p0)
            if ov > 0:
                out[name] = out.get(name, 0) + ov
                covered += ov
            j += 1
        out[None] = out.get(None, 0) + (g1 - g0 - covered)
    return out


def d2h_seconds(timeline):
    """The device's device-to-host copy time, from the trace."""
    return sum(e - s for _, evs in timeline.segments
               for s, e, name, kind in evs
               if kind == "copy" and "DtoH" in name) / 1e9


def to_host_bytes(recs):
    got = [r["attrs"]["bytes"] for r in recs
           if r["name"].endswith(".to_host") and "bytes" in r["attrs"]]
    return sum(got) if got else None


def summary(recs):
    """{name: {"count", "host_ms", "device_ms", counts summed}}"""
    out = {}
    for r in recs:
        s = out.setdefault(r["name"], {"count": 0, "host_ms": 0.0,
                                       "device_ms": 0.0})
        s["count"] += 1
        s["host_ms"] += (r["end_ns"] - r["start_ns"]) / 1e6
        s["device_ms"] += r["device_ms"] or 0.0
        for k, v in r["attrs"].items():
            if isinstance(v, (int, float)):
                s[k] = s.get(k, 0) + v
    return out


def main(argv=None):
    import run as bench

    seen = {}
    read_metric = bench.read_metric

    def read(name, view):
        seen["view"] = view
        return read_metric(name, view)
    bench.read_metric = read
    args = list(sys.argv[1:] if argv is None else argv)
    bench.main(args + ["--trace", "1"])
    recs = records()
    view = seen.get("view")
    idle = idle_by_span(view, recs) if view is not None else None
    print(json.dumps({
        "spans": summary(recs),
        "idle_s_by_innermost_span": None if idle is None else {
            str(k): v / 1e9 for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])}}), flush=True)


if __name__ == "__main__":
    main()
