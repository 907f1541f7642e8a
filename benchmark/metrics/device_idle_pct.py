"""The share of the traced window with no kernel, copy or set on the
card: the union of their intervals on the profiler's timeline, not a
sum."""


def read(run):
    if run.timeline is None or run.timeline.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.timeline.busy_s() / run.timeline.window_s)
