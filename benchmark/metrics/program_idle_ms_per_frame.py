"""The program's host work: the time in the traced window with nothing on
the card while one of the program's spans is open on the host (the
profiler's clock), over the window's source frames."""

import progtrace


def read(run):
    idle = progtrace.idle_by_span(run)
    if idle is None:
        return None
    inside = sum(ns for name, ns in idle.items() if name is not None)
    return progtrace.per_frame(run, inside / 1e6)
