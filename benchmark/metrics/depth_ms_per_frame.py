"""The depth stage: the benchmark's span around the engine's
infer_video (which ends in a synchronising copy to the host), summed over
the window and divided by its source frames (host clock)."""


def read(run):
    if not run.frames:
        return None
    return 1e3 * run.span_s("depth") / run.frames
