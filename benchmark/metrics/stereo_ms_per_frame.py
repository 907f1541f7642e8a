"""The stereo stage: the benchmark's span around the depth's RGB coding
and stereo_step over a shot (each batch ends in a synchronising copy to
the host), summed over the window and divided by its source frames (host
clock)."""


def read(run):
    if not run.frames:
        return None
    return 1e3 * run.span_s("stereo") / run.frames
