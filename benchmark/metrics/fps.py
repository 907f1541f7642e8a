"""Source frames whose side-by-side image and infill mask are on the
host, over the whole window (host clock), a stall included."""


def read(run):
    if not run.frames:
        return None
    return run.frames / run.window_s
