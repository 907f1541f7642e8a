"""The stereo stage's least bytes (the coded depth and the colour read
once, the side-by-side image and infill mask written once) over the card's
memory rate, as a share of the kernel time inside the stereo stage's
spans (device trace)."""


def read(run):
    if run.timeline is None or run.peaks is None or not run.stereo_bytes:
        return None
    busy = run.timeline.busy_s("stereo", kinds=("kernel",))
    if busy <= 0:
        return None
    return 100.0 * run.stereo_bytes / run.peaks["hbm_bytes_per_s"] / busy
