"""The whole step's share of the card's bf16 peak: the configuration's
published algorithm's operations on the window's frames, counted from
shapes (counts/flops.py), over the window's seconds (host clock)."""


def read(run):
    if run.peaks is None or not run.flops:
        return None
    return 100.0 * run.flops / run.window_s / run.peaks["bf16_flops_per_s"]
