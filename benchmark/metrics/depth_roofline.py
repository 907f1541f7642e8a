"""The depth model's operations, counted from shapes
(counts/flops.py), over the card's bf16 peak, as a share of the kernel time
inside the depth stage's spans (device trace)."""


def read(run):
    if run.timeline is None or run.peaks is None or not run.flops:
        return None
    busy = run.timeline.busy_s("depth", kinds=("kernel",))
    if busy <= 0:
        return None
    return 100.0 * run.flops / run.peaks["bf16_flops_per_s"] / busy
