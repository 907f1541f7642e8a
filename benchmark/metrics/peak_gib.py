"""torch.cuda.max_memory_allocated() from set-up to the close of the
window, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
