"""Process start to the first hand-off: imports, weights, the build of
the kernels, the models, the shots and the warm-up (host clock)."""


def read(run):
    return run.setup_s
