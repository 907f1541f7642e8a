"""VDA's metric anchor: the device milliseconds of the program's
``depth.anchor`` spans (CUDA events; its copies, encoder and head), over
the window's source frames."""

import progtrace


def read(run):
    return progtrace.per_frame(run, progtrace.device_ms(
        progtrace.records(), "depth.anchor"))
