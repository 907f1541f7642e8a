"""The stereo warps: the device milliseconds of the program's
``stereo.sweep`` spans (CUDA events; the main and the anchor pass), over
the window's source frames."""

import progtrace


def read(run):
    return progtrace.per_frame(run, progtrace.device_ms(
        progtrace.records(), "stereo.sweep"))
