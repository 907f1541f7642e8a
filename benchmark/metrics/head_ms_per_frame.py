"""The DPT heads (DA3's camera solve included): the device milliseconds
of the program's ``depth.head`` spans (CUDA events), the metric anchor's
left out, over the window's source frames."""

import progtrace


def read(run):
    return progtrace.per_frame(run, progtrace.device_ms(
        progtrace.records(), "depth.head", outside="depth.anchor"))
