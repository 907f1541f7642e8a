"""The ViT encoder: the device milliseconds of the program's
``depth.encoder`` spans (CUDA events), the metric anchor's left out, over
the window's source frames."""

import progtrace


def read(run):
    return progtrace.per_frame(run, progtrace.device_ms(
        progtrace.records(), "depth.encoder", outside="depth.anchor"))
