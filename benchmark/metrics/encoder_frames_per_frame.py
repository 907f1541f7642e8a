"""The depth model's work: the frames of the program's ``depth.encoder``
spans (each window's views, padding included, and the metric anchor's
frames), over the window's source frames."""

import progtrace


def read(run):
    return progtrace.per_frame(run, progtrace.attr_sum(
        progtrace.records(), "depth.encoder", "frames"))
