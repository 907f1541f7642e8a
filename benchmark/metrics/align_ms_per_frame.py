"""Alignment and stitching: the host milliseconds of the program's
``depth.align`` spans (VDA's window stitch and metric fit, DA3's scale and
pose stitch), over the window's source frames."""

import progtrace


def read(run):
    return progtrace.per_frame(run, progtrace.host_ms(
        progtrace.records(), "depth.align"))
