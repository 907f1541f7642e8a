"""Host-to-device and device-to-host copy time on the card (device
trace), over the window's source frames."""


def read(run):
    if run.timeline is None or not run.frames:
        return None
    return 1e3 * run.timeline.total_s(("copy",)) / run.frames
