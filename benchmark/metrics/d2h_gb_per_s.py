"""Device-to-host copies: the bytes of the program's ``*.to_host`` spans
(counted where it copies), over the device-to-host copy time on the card
(device trace), in GB/s."""

import progtrace


def read(run):
    if run.timeline is None:
        return None
    moved = progtrace.to_host_bytes(progtrace.records())
    seconds = progtrace.d2h_seconds(run.timeline)
    if not moved or seconds <= 0:
        return None
    return moved / 1e9 / seconds
