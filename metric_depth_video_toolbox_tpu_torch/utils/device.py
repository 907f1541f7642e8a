"""Device selection for the port's entry points.

The counterpart of the JAX package's ``utils/platform.py``: the same
``MDVT_PLATFORM`` switch, but no silent fallback. A caller that asks for
CUDA (explicitly, or by default) on a machine without it gets an error.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None):
    """-> ``torch.device``.

    ``device`` None means ``MDVT_PLATFORM`` (``cpu`` selects the CPU),
    else CUDA. Raises ``RuntimeError`` when CUDA is asked for and absent.
    """
    if device is None:
        device = "cpu" if os.environ.get("MDVT_PLATFORM") == "cpu" else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' or set MDVT_PLATFORM=cpu to run on the CPU")
    return device
