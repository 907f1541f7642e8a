"""JSON sidecar files (the part of ``io/sidecar.py`` the stereo stage
reads): per-frame horizontal FOVs."""

from __future__ import annotations

import json
import os

import numpy as np


def _load(path):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_xfovs(path):
    """-> (T,) float32 horizontal FOVs in degrees."""
    return np.asarray(_load(path), dtype=np.float32)

