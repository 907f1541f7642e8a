"""JSON sidecar files (the part of ``io/sidecar.py`` the depth and stereo
stages use), in the JAX package's formats byte for byte:
``*_xfovs.json`` per-frame horizontal FOV in degrees,
``*_transformations.json`` per-frame 4x4 camera-to-world matrices."""

from __future__ import annotations

import json
import os

import numpy as np


def _save(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _load(path):
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_xfovs(path):
    """-> (T,) float32 horizontal FOVs in degrees."""
    return np.asarray(_load(path), dtype=np.float32)


def save_xfovs(path, xfovs):
    _save(path, [float(x) for x in np.asarray(xfovs).reshape(-1)])


def save_transformations(path, transforms):
    _save(path, [np.asarray(t).tolist() for t in transforms])


def load_transformations(path):
    """-> (T, 4, 4) float32 camera-to-world matrices."""
    return np.asarray(_load(path), dtype=np.float32)
