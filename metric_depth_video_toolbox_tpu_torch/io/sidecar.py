"""JSON sidecar files, in the JAX package's formats byte for byte:
``*_xfovs.json`` per-frame horizontal FOV in degrees,
``*_transformations.json`` per-frame 4x4 camera-to-world matrices,
``*_convergence_depths.json`` per-frame focus depth,
``*_tracking.json`` per-frame lists of [global_id, x, y]."""

from __future__ import annotations

import json
import os

import numpy as np


class NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.generic):
            return obj.item()
        return super().default(obj)


def _save(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, cls=NumpyEncoder)
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


def save_convergence_depths(path, depths):
    _save(path, [float(x) for x in np.asarray(depths).reshape(-1)])


def load_convergence_depths(path):
    """-> (T,) float32 convergence depths in meters (NaN: no subject)."""
    return np.asarray(_load(path), dtype=np.float32)


def save_tracking(path, frames):
    """frames: list over frames of arrays (N_i, 3) [global_id, x, y]."""
    _save(path, [np.asarray(f).tolist() for f in frames])


def load_tracking(path):
    """-> list over frames of float32 arrays (N_i, 3)."""
    return [np.asarray(f, dtype=np.float32).reshape(-1, 3)
            for f in _load(path)]


def tracking_to_dense(frames, max_tracks=None):
    """Ragged per-frame tracks -> (dense (T, N, 3) [x, y, valid] keyed by
    global id, (N,) int64 ids)."""
    ids = sorted({int(p[0]) for f in frames for p in f})
    if max_tracks is not None:
        ids = ids[:max_tracks]
    id_to_col = {g: i for i, g in enumerate(ids)}
    dense = np.zeros((len(frames), len(ids), 3), np.float32)
    for fi, f in enumerate(frames):
        for gid, x, y in np.asarray(f).reshape(-1, 3):
            col = id_to_col.get(int(gid))
            if col is not None:
                dense[fi, col] = [x, y, 1.0]
    return dense, np.asarray(ids, np.int64)
