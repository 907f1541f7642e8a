"""Voxel downsampling of point clouds, plain and perspective-aware
(numpy; the background accumulator's cloud lives on the host between
frames). The port's own copy of the JAX package's ``ops/voxel.py``."""

from __future__ import annotations

import numpy as np


def voxel_downsample(points, colors=None, voxel_size=0.01):
    """Average the points (and colors) within each voxel of an axis-aligned
    grid of ``voxel_size``; voxels in lexicographic order of their
    integer coordinates, each sum accumulated in point order."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    keys = np.floor(pts / voxel_size).astype(np.int64)
    if not len(keys):
        return pts, colors
    lo = keys.min(axis=0)
    span = [int(s) for s in keys.max(axis=0) - lo + 1]
    if span[0] * span[1] * span[2] < 2 ** 62:
        # one int64 per voxel in the rows' lexicographic order: a 1-D sort
        # gives the same voxels and order as sorting the rows
        k = keys - lo
        _, inverse = np.unique((k[:, 0] * span[1] + k[:, 1]) * span[2]
                               + k[:, 2], return_inverse=True)
    else:
        _, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    n = int(inverse.max()) + 1
    counts = np.bincount(inverse, minlength=n)

    def mean(vals):
        vals = np.asarray(vals, np.float64)
        return (np.stack([np.bincount(inverse, vals[:, c], minlength=n)
                          for c in range(vals.shape[1])], axis=-1)
                / counts[:, None]).astype(np.float32)
    out_colors = None
    if colors is not None:
        out_colors = mean(np.asarray(colors).reshape(-1, colors.shape[-1]))
    return mean(pts), out_colors


def perspective_aware_downsample(points, colors=None, voxel_size=0.003,
                                 eps=1e-6):
    """Downsample with voxels that grow with distance: warp the points to
    (x/z, y/z, log z), voxel there, warp back, so distant points merge
    more than near ones (the background accumulator runs it every 10th
    frame)."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    z = np.maximum(pts[:, 2], eps)
    warped = np.stack([pts[:, 0] / z, pts[:, 1] / z, np.log(z)], axis=-1)
    down, cols = voxel_downsample(warped, colors, voxel_size)
    zz = np.exp(down[:, 2])
    un = np.stack([down[:, 0] * zz, down[:, 1] * zz, zz], axis=-1)
    return un.astype(np.float32), cols
