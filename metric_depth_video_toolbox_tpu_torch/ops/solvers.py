"""Scale/shift alignment (PyTorch port of the part of ``ops/solvers.py``
that the VDA engine uses)."""

from __future__ import annotations

import numpy as np
import torch


def scale_and_shift(prediction, target, weights=None):
    """Closed-form weighted least squares (s, t) minimizing
    ``sum w (s * prediction + t - target)^2`` through the 2x2 normal
    equations; (1, 0) when the system is singular. Float32 inputs, as in
    the JAX package; returns 0-dim float32 tensors."""
    p = prediction.to(torch.float32)
    t = target.to(torch.float32)
    w = torch.ones_like(t) if weights is None else weights.to(torch.float32)
    a00 = torch.sum(w * p * p)
    a01 = torch.sum(w * p)
    a11 = torch.sum(w)
    b0 = torch.sum(w * p * t)
    b1 = torch.sum(w * t)
    det = a00 * a11 - a01 * a01
    one = torch.ones_like(det)
    safe = torch.where(det == 0, one, det)
    s = torch.where(det == 0, one, (a11 * b0 - a01 * b1) / safe)
    o = torch.where(det == 0, torch.zeros_like(det),
                    (-a01 * b0 + a00 * b1) / safe)
    return s, o


def rolling_scale_shift(disp_anchor, inv_anchor, anchor_idx, n_frames,
                        window=60):
    """Per-frame (s, t) from per-anchor fits, linearly interpolated to
    every frame and box-smoothed over ``window`` frames.

    disp_anchor, inv_anchor: (A, H, W) tensors; anchor_idx: (A,)
    ascending frame indices. Returns float32 numpy (s, t) of shape
    (n_frames,)."""
    fits = [scale_and_shift(d, i) for d, i in zip(disp_anchor, inv_anchor)]
    s_a = np.asarray([float(s) for s, _ in fits], np.float64)
    t_a = np.asarray([float(t) for _, t in fits], np.float64)
    frames = np.arange(n_frames)
    s = np.interp(frames, np.asarray(anchor_idx), s_a)
    t = np.interp(frames, np.asarray(anchor_idx), t_a)
    k = max(1, int(window))
    if k > 1:
        kern = np.ones(k) / k
        pad = k // 2
        s = np.convolve(np.pad(s, pad, mode="edge"), kern, "same")[
            pad:pad + n_frames]
        t = np.convolve(np.pad(t, pad, mode="edge"), kern, "same")[
            pad:pad + n_frames]
    return s.astype(np.float32), t.astype(np.float32)
