"""Scale/shift alignment and rigid/similarity alignment (PyTorch port of
the part of ``ops/solvers.py`` that the VDA and DA3 engines use)."""

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


def least_squares_scale(reference, prediction, weights=None):
    """argmin_s sum w (s * prediction - reference)^2 = <w r p> / <w p p>;
    1 when the denominator vanishes. The inter-window depth-scale stitch
    of windowed video depth. Returns a 0-dim float32 tensor."""
    r = reference.to(torch.float32)
    p = prediction.to(torch.float32)
    w = torch.ones_like(p) if weights is None else weights.to(torch.float32)
    denom = torch.sum(w * p * p)
    one = torch.ones_like(denom)
    return torch.where(denom == 0, one, torch.sum(w * r * p)
                       / torch.where(denom == 0, one, denom))


def _centered(s, t, weights, zero_centroid=False):
    """-> (weights, their sum, both centroids, both centered point sets)"""
    w = (torch.ones(s.shape[:-1], dtype=torch.float32, device=s.device)
         if weights is None else weights.to(torch.float32))
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    if zero_centroid:
        cs = ct = torch.zeros(s.shape[:-2] + (3,), dtype=torch.float32,
                              device=s.device)
    else:
        cs = torch.sum(w[..., None] * s, dim=-2) / wsum
        ct = torch.sum(w[..., None] * t, dim=-2) / wsum
    return w, wsum, cs, ct, s - cs[..., None, :], t - ct[..., None, :]


def _proper(det):
    """diag(1, 1, det): flips the last singular vector of a reflection."""
    return torch.cat([torch.ones(det.shape + (2,), dtype=torch.float32,
                                 device=det.device), det[..., None]], dim=-1)


def rigid_transform(source_points, target_points, weights=None,
                    zero_centroid=False):
    """Weighted Kabsch/Procrustes: the (..., 4, 4) rigid transform mapping
    source (..., N, 3) onto target in the least-squares sense;
    ``zero_centroid=True`` solves for the rotation about the origin only.
    The rotation V diag(1, 1, det) U^T does not depend on the signs the
    SVD gives its singular vectors."""
    s = source_points.to(torch.float32)
    t = target_points.to(torch.float32)
    w, _, cs, ct, sc, tc = _centered(s, t, weights, zero_centroid)
    h = torch.einsum("...ni,...nj->...ij", w[..., None] * sc, tc)
    u, _, vt = torch.linalg.svd(h)
    det = torch.linalg.det(torch.einsum("...ji,...kj->...ik", vt, u))
    rot = torch.einsum("...ji,...j,...kj->...ik", vt, _proper(det), u)
    m = torch.zeros(s.shape[:-2] + (4, 4), dtype=torch.float32,
                    device=s.device)
    m[..., :3, :3] = rot
    m[..., :3, 3] = ct - torch.einsum("...ij,...j->...i", rot, cs)
    m[..., 3, 3] = 1.0
    return m


def umeyama_sim3(source_points, target_points, weights=None):
    """Weighted Umeyama similarity (scale, rot (..., 3, 3), trans (..., 3))
    with target ~ scale * rot @ source + trans: stitches camera
    trajectories across overlapping windows."""
    s = source_points.to(torch.float32)
    t = target_points.to(torch.float32)
    w, wsum, cs, ct, sc, tc = _centered(s, t, weights)
    var_s = torch.sum(w[..., None] * sc * sc, dim=(-2, -1)) / wsum[..., 0]
    cov = torch.einsum("...ni,...nj->...ij", w[..., None] * tc, sc) \
        / wsum[..., None]
    u, d, vt = torch.linalg.svd(cov)
    flip = _proper(torch.linalg.det(u @ vt))
    rot = torch.einsum("...ij,...j,...jk->...ik", u, flip, vt)
    scale = torch.sum(d * flip, dim=-1) / torch.clamp(var_s, min=1e-12)
    trans = ct - scale[..., None] * torch.einsum("...ij,...j->...i", rot, cs)
    return scale, rot, trans


def median(x):
    """The median of all of ``x``, the mean of the two middle values for an
    even count (``jnp.median`` / ``np.median``, not ``torch.median``, which
    returns the lower one): their sum times 0.5, as ``jnp.median`` rounds.
    A 0-dim tensor."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def median_ratio_scale(reference, prediction, weights=None, eps=1e-9):
    """The robust per-frame rescale ``median(reference / prediction)``; with
    ``weights``, the weighted median: the sorted ratios' first whose
    cumulative weight reaches half the total (``searchsorted``, left).
    A 0-dim tensor."""
    ratio = reference / torch.clamp(prediction, min=eps)
    if weights is None:
        return median(ratio)
    r = ratio.reshape(-1)
    rs, order = torch.sort(r, stable=True)
    cdf = torch.cumsum(weights.reshape(-1)[order].to(r.dtype), 0)
    idx = torch.searchsorted(cdf, (cdf[-1] / 2.0).reshape(1))
    return rs[torch.clamp(idx, 0, r.numel() - 1)][0]
