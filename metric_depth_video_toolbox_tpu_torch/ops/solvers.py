"""Alignment, pose and triangulation solvers (PyTorch port of
``ops/solvers.py``): scale/shift and rigid/similarity alignment, the
multi-ray intersection, and PnP as fixed-iteration Gauss-Newton with a
fixed fan-out of RANSAC hypotheses.

Every solver takes weights instead of boolean masks, so its shapes do not
depend on the data. Random minimal sets are drawn with an explicit
``torch.Generator``; each drawing function also takes the draws
themselves (``samples``), so that a caller can repeat another generator's
draws.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap


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


def apply_sim3_to_poses(c2w, scale, rot, trans):
    """A similarity (scale, rot (..., 3, 3), trans (..., 3)) applied to
    camera-to-world poses (..., N, 4, 4): R' = R_s R, t' = s R_s t + t_s."""
    r = torch.einsum("...ij,...njk->...nik", rot, c2w[..., :3, :3])
    t = (scale[..., None, None]
         * torch.einsum("...ij,...nj->...ni", rot, c2w[..., :3, 3])
         + trans[..., None, :])
    out = c2w.clone()
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    return out


def _unit(directions):
    return directions / (torch.linalg.norm(directions, dim=-1, keepdim=True)
                         + 1e-12)


def ray_diversity_weights(directions, valid=None):
    """Angle-diversity weights of (..., N, 3) rays: w_i = the mean over the
    other valid rays j of (1 - |d_i . d_j|) (the self term is 0 since
    |d_i . d_i| = 1), zero for invalid rays."""
    d = _unit(directions)
    v = (torch.ones(d.shape[:-1], dtype=torch.float32, device=d.device)
         if valid is None else valid.to(torch.float32))
    dots = torch.abs(torch.einsum("...ni,...mi->...nm", d, d))
    contrib = torch.einsum("...nm,...m->...n", 1.0 - dots, v)
    n_eff = torch.clamp(torch.sum(v, dim=-1, keepdim=True) - 1.0, min=1.0)
    return contrib * v / n_eff


def intersect_rays(points, directions, weights=None, valid=None):
    """Weighted least-squares intersection of (..., N) rays with origins
    ``points`` (..., N, 3): the x minimizing sum_i w_i ||(I - d d^T)(x -
    p_i)||^2, in closed form (3x3 normal equations, regularized by 1e-9 I
    for near-parallel bundles). ``weights`` default to the rays'
    diversity weights; ``valid`` masks padded rays. -> (..., 3)"""
    d = _unit(directions)
    p = points.to(torch.float32)
    if weights is None:
        weights = ray_diversity_weights(d, valid=valid)
    w = weights.to(torch.float32)
    if valid is not None:
        w = w * valid.to(torch.float32)
    eye = torch.eye(3, dtype=torch.float32, device=d.device)
    outer = torch.einsum("...n,...ni,...nj->...ij", w, d, d)
    a = torch.sum(w, dim=-1)[..., None, None] * eye - outer
    dp = torch.sum(d * p, dim=-1, keepdim=True)
    b = torch.sum(w[..., None] * (p - d * dp), dim=-2)
    a = a + 1e-9 * eye
    return torch.linalg.solve(a, b[..., None])[..., 0]


def _so3_exp(w):
    """Rodrigues: axis-angle (..., 3) -> rotation matrices (..., 3, 3).

    Both branches of each ``where`` stay finite at theta = 0 (the
    ``+ 1e-16`` under the root and the floor of theta^2), so a forward-mode
    derivative at the zero increment is finite: the Taylor branch is the
    one taken there, and the other's derivative is not NaN. theta^2 keeps
    a trailing axis of 1: under ``torch.func.jacfwd`` a 0-dim tensor
    combined with a Python float gets a float64 tangent."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-16)
    small = theta < 1e-4
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.clamp(theta2, min=1e-16))
    zero = torch.zeros_like(w[..., 0])
    wx = torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zero, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zero], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None] * wx + b[..., None] * (wx @ wx)


def _pnp_residuals(rvec, tvec, pts3d, pts2d, k):
    r = _so3_exp(rvec)
    pc = pts3d @ r.T + tvec
    z = torch.clamp(pc[:, 2], min=1e-6)
    u = pc[:, 0] / z * k[0, 0] + k[0, 2]
    v = pc[:, 1] / z * k[1, 1] + k[1, 2]
    return torch.stack([u, v], dim=-1) - pts2d


def pnp_gauss_newton(pts3d, pts2d, K, weights=None, iters=10,
                     rvec0=None, tvec0=None):
    """Weighted Gauss-Newton PnP refinement over ``iters`` fixed steps
    (the Jacobian by forward-mode differentiation, the 6x6 normal
    equations damped by 1e-6 I). pts3d (N, 3) world points, pts2d (N, 2)
    pixels, K (3, 3). -> (rvec, tvec, mean squared residual)"""
    n = pts3d.shape[0]
    dev = pts3d.device
    w = (torch.ones((n,), dtype=torch.float32, device=dev)
         if weights is None else weights)
    rvec = (torch.zeros(3, dtype=torch.float32, device=dev)
            if rvec0 is None else rvec0)
    tvec = (torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)
            if tvec0 is None else tvec0)
    sw = torch.sqrt(w)[:, None]

    def flat_res(x):
        return (_pnp_residuals(x[:3], x[3:], pts3d, pts2d, K)
                * sw).reshape(-1)

    eye = 1e-6 * torch.eye(6, dtype=torch.float32, device=dev)
    x = torch.cat([rvec, tvec])
    for _ in range(iters):
        j = jacfwd(flat_res)(x)
        r = flat_res(x)
        dx = torch.linalg.solve(j.T @ j + eye, -(j.T @ r))
        x = x + dx
    rvec, tvec = x[:3], x[3:]
    res = _pnp_residuals(rvec, tvec, pts3d, pts2d, K)
    msr = torch.sum(w * torch.sum(res ** 2, -1)) / torch.clamp(
        torch.sum(w), min=1e-12)
    return rvec, tvec, msr


def draw_minimal_sets(generator, weights, count, size, replace):
    """``count`` index sets of ``size`` drawn in proportion to
    ``weights`` (N,) with ``generator`` (with or without replacement
    inside a set). -> (count, size) int64 on weights' device"""
    p = (weights / torch.sum(weights)).to(torch.float32)
    if generator is not None and generator.device != p.device:
        p = p.to(generator.device)
    idx = torch.multinomial(p.expand(count, -1).contiguous(), size,
                            replacement=replace, generator=generator)
    return idx.to(weights.device)


def ransac_pnp(generator, pts3d, pts2d, K, weights=None, num_hypotheses=256,
               sample_size=6, reproj_threshold=6.0, iters=8, samples=None):
    """RANSAC PnP as a fixed fan-out: ``num_hypotheses`` minimal sets of
    ``sample_size`` distinct points drawn with ``generator`` in proportion
    to the weights (or given as ``samples``, (num_hypotheses,
    sample_size) indices), each refined by Gauss-Newton, scored by its
    inliers (reprojection error under ``reproj_threshold`` px, weight >
    0), the best refined again on its inliers.

    -> (rvec, tvec, inlier mask (N,) bool)"""
    n = pts3d.shape[0]
    w_all = (torch.ones((n,), dtype=torch.float32, device=pts3d.device)
             if weights is None else weights)
    if samples is None:
        samples = draw_minimal_sets(generator, w_all, num_hypotheses,
                                    sample_size, replace=False)

    def one(idx):
        rv, tv, _ = pnp_gauss_newton(pts3d[idx], pts2d[idx], K,
                                     iters=iters)
        err = torch.linalg.norm(
            _pnp_residuals(rv, tv, pts3d, pts2d, K), dim=-1)
        return rv, tv, torch.sum((err < reproj_threshold) & (w_all > 0))

    rvs, tvs, scores = vmap(one)(samples.to(pts3d.device))
    best = torch.argmax(scores)
    rv, tv = rvs[best], tvs[best]
    res = _pnp_residuals(rv, tv, pts3d, pts2d, K)
    inliers = (torch.linalg.norm(res, dim=-1) < reproj_threshold) \
        & (w_all > 0)
    rv, tv, _ = pnp_gauss_newton(pts3d, pts2d, K,
                                 weights=inliers.to(torch.float32),
                                 iters=iters, rvec0=rv, tvec0=tv)
    return rv, tv, inliers


def pose_matrix_from_rvec_tvec(rvec, tvec):
    """A world-to-camera (rvec, tvec) -> its 4x4 matrix."""
    m = torch.eye(4, dtype=torch.float32, device=rvec.device)
    m[:3, :3] = _so3_exp(rvec)
    m[:3, 3] = tvec
    return m
