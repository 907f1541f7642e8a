"""Stereo re-rendering by disparity sweep (PyTorch port of the sweep path
of ``ops/rasterize.py``).

The source depth is rotation-neutralized (one bilinear resample, exact
for a rotation about the camera center), after which the eye transform
is a pure x-translation: each depth plane shifts a row by a constant
disparity, which is what the sweep kernel in :mod:`.warp_sweep` runs.
Everything carries a leading batch axis (frames x eyes).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep

INF_DEPTH = 3.0e38


class WarpResult(NamedTuple):
    """color (B, H, W, C) payload; depth (B, H, W), INF where nothing
    landed; mask (B, H, W) bool, True where a sample landed; edge_mask
    (B, H, W) bool, the source pixels whose cell was edge-culled."""
    color: torch.Tensor
    depth: torch.Tensor
    mask: torch.Tensor
    edge_mask: torch.Tensor


def _cell_corners(a):
    """(..., H, W, C) -> the 4 corner views (i,j), (i,j+1), (i+1,j),
    (i+1,j+1) of each grid cell, edge-clamped."""
    a01 = torch.cat([a[..., :, 1:, :], a[..., :, -1:, :]], dim=-2)
    a10 = torch.cat([a[..., 1:, :, :], a[..., -1:, :, :]], dim=-3)
    a11 = torch.cat([a01[..., 1:, :, :], a01[..., -1:, :, :]], dim=-3)
    return a, a01, a10, a11


def cell_edge_mask(points_cam, angle_threshold_deg=89.0):
    """True for grid cells whose surface is nearly parallel to the view ray
    (either triangle's normal more than the threshold off the ray).

    points_cam: (..., H, W, 3) camera-space points."""
    p00, p01, p10, p11 = _cell_corners(points_cam)
    n1 = torch.linalg.cross(p10 - p00, p01 - p00, dim=-1)
    n2 = torch.linalg.cross(p01 - p11, p10 - p11, dim=-1)
    view = -((p00 + p01 + p10 + p11) * 0.25)
    cos_t = math.cos(math.radians(angle_threshold_deg))
    view_norm = torch.linalg.vector_norm(view, dim=-1)

    def bad(n):
        nn_ = torch.linalg.vector_norm(n, dim=-1)
        cosang = torch.abs(torch.sum(n * view, dim=-1)) / (
            nn_ * view_norm + 1e-12)
        return (cosang < cos_t) & (nn_ > 1e-12)

    return bad(n1) | bad(n2)


def _bilinear_gather(img, u, v, fill=0.0):
    """Sample img (B, H, W[, C]) at float coords u, v (B, Ho, Wo);
    out-of-bounds taps read ``fill``."""
    b, h, w = img.shape[:3]
    chans = img.shape[3:]
    flat = img.reshape(b, h * w, *chans)
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    fu = u - u0f
    fv = v - v0f
    u0 = u0f.to(torch.int64)
    v0 = v0f.to(torch.int64)

    def tap(vi, ui):
        ok = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        idx = (vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)).reshape(b, -1)
        if chans:
            val = torch.gather(flat, 1, idx[..., None].expand(
                -1, -1, *chans)).reshape(*u.shape, *chans)
            ok = ok[..., None]
        else:
            val = torch.gather(flat, 1, idx).reshape(u.shape)
        return torch.where(ok, val, torch.full_like(val, fill))

    t00 = tap(v0, u0)
    t01 = tap(v0, u0 + 1)
    t10 = tap(v0 + 1, u0)
    t11 = tap(v0 + 1, u0 + 1)
    if chans:
        fu = fu[..., None]
        fv = fv[..., None]
    return ((1 - fv) * ((1 - fu) * t00 + fu * t01)
            + fv * ((1 - fu) * t10 + fu * t11))


def _rotation_taps(r, k, b, h, w, dev):
    """Source coordinates (u, v) and depth divisor of the resample that
    removes rotation r (B, 3, 3) exactly: the source direction of target
    pixel (x, y) is R^T [dx, dy, 1]."""
    fx, fy = k[:, 0, 0], k[:, 1, 1]
    cx, cy = k[:, 0, 2], k[:, 1, 2]

    def col(a):
        return a[:, None, None]
    xs = (torch.arange(w, dtype=torch.float32, device=dev)[None]
          - cx[:, None]) / fx[:, None]
    ys = (torch.arange(h, dtype=torch.float32, device=dev)[None]
          - cy[:, None]) / fy[:, None]
    dx = xs[:, None, :].expand(b, h, w)
    dy = ys[:, :, None].expand(b, h, w)
    sx_d = col(r[:, 0, 0]) * dx + col(r[:, 1, 0]) * dy + col(r[:, 2, 0])
    sy_d = col(r[:, 0, 1]) * dx + col(r[:, 1, 1]) * dy + col(r[:, 2, 1])
    sz_d = col(r[:, 0, 2]) * dx + col(r[:, 1, 2]) * dy + col(r[:, 2, 2])
    return (sx_d / sz_d * col(fx) + col(cx), sy_d / sz_d * col(fy) + col(cy),
            sz_d)


def _plane_set(depth_rot, fx, tx, num_planes, max_disparity, conv_inv_z,
               min_depth, tol_scale):
    """Uniform inverse-depth planes across the rot-frame depth range of
    depth_rot (B, H, W), and each plane's disparity for the x-translation
    tx (B,), with the convergence plane (inverse depth conv_inv_z) landing
    at zero disparity. -> (inv_near, d_inv (B,); plane_z, plane_tol,
    disp_int, disp_frac (B, P))."""
    dev = depth_rot.device
    inside = depth_rot > min_depth
    inf = torch.full_like(depth_rot, math.inf)
    z_near = torch.clamp(torch.where(inside, depth_rot, inf).amin((1, 2)),
                         min=min_depth)
    z_far = torch.maximum(torch.where(inside, depth_rot, -inf).amax((1, 2)),
                          z_near * 1.001)
    inv_near = 1.0 / z_near
    inv_far = 1.0 / z_far
    d_inv = (inv_near - inv_far) / (num_planes - 1)
    ids = torch.arange(num_planes, dtype=torch.float32, device=dev)
    plane_z = 1.0 / (inv_near[:, None] - d_inv[:, None] * ids[None])
    plane_tol = tol_scale * plane_z * plane_z * d_inv[:, None] + 1e-4

    conv = torch.as_tensor(conv_inv_z, dtype=torch.float32, device=dev)
    conv = conv.reshape(-1, 1) if conv.ndim else conv
    disp = -fx[:, None] * tx[:, None] * (1.0 / plane_z - conv)
    disp = torch.clamp(disp, -(max_disparity - 2.0), max_disparity - 2.0)
    disp_floor = torch.floor(disp)
    return (inv_near, d_inv, plane_z.contiguous(), plane_tol.contiguous(),
            disp_floor.to(torch.int32), (disp - disp_floor).contiguous())


def _planar_pad(img, pads):
    """(B, H, W, C) -> channel-planar (B, C, H, W + pads), zero-padded."""
    return torch.nn.functional.pad(img.permute(0, 3, 1, 2), pads).contiguous()


def stereo_sweep_warp(depth, color, k, transform, num_planes=128,
                      remove_edges=True, edge_angle_deg=89.0,
                      max_disparity=256, neutralize_rotation=True,
                      conv_inv_z=0.0, min_depth=1e-2, tol_scale=1.6,
                      edge=None):
    """Stereo re-render of a batch through the disparity sweep.

    depth (B, H, W); color (B, H, W, C); k (B, 3, 3); transform (B, 4, 4)
    decomposing as a rotation R and a translation whose y and z vanish
    after rotation-neutralization (the stereo eye case); conv_inv_z
    (B,) or a float, the inverse depth of the zero-disparity plane;
    edge: optional precomputed (B, H, W) edge mask.
    Returns a :class:`WarpResult`.
    """
    b, h, w = depth.shape
    dev = depth.device
    depth = depth.to(torch.float32)

    if edge is None:
        if remove_edges:
            edge = cell_edge_mask(geo.unproject_depth(depth, k),
                                  edge_angle_deg)
        else:
            edge = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    valid_src = depth > min_depth
    depth_rot = torch.where(edge | ~valid_src, torch.zeros_like(depth), depth)
    color_rot = color.to(torch.float32)
    if neutralize_rotation:
        u_s, v_s, sz_d = _rotation_taps(transform[:, :3, :3], k, b, h, w, dev)
        depth_rot = _bilinear_gather(depth_rot, u_s, v_s, fill=0.0) / sz_d
        color_rot = _bilinear_gather(color_rot, u_s, v_s, fill=0.0)

    inv_near, d_inv, plane_z, plane_tol, disp_int, disp_frac = _plane_set(
        depth_rot, k[:, 0, 0], transform[:, 0, 3], num_planes, max_disparity,
        conv_inv_z, min_depth, tol_scale)
    pad_left, pad_right = warp_sweep.pad_widths(w, max_disparity)
    pads = (pad_left, pad_right)
    active = warp_sweep.plane_activity(depth_rot, inv_near, d_inv,
                                       num_planes)

    best_z, out_color, found = warp_sweep.disparity_sweep(
        torch.nn.functional.pad(depth_rot, pads), _planar_pad(color_rot, pads),
        disp_int, disp_frac, plane_z, plane_tol, num_planes, pad_left,
        active)
    return WarpResult(color=out_color,
                      depth=torch.where(found, best_z,
                                        torch.full_like(best_z, INF_DEPTH)),
                      mask=found, edge_mask=edge & valid_src)


def stereo_sweep_warp_dual(depth, color, extra, k, transform,
                           num_planes=128, edge_angle_deg=89.0,
                           max_disparity=256, neutralize_rotation=True,
                           conv_inv_z=0.0, min_depth=1e-2, tol_scale=1.6,
                           edge=None):
    """The stereo sweep and the edge-anchor sweep in one kernel pass.

    The movie-configuration stereo path renders two surfaces per eye: the
    main (edge-culled) surface, and an anchor layer of the culled
    silhouette pixels that seeds the infill with color and normals. Both
    share the projection, so the edge-only depth rides as a second depth
    stream of :func:`warp_sweep.disparity_sweep_dual`: ``color`` goes to
    whichever surface hit and ``extra`` (B, H, W, E; e.g. encoded normals)
    to the anchor surface only. The plane set comes from the main depth
    alone, exactly as in :func:`stereo_sweep_warp`, so the main surface is
    bit-equal to the single sweep's; the anchors are swept over the full
    plane set.

    Returns (WarpResult main, anchor_color (B, H, W, C), anchor_extra
    (B, H, W, E), anchor_mask (B, H, W) bool).
    """
    b, h, w = depth.shape
    dev = depth.device
    depth = depth.to(torch.float32)

    if edge is None:
        edge = cell_edge_mask(geo.unproject_depth(depth, k), edge_angle_deg)
    valid_src = depth > min_depth
    zero = torch.zeros_like(depth)
    main_depth = torch.where(edge | ~valid_src, zero, depth)
    edge_depth = torch.where(edge & valid_src, depth, zero)
    color_f = color.to(torch.float32)
    extra_f = extra.to(torch.float32)
    if neutralize_rotation:
        u_s, v_s, sz_d = _rotation_taps(transform[:, :3, :3], k, b, h, w, dev)
        main_depth = _bilinear_gather(main_depth, u_s, v_s, fill=0.0) / sz_d
        edge_depth = _bilinear_gather(edge_depth, u_s, v_s, fill=0.0) / sz_d
        color_f = _bilinear_gather(color_f, u_s, v_s, fill=0.0)
        extra_f = _bilinear_gather(extra_f, u_s, v_s, fill=0.0)

    inv_near, d_inv, plane_z, plane_tol, disp_int, disp_frac = _plane_set(
        main_depth, k[:, 0, 0], transform[:, 0, 3], num_planes,
        max_disparity, conv_inv_z, min_depth, tol_scale)
    pad_left, pad_right = warp_sweep.pad_widths(w, max_disparity)
    pads = (pad_left, pad_right)
    act_m, act_e = (warp_sweep.plane_activity(
        d, inv_near, d_inv, num_planes,
        block_rows=warp_sweep.DUAL_BLOCK_ROWS)
        for d in (main_depth, edge_depth))

    best_z, out_color, found, a_color, a_extra, a_found = \
        warp_sweep.disparity_sweep_dual(
            torch.nn.functional.pad(main_depth, pads),
            torch.nn.functional.pad(edge_depth, pads),
            _planar_pad(color_f, pads), _planar_pad(extra_f, pads),
            disp_int, disp_frac, plane_z, plane_tol, act_m, act_e,
            num_planes, pad_left)
    main = WarpResult(color=out_color,
                      depth=torch.where(found, best_z,
                                        torch.full_like(best_z, INF_DEPTH)),
                      mask=found, edge_mask=edge & valid_src)
    return main, a_color, a_extra, a_found
