"""Re-rendering of depth + color frames into another camera (PyTorch port
of ``ops/rasterize.py``).

Three warps share one output contract, :class:`WarpResult`:

- :func:`stereo_sweep_warp` (and its fused twin): the stereo-eye case.
  The source depth is rotation-neutralized (one bilinear resample, exact
  for a rotation about the camera center), after which the eye transform
  is a pure x-translation: each depth plane shifts a row by a constant
  disparity, which is what the sweep kernel in :mod:`.warp_sweep` runs.
- :func:`forward_warp` and :func:`splat_points`: a scatter z-buffer for
  any rigid transform and render camera. Every source grid cell emits an
  S x S lattice of bilinearly interpolated samples (S = 1: points); one
  ``scatter_reduce`` "amin" over the whole batch keeps the nearest depth
  per target pixel, and among the samples within the tie tolerance of it
  the last in the JAX package's candidate order writes the payload (XLA's
  scatter on the CPU writes in order), resolved by a second "amax"
  scatter over candidate positions, so the card, the CPU and the JAX
  package agree. A batch whose candidates would pass ``ZBUFFER_BYTES``
  runs in passes of whole images (the images are independent: the same
  result bit for bit).
- :func:`plane_sweep_warp`: the gather-only formulation, sweeping depth
  hypotheses front to back per target pixel in chunks of 16 planes, in
  passes of whole images within the same budget.

Everything carries a leading batch axis (frames x eyes).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep

INF_DEPTH = 3.0e38
# the working set of one z-buffer pass (or of one plane-sweep chunk): a
# batch that needs more runs in passes of whole images
ZBUFFER_BYTES = 4 << 30
# bytes a plane-sweep chunk holds per plane and target pixel: the hypothesis
# and its source coordinates, and two bilinear gathers' int64 indices, taps
# and weights
PLANE_SWEEP_BYTES = 160


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


def _project_map(points, k):
    """(B, H, W, 3) camera-space points -> pixel coordinates (B, H, W, 2)
    and depth (B, H, W) through k (B, 3, 3)."""
    z = points[..., 2]
    safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    kk = k[:, None, None]
    u = points[..., 0] / safe * kk[..., 0, 0] + kk[..., 0, 2]
    v = points[..., 1] / safe * kk[..., 1, 1] + kk[..., 1, 2]
    return torch.stack([u, v], dim=-1), z


def _target_slot(su, ok, sz, out_hw, min_depth):
    """Flat target pixel of samples at screen positions su (B, ..., 2)
    with depth sz, or the drop slot H*W where ``ok`` is False, the sample
    falls outside the target, or lies at or behind ``min_depth``."""
    ht, wt = out_hw
    # rounded and clamped to one pixel outside the target before the cast
    # (a float32 -> int cast out of range is undefined on the card)
    ui = torch.round(su[..., 0]).clamp(-1, wt).to(torch.int64)
    vi = torch.round(su[..., 1]).clamp(-1, ht).to(torch.int64)
    inb = (ui >= 0) & (ui < wt) & (vi >= 0) & (vi < ht)
    ok = ok & inb & (sz > min_depth)
    return torch.where(ok, vi * wt + ui, torch.full_like(ui, ht * wt))


def _zbuffer(idx, zc, out_hw, depth_tie_eps):
    """The scatter z-buffer of B images at once.

    idx (B, M) int64: each candidate's target slot, H*W = dropped; zc
    (B, M) its depth. Returns (depth (B, Ht, Wt), INF where nothing
    landed; winner (B, Ht, Wt) int64, the position in 0..M-1 of the
    candidate whose payload the slot takes, -1 where none). Every image
    has its own H*W + 1 slots, the last one its drop slot. Among the
    candidates within ``depth_tie_eps`` of a slot's nearest depth, the
    last one (highest position) wins, as XLA's in-order scatter on the CPU
    does for the JAX package."""
    ht, wt = out_hw
    b, m = idx.shape
    n = ht * wt + 1
    gidx = (idx + torch.arange(b, device=idx.device)[:, None] * n).reshape(-1)
    zflat = torch.full((b * n,), INF_DEPTH, dtype=torch.float32,
                       device=idx.device)
    zflat.scatter_reduce_(0, gidx, zc.reshape(-1), "amin")
    zwin = zflat[gidx].reshape(b, m)
    winner = zc <= zwin * (1.0 + depth_tie_eps) + depth_tie_eps
    pos = torch.arange(m, device=idx.device).expand(b, m)
    wflat = torch.full((b * n,), -1, dtype=torch.int64, device=idx.device)
    wflat.scatter_reduce_(0, gidx, torch.where(winner, pos, -1).reshape(-1),
                          "amax")
    zout = zflat.reshape(b, n)[:, :-1].reshape(b, ht, wt)
    return zout, wflat.reshape(b, n)[:, :-1].reshape(b, ht, wt)


def _images_per_pass(b, per_image):
    """How many of b images, each with a working set of ``per_image``
    bytes, one pass takes: within ``ZBUFFER_BYTES``, and at least one."""
    return max(1, min(b, ZBUFFER_BYTES // per_image))


def _zbuffer_bytes(n_cand, n_slots, c):
    """One image's z-buffer working set with n_cand candidates of c
    payload channels and n_slots target pixels: slot, depth, position and
    payload per candidate; depth and winner per slot."""
    return n_cand * (64 + 8 * c) + n_slots * (16 + 4 * c)


def _in_passes(fn, step, b, *batched):
    """fn over the batch in passes of ``step`` images; its outputs (a
    tuple of tensors with a leading batch axis) concatenated."""
    parts = [fn(*(a[i:i + step] for a in batched)) for i in range(0, b, step)]
    return tuple(torch.cat(f, 0) for f in zip(*parts))


def _take_payload(payload, winner):
    """payload (B, M, C), winner (B, Ht, Wt) -> (B, Ht, Wt, C), zero where
    no candidate won."""
    b, m, c = payload.shape
    got = torch.gather(payload, 1, winner.clamp(min=0).reshape(b, -1, 1)
                       .expand(-1, -1, c))
    got = got.reshape(winner.shape + (c,))
    return torch.where((winner >= 0)[..., None], got, torch.zeros_like(got))


def forward_warp(depth, color, k_src, k_dst, transform, out_hw,
                 subsample=2, remove_edges=True, edge_angle_deg=89.0,
                 of_by_one=True, depth_tie_eps=1e-3, min_depth=1e-4):
    """Warp a batch of depth + color frames into target cameras through a
    scatter z-buffer.

    depth (B, H, W) meters; color (B, H, W, C) payload (interpolated per
    sample); k_src, k_dst (B, 3, 3); transform (B, 4, 4) source camera ->
    target camera; out_hw the target size. ``subsample`` S: each grid cell
    emits S x S bilinear samples (S = 1 is point splatting; S >= 2 fills
    a cell's stretch like a mesh's interior); ``remove_edges`` culls
    near-silhouette cells, whose holes become the infill mask.
    Returns a :class:`WarpResult`.
    """
    ht, wt = out_hw
    b, h, w = depth.shape
    c = color.shape[-1]
    s = int(subsample)
    step = _images_per_pass(b, _zbuffer_bytes(h * w * s * s, ht * wt, c))
    if step < b:
        return WarpResult(*_in_passes(
            lambda *a: forward_warp(*a, out_hw, subsample, remove_edges,
                                    edge_angle_deg, of_by_one, depth_tie_eps,
                                    min_depth),
            step, b, depth, color, k_src, k_dst, transform))
    depth = depth.to(torch.float32)

    pts_cam = geo.unproject_depth(depth, k_src, of_by_one=of_by_one)
    edge = cell_edge_mask(pts_cam, edge_angle_deg)
    uv, z = _project_map(geo.transform_depth_map(pts_cam, transform), k_dst)

    u00, u01, u10, u11 = _cell_corners(uv)
    z00, z01, z10, z11 = (x[..., 0] for x in _cell_corners(z[..., None]))
    c00, c01, c10, c11 = _cell_corners(color.to(torch.float32))
    valid_pix = depth > min_depth
    v00, v01, v10, v11 = (x[..., 0] for x in _cell_corners(
        valid_pix[..., None]))
    cell_valid = v00 & v01 & v10 & v11
    if remove_edges:
        cell_valid = cell_valid & ~edge

    # the S x S sample sets in the JAX package's order: (ia, ib) in loop
    # order, each set in raster order
    cand_idx, cand_z, cand_col = [], [], []
    for ia in range(s):
        for ib in range(s):
            wa0, wa1 = 1.0 - ia / s, ia / s
            wb0, wb1 = 1.0 - ib / s, ib / s

            def mix(x00, x01, x10, x11):
                return (wa0 * wb0 * x00 + wa0 * wb1 * x01
                        + wa1 * wb0 * x10 + wa1 * wb1 * x11)
            su = mix(u00, u01, u10, u11)
            sz = mix(z00, z01, z10, z11)
            ok = cell_valid if (ia or ib) else valid_pix
            cand_idx.append(_target_slot(su, ok, sz, out_hw,
                                         min_depth).reshape(b, -1))
            cand_z.append(sz.reshape(b, -1))
            cand_col.append(mix(c00, c01, c10, c11).reshape(b, -1, c))

    zout, winner = _zbuffer(torch.cat(cand_idx, 1), torch.cat(cand_z, 1),
                            out_hw, depth_tie_eps)
    mask = zout < INF_DEPTH
    return WarpResult(color=_take_payload(torch.cat(cand_col, 1), winner),
                      depth=zout, mask=mask, edge_mask=edge & valid_pix)


def splat_points(points_cam, payload, k, out_hw, radius=0, min_depth=1e-4,
                 depth_tie_eps=1e-3):
    """Z-buffered point splatting into target cameras.

    points_cam (B, N, 3) target-camera points; payload (B, N, C); k
    (B, 3, 3). ``radius`` splats each point into its (2r+1)^2
    neighbourhood. Returns (payload image (B, Ht, Wt, C), depth
    (B, Ht, Wt), INF where nothing landed, mask (B, Ht, Wt))."""
    b, n, _ = points_cam.shape
    n_rep = (2 * radius + 1) ** 2
    step = _images_per_pass(b, _zbuffer_bytes(
        n * n_rep, out_hw[0] * out_hw[1], payload.shape[-1]))
    if step < b:
        return _in_passes(
            lambda *a: splat_points(*a, out_hw, radius, min_depth,
                                    depth_tie_eps),
            step, b, points_cam, payload, k)
    uv, z = geo.project_points(points_cam, k)
    ui0 = torch.round(uv[..., 0])
    vi0 = torch.round(uv[..., 1])
    ok = torch.ones_like(z, dtype=torch.bool)
    offs = range(-radius, radius + 1)
    # the (2r+1)^2 shifted copies in the JAX package's order (dy outer)
    idx = torch.cat([_target_slot(torch.stack([ui0 + dx, vi0 + dy], -1), ok,
                                  z, out_hw, min_depth)
                     for dy in offs for dx in offs], 1)
    zout, winner = _zbuffer(idx, z.repeat(1, n_rep), out_hw, depth_tie_eps)
    # candidate p is point p mod N of its shifted copy
    img = _take_payload(payload.to(torch.float32),
                        torch.where(winner >= 0, winner % n, -1))
    return img, zout, zout < INF_DEPTH


def plane_sweep_warp(depth, color, k_src, k_dst, transform, out_hw,
                     num_planes=128, remove_edges=True, edge_angle_deg=89.0,
                     of_by_one=True, min_depth=1e-2, tol_scale=2.0):
    """Scatter-free re-render of a batch: for every target pixel, sweep
    depth hypotheses front to back (uniform in inverse depth over each
    source depth map's range), back-project each into the source camera
    and accept the first whose bilinearly sampled source depth agrees.

    Arguments as :func:`forward_warp`. Returns a :class:`WarpResult`.
    """
    ht, wt = out_hw
    b, h, w = depth.shape
    chunk = min(16, num_planes)
    step = _images_per_pass(b, chunk * ht * wt * PLANE_SWEEP_BYTES)
    if step < b:
        return WarpResult(*_in_passes(
            lambda *a: plane_sweep_warp(*a, out_hw, num_planes, remove_edges,
                                        edge_angle_deg, of_by_one, min_depth,
                                        tol_scale),
            step, b, depth, color, k_src, k_dst, transform))
    dev = depth.device
    depth = depth.to(torch.float32)

    edge = (cell_edge_mask(geo.unproject_depth(depth, k_src,
                                               of_by_one=of_by_one),
                           edge_angle_deg) if remove_edges else None)
    valid_src = depth > min_depth
    inf = torch.full_like(depth, math.inf)
    z_near = torch.clamp(torch.where(valid_src, depth, inf).amin((1, 2)),
                         min=min_depth)
    z_far = torch.maximum(torch.where(valid_src, depth, -inf).amax((1, 2)),
                          z_near * (1.0 + 1e-3))
    inv_near = 1.0 / z_near
    d_inv = (inv_near - 1.0 / z_far) / (num_planes - 1)

    def col(a):                     # (B,) -> (B, 1, 1, 1) over the chunk
        return a[:, None, None, None]
    m_inv = torch.linalg.inv(transform)
    r = m_inv[:, :3, :3]
    t = m_inv[:, :3, 3]
    x = ((torch.arange(wt, dtype=torch.float32, device=dev)[None]
          - k_dst[:, 0, 2, None]) / k_dst[:, 0, 0, None])
    y = ((torch.arange(ht, dtype=torch.float32, device=dev)[None]
          - k_dst[:, 1, 2, None]) / k_dst[:, 1, 1, None])
    dir_x = x[:, None, None, :]     # (B, 1, 1, Wt)
    dir_y = y[:, None, :, None]     # (B, 1, Ht, 1)
    fx_s, fy_s = col(k_src[:, 0, 0]), col(k_src[:, 1, 1])
    cx_s, cy_s = col(k_src[:, 0, 2]), col(k_src[:, 1, 2])
    # the source grid was built with the of_by_one stretch: invert it when
    # mapping back to source pixel indices
    sx = (w / (w + 1.0)) if of_by_one else 1.0
    sy = (h / (h + 1.0)) if of_by_one else 1.0
    edge_f = edge.to(torch.float32) if edge is not None else None

    # the last chunk is padded past num_planes, as in the JAX package's scan
    n_chunks = -(-num_planes // chunk)
    plane_ids = torch.arange(n_chunks * chunk, dtype=torch.float32,
                             device=dev).reshape(n_chunks, chunk)
    found = torch.zeros((b, ht, wt), dtype=torch.bool, device=dev)
    best_z = torch.full((b, ht, wt), INF_DEPTH, dtype=torch.float32,
                        device=dev)
    best_u = torch.zeros((b, ht, wt), dtype=torch.float32, device=dev)
    best_v = torch.zeros((b, ht, wt), dtype=torch.float32, device=dev)
    for ids in plane_ids:
        inv_z = inv_near[:, None] - d_inv[:, None] * ids[None]
        z_t = (1.0 / inv_z)[:, :, None, None]            # (B, C, 1, 1)
        px = dir_x * z_t
        py = dir_y * z_t

        def row(i):
            return (col(r[:, i, 0]) * px + col(r[:, i, 1]) * py
                    + col(r[:, i, 2]) * z_t + col(t[:, i]))
        sx_c, sy_c, sz_c = row(0), row(1), row(2)
        behind = sz_c <= min_depth
        zs = torch.where(behind, torch.ones_like(sz_c), sz_c)
        u_s = (sx_c / zs * fx_s + cx_s) * sx
        v_s = (sy_c / zs * fy_s + cy_s) * sy
        d_s = _bilinear_gather(depth, u_s, v_s, fill=-1.0)
        tol = tol_scale * sz_c * sz_c * col(d_inv) + 1e-4
        ok = (~behind) & (d_s > min_depth) & (torch.abs(d_s - sz_c) < tol)
        if edge_f is not None:
            ok = ok & (_bilinear_gather(edge_f, u_s, v_s, fill=1.0) < 0.25)
        hit = ok.any(dim=1)
        # the first consistent plane of the chunk (argmax returns the
        # first maximum)
        first = ok.to(torch.uint8).argmax(dim=1, keepdim=True)

        def pick(field):
            return torch.gather(field.expand(b, chunk, ht, wt), 1,
                                first)[:, 0]
        newly = hit & ~found
        best_z = torch.where(newly, pick(sz_c), best_z)
        best_u = torch.where(newly, pick(u_s), best_u)
        best_v = torch.where(newly, pick(v_s), best_v)
        found = found | hit

    out_color = _bilinear_gather(color.to(torch.float32), best_u, best_v,
                                 fill=0.0)
    out_color = torch.where(found[..., None], out_color,
                            torch.zeros_like(out_color))
    # refine past the plane quantization: the matched source pixel's own
    # depth, unprojected and carried through the forward transform
    d_hit = _bilinear_gather(depth, best_u, best_v, fill=0.0)
    sxp = (best_u / sx - cx_s[..., 0]) / fx_s[..., 0] * d_hit
    syp = (best_v / sy - cy_s[..., 0]) / fy_s[..., 0] * d_hit
    rf = transform[:, None, None, 2, :]
    z_ref = (rf[..., 0] * sxp + rf[..., 1] * syp + rf[..., 2] * d_hit
             + rf[..., 3])
    out_depth = torch.where(found & (d_hit > min_depth), z_ref,
                            torch.where(found, best_z,
                                        torch.full_like(best_z, INF_DEPTH)))
    edge_out = (edge & valid_src) if edge is not None else \
        torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    return WarpResult(color=out_color, depth=out_depth, mask=found,
                      edge_mask=edge_out)


def warp_pixel_ids(depth, k_src, k_dst, transform, out_hw, subsample=1,
                   remove_edges=False, of_by_one=True):
    """Forward warp carrying each source pixel's flat id as the payload
    (the pixel-id render pass). Returns (ids (B, Ht, Wt) int32, -1 where
    nothing landed; the depth buffer)."""
    b, h, w = depth.shape
    ids = torch.arange(h * w, dtype=torch.float32, device=depth.device)
    res = forward_warp(depth, ids.reshape(1, h, w, 1).expand(b, h, w, 1),
                       k_src, k_dst, transform, out_hw, subsample=subsample,
                       remove_edges=remove_edges, of_by_one=of_by_one)
    out = torch.round(res.color[..., 0]).to(torch.int32)
    return torch.where(res.mask, out, torch.full_like(out, -1)), res.depth


def remap_ids_to_img(rgb_image, id_maps, invalid_color=(0, 0, 0)):
    """Chase pixel ids through a chain of render passes back to source
    colors: idsN -> ids(N-1) -> ... -> ids1 -> rgb_image (H0, W0, C).

    id_maps: list of (Hi, Wi) int id images, -1 or out of range invalid.
    """
    final_shape = tuple(id_maps[-1].shape)
    current = id_maps[-1].reshape(-1).to(torch.int64)
    valid = torch.ones(current.shape, dtype=torch.bool,
                       device=current.device)
    for stage in reversed(range(len(id_maps) - 1)):
        ids = id_maps[stage].reshape(-1).to(torch.int64)
        ok = (current >= 0) & (current < ids.numel())
        valid = valid & ok
        current = torch.where(ok, ids[current.clamp(0, ids.numel() - 1)],
                              torch.full_like(current, -1))
    h0, w0 = rgb_image.shape[:2]
    ok = valid & (current >= 0) & (current < h0 * w0)
    src = rgb_image.reshape(-1, rgb_image.shape[-1])[
        current.clamp(0, h0 * w0 - 1)]
    inv = torch.as_tensor(invalid_color, dtype=rgb_image.dtype,
                          device=rgb_image.device)
    out = torch.where(ok[:, None], src, inv)
    return out.reshape(final_shape + (rgb_image.shape[-1],))
