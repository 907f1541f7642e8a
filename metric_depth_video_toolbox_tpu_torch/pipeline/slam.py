"""Camera tracking with global bundle adjustment (PyTorch port of
``pipeline/slam.py``), ``mdvt-torch slam``.

Two paths:

  - ``slam_track_video`` (no checkpoint): LK tracks (``pipeline.tracking``)
    -> pairwise initial poses (``pipeline.align``, the two-group solver)
    -> ``bundle_adjust``: fixed-iteration Gauss-Newton over all camera
    poses jointly (and the focal scale with ``--optimize_intrinsic``),
    minimizing the reprojection error of depth-anchored world points, the
    per-track structure variable eliminated by a Schur complement;
    motion-inconsistent and masked tracks weighted down.
  - ``droid_track_video`` (``--checkpoint``): the learned DROID-class
    front-end (``models.droid``) over windows of frames (correlation
    pyramids over the window's frame graph, the ConvGRU update, pose
    Gauss-Newton on the per-edge normal equations, windows chained with
    an overlap of one frame), then the same global bundle adjustment over
    LK tracks seeded with the windowed poses.

Jacobians come from forward-mode differentiation (``torch.func.jacfwd``
under ``vmap``); the loops run on the device with no host read inside.
Outputs ``*_transformations.json`` (camera to world) and, with
``save_motion_video``, ``_transformations.json_motion.mkv``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.io import video as vio
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.ops import image as im
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def _add_at(target, index, values):
    """``target[index] += values`` with repeated indices accumulated."""
    return target.index_put_(index, values, accumulate=True)


def bundle_adjust(track_uv, track_valid, anchor_depth, k, rvecs0, tvecs0,
                  iters=10, optimize_focal=False, damping=1e-3):
    """Global Gauss-Newton bundle adjustment with a Schur complement on the
    poses.

    Each residual (t, n) touches two poses (the observing frame t and
    track n's anchor frame, its first valid observation), one structure
    variable (the track's log-inverse-depth correction) and, with
    ``optimize_focal``, the global focal scale; the structure block is
    diagonal, so the system reduces to S = Hp - E C^-1 E^T over the 6T
    (+1) pose and focal variables. Levenberg damping ``damping`` plus an
    absolute floor; frame 0 is pinned.

    track_uv (T, N, 2) observed pixels; track_valid (T, N) weights (0:
    missing); anchor_depth (N,) each track's depth in its anchor frame; k
    (3, 3); rvecs0 / tvecs0 (T, 3) initial world-to-camera poses. ->
    (rvecs, tvecs, focal_scale, point_logz, mean_residual)"""
    t_frames, n_tracks = track_valid.shape
    dev = track_uv.device
    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    first_idx = torch.argmax((track_valid > 0).to(torch.int32), dim=0)
    anchor_uv = track_uv[first_idx, torch.arange(n_tracks, device=dev)]
    aray = torch.stack([(anchor_uv[:, 0] - cx) / fx,
                        (anchor_uv[:, 1] - cy) / fy], -1)        # (N, 2)

    def res_one(packed, uv, w, ar, adepth):
        """One weighted (2,) residual of [pose_t (6), pose_a (6), logz,
        log_f]."""
        pose_t, pose_a = packed[0:6], packed[6:12]
        logz, logf = packed[12], packed[13]
        # a tensor 1, not the float: see ops/solvers.py::_so3_exp
        fscale = torch.exp(logf) if optimize_focal else torch.ones_like(logf)
        z = adepth * torch.exp(logz)
        p_anchor = torch.stack([ar[0] / fscale * z, ar[1] / fscale * z, z])
        ra = solvers._so3_exp(pose_a[:3])
        pw = ra.T @ (p_anchor - pose_a[3:6])
        rt = solvers._so3_exp(pose_t[:3])
        pc = rt @ pw + pose_t[3:6]
        zc = torch.clamp(pc[2], min=1e-3)
        u = pc[0] / zc * fx * fscale + cx
        v = pc[1] / zc * fy * fscale + cy
        return (torch.stack([u, v]) - uv) * w

    in_dims = ((0, 0, 0, 0, 0), (0, 0, 0, None, None))
    res_all = vmap(vmap(res_one, in_dims=in_dims[0]), in_dims=in_dims[1])
    jac_all = vmap(vmap(jacfwd(res_one), in_dims=in_dims[0]),
                   in_dims=in_dims[1])

    t_idx = torch.arange(t_frames, device=dev)
    n_idx = torch.arange(n_tracks, device=dev)
    np_pose = 6 * t_frames + (1 if optimize_focal else 0)
    eye = torch.eye(np_pose, dtype=torch.float32, device=dev)

    def packed_of(rvecs, tvecs, logz, logf):
        poses = torch.cat([rvecs, tvecs], -1)                    # (T, 6)
        return torch.cat([
            poses[:, None].expand(t_frames, n_tracks, 6),
            poses[first_idx][None].expand(t_frames, n_tracks, 6),
            logz[None, :, None].expand(t_frames, n_tracks, 1),
            logf.reshape(1, 1, 1).expand(t_frames, n_tracks, 1)], -1)

    rvecs, tvecs = rvecs0, tvecs0
    logz = torch.zeros(n_tracks, dtype=torch.float32, device=dev)
    logf = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        packed = packed_of(rvecs, tvecs, logz, logf)
        r = res_all(packed, track_uv, track_valid, aray, anchor_depth)
        jac = jac_all(packed, track_uv, track_valid, aray, anchor_depth)
        # gauge: frame 0 contributes no pose derivatives
        jt = jac[..., 0:6] * (t_idx != 0)[:, None, None, None]
        ja = jac[..., 6:12] * (first_idx != 0)[None, :, None, None]
        jz = jac[..., 12]
        jf = jac[..., 13]

        # normal equations, pose part: a (T, T, 6, 6) block matrix
        h = torch.zeros((t_frames, t_frames, 6, 6), dtype=torch.float32,
                        device=dev)
        _add_at(h, (t_idx, t_idx), torch.einsum("tnai,tnaj->tij", jt, jt))
        _add_at(h, (first_idx, first_idx),
                torch.einsum("tnai,tnaj->nij", ja, ja))
        h_ta = torch.einsum("tnai,tnaj->tnij", jt, ja)
        _add_at(h, (t_idx[:, None], first_idx[None, :]), h_ta)
        _add_at(h, (first_idx[:, None], t_idx[None, :]),
                h_ta.permute(1, 0, 3, 2))
        hp = h.permute(0, 2, 1, 3).reshape(6 * t_frames, 6 * t_frames)

        # structure (diagonal) and the couplings
        c_diag = torch.einsum("tna,tna->n", jz, jz)
        e = torch.einsum("tnai,tna->tni", jt, jz)
        _add_at(e, (first_idx, n_idx), torch.einsum("tnai,tna->ni", ja, jz))
        e = e.permute(0, 2, 1).reshape(6 * t_frames, n_tracks)
        g_pose = torch.einsum("tnai,tna->ti", jt, r).index_add(
            0, first_idx, torch.einsum("tnai,tna->ni", ja, r)).reshape(-1)
        g_z = torch.einsum("tna,tna->n", jz, r)

        if optimize_focal:
            h_ff = torch.sum(jf * jf).reshape(1, 1)
            h_pf = torch.einsum("tnai,tna->ti", jt, jf).index_add(
                0, first_idx, torch.einsum("tnai,tna->ni", ja, jf)
            ).reshape(6 * t_frames, 1)
            hp = torch.cat([torch.cat([hp, h_pf], 1),
                            torch.cat([h_pf.T, h_ff], 1)], 0)
            e = torch.cat([e, torch.einsum("tna,tna->n", jf, jz)[None]], 0)
            g_pose = torch.cat([g_pose, torch.sum(jf * r)[None]])

        # Levenberg damping + an absolute floor (dead tracks / frames)
        diag = torch.diagonal(hp)
        floor = 1e-5 * (1.0 + torch.max(torch.abs(diag)))
        hp = hp + damping * torch.diag(diag) + floor * eye
        c_inv = 1.0 / (c_diag * (1.0 + damping)
                       + 1e-5 * (1.0 + torch.max(c_diag)))

        # Schur complement on the poses
        s = hp - (e * c_inv[None, :]) @ e.T
        rhs = -(g_pose - e @ (c_inv * g_z))
        dy = torch.linalg.solve(s, rhs)
        dz = c_inv * (-g_z - e.T @ dy)
        dy = torch.nan_to_num(dy)
        dz = torch.nan_to_num(dz)

        dpose = dy[:6 * t_frames].reshape(t_frames, 6)
        rvecs = torch.cat([rvecs0[:1], (rvecs + dpose[:, :3])[1:]])
        tvecs = torch.cat([tvecs0[:1], (tvecs + dpose[:, 3:])[1:]])
        logz = logz + dz
        if optimize_focal:
            logf = logf + dy[-1]

    res = res_all(packed_of(rvecs, tvecs, logz, logf), track_uv,
                  track_valid, aray, anchor_depth)
    denom = torch.clamp(track_valid.sum(), min=1.0)
    mean_res = torch.sum(torch.linalg.norm(res, dim=-1)) / denom
    fscale = (torch.exp(logf) if optimize_focal
              else torch.ones((), device=dev))
    return rvecs, tvecs, fscale, logz, mean_res


def motion_weights(dense_tracks, transforms, depths_at_tracks, k,
                   z_thresh=2.0):
    """Per-track static-scene weights (host numpy): a track whose
    frame-0 unprojection reprojects through the camera poses with a mean
    error more than ``z_thresh`` standard deviations above the tracks'
    mean weighs 0.1, others 1."""
    t, n = dense_tracks.shape[:2]
    errs = np.zeros(n)
    counts = np.zeros(n) + 1e-9
    for fi in range(1, t):
        v = (dense_tracks[fi, :, 2] > 0) & (dense_tracks[0, :, 2] > 0)
        if v.sum() < 8:
            continue
        z0 = depths_at_tracks[0]
        p0 = np.stack([(dense_tracks[0, :, 0] - k[0, 2]) / k[0, 0] * z0,
                       (dense_tracks[0, :, 1] - k[1, 2]) / k[1, 1] * z0,
                       z0], axis=-1)
        m = np.linalg.inv(transforms[fi]) @ transforms[0]
        pc = p0 @ m[:3, :3].T + m[:3, 3]
        zc = np.maximum(pc[:, 2], 1e-3)
        u = pc[:, 0] / zc * k[0, 0] + k[0, 2]
        vv = pc[:, 1] / zc * k[1, 1] + k[1, 2]
        e = np.hypot(u - dense_tracks[fi, :, 0],
                     vv - dense_tracks[fi, :, 1])
        errs[v] += e[v]
        counts[v] += 1
    mean_e = errs / counts
    mu, sd = mean_e.mean(), mean_e.std() + 1e-9
    zscores = (mean_e - mu) / sd
    return np.where(zscores > z_thresh, 0.1, 1.0).astype(np.float32)


def _masked_ever(mask_video, dense, xi, yi, t_total, max_frames):
    """(N,) bool: tracks that land on a masked pixel (> 127) in any frame
    where they are valid."""
    masked = np.zeros(dense.shape[1], bool)
    with vio.VideoReader(mask_video, max_frames=max_frames) as mv:
        for fi in range(t_total):
            m = mv.read_batch(1)
            if m is None:
                break
            gray = m[0][..., 0]
            masked |= (dense[fi, :, 2] > 0) & (gray[yi[fi], xi[fi]] > 127)
    return masked


def _log_so3(r):
    """Rotation matrix -> axis-angle (host numpy)."""
    cos = np.clip((np.trace(r) - 1) / 2, -1, 1)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return np.zeros(3, np.float32)
    w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return (w * theta / (2 * np.sin(theta))).astype(np.float32)


def _refine(dense, depths_at, c2w, k, weights, ba_iters, optimize_focal,
            device):
    """The global bundle adjustment over ``dense`` tracks seeded with
    camera-to-world poses ``c2w`` -> (c2w (T, 4, 4) float32, mean
    reprojection error in px)."""
    t_total, n = dense.shape[:2]
    valid = dense[..., 2] * weights[None, :]
    first_idx = np.argmax(dense[..., 2] > 0, axis=0)
    anchor_depth = np.maximum(depths_at[first_idx, np.arange(n)], 1e-2)
    w2c = np.linalg.inv(c2w)
    rvecs0 = np.stack([_log_so3(w2c[i, :3, :3])
                       for i in range(t_total)]).astype(np.float32)
    tvecs0 = w2c[:, :3, 3].astype(np.float32)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    rv, tv, _fs, _lz, mean_res = bundle_adjust(
        dev(dense[..., :2]), dev(valid), dev(anchor_depth), dev(k),
        dev(rvecs0), dev(tvecs0), iters=ba_iters,
        optimize_focal=optimize_focal)
    m = torch.eye(4, dtype=torch.float32).repeat(t_total, 1, 1)
    m[:, :3, :3] = solvers._so3_exp(rv.cpu())
    m[:, :3, 3] = tv.cpu()
    return np.linalg.inv(m.numpy()), float(mean_res)


def slam_track_video(color_video, depth_video, xfov=None, yfov=None,
                     max_depth=100.0, max_frames=-1, output=None,
                     optimize_intrinsic=False, ba_iters=10,
                     max_tracks=512, grid=24, save_motion_video=False,
                     mask_video=None, device=None):
    """LK tracks -> pairwise initial poses (written to
    ``<depth_video>_init_transformations.json``) -> global bundle
    adjustment -> ``<depth_video>_transformations.json`` (or ``output``).
    -> (transformations path, mean reprojection error px)"""
    from metric_depth_video_toolbox_tpu_torch.pipeline import align as al
    from metric_depth_video_toolbox_tpu_torch.pipeline import tracking as tr

    device = resolve_device(device)
    track_path = tr.track_video(color_video, grid=grid,
                                max_frames=max_frames, device=device)
    init_path = al.align_video(
        depth_video, track_path, xfov=xfov, yfov=yfov, max_depth=max_depth,
        max_frames=max_frames, max_tracks=max_tracks,
        output=depth_video + "_init_transformations.json", device=device)
    transforms = sidecar.load_transformations(init_path)        # c2w
    dense, _ = sidecar.tracking_to_dense(sidecar.load_tracking(track_path),
                                         max_tracks=max_tracks)
    t_total = min(len(transforms), dense.shape[0])
    dense = dense[:t_total]
    transforms = transforms[:t_total]

    depths_at = np.zeros((t_total, dense.shape[1]), np.float32)
    with vio.DepthVideoReader(depth_video, max_depth) as dv:
        h, w = dv.height, dv.width
        xi = np.clip(np.round(dense[..., 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(dense[..., 1]).astype(int), 0, h - 1)
        for fi in range(t_total):
            d = dv.read_depth_batch(1)
            if d is None:
                break
            depths_at[fi] = d[0][yi[fi], xi[fi]]
    k = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov,
                                   yfov_deg=yfov).numpy()

    weights = motion_weights(dense, transforms, depths_at, k)
    if mask_video:
        weights = np.where(_masked_ever(mask_video, dense, xi, yi, t_total,
                                        max_frames), 0.0, weights)
    out, mean_res = _refine(dense, depths_at, transforms, k, weights,
                            ba_iters, optimize_intrinsic, device)
    output = output or (depth_video + "_transformations.json")
    sidecar.save_transformations(output, out.astype(np.float32))
    if save_motion_video:
        _write_motion_video(color_video, dense, weights, output)
    return output, mean_res


def _global_ba_refine(color_video, depth, k, c2w_init, max_frames=-1,
                      mask_video=None, ba_iters=10, max_tracks=512,
                      grid=24, device=None):
    """The final bundle adjustment over the whole clip after the learned
    front-end: LK tracks, depth-anchored, seeded with the windowed poses.
    ``depth`` (T, H, W) metric depth in host memory. -> (c2w (T, 4, 4),
    mean reprojection error px)"""
    from metric_depth_video_toolbox_tpu_torch.pipeline import tracking as tr

    track_path = tr.track_video(color_video, grid=grid,
                                max_frames=max_frames, device=device)
    dense, _ = sidecar.tracking_to_dense(sidecar.load_tracking(track_path),
                                         max_tracks=max_tracks)
    t_total = min(len(c2w_init), dense.shape[0], depth.shape[0])
    dense = dense[:t_total]
    c2w = np.asarray(c2w_init[:t_total], np.float32)
    h, w = depth.shape[1:3]
    xi = np.clip(np.round(dense[..., 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(dense[..., 1]).astype(int), 0, h - 1)
    depths_at = depth[np.arange(t_total)[:, None], yi, xi]
    weights = motion_weights(dense, c2w, depths_at, k)
    if mask_video:
        weights = np.where(_masked_ever(mask_video, dense, xi, yi, t_total,
                                        max_frames), 0.0, weights)
    return _refine(dense, depths_at, c2w, k, weights, ba_iters, False,
                   device)


# --- the learned (DROID-class) front-end ------------------------------------


def _window_edges(w, radius):
    ii, jj = [], []
    for i in range(w):
        for j in range(max(0, i - radius), min(w, i + radius + 1)):
            if i != j:
                ii.append(i)
                jj.append(j)
    return np.asarray(ii, np.int64), np.asarray(jj, np.int64)


def _build_window_solver(model, cfg, k8, w_frames, h8, w8, iters,
                         gn_inner, radius):
    """-> solve(fmap, net0, inp0, depth8, wmask8) -> (rot (W, 3, 3), tr
    (W, 3), mean residual) for one window: correlation pyramids over the
    window's frame graph (each frame to its neighbours within
    ``radius``), ``iters`` learned update steps (flow revision and
    confidence), each followed by ``gn_inner`` pose Gauss-Newton steps on
    the per-edge normal equations gathered into one (6W, 6W) system (the
    depth is given; frame 0 is fixed). Inputs per frame: features (W, C,
    h8, w8), depth8 and wmask8 (W, h8, w8) on the model's device."""
    from metric_depth_video_toolbox_tpu_torch.models import droid as dm

    dev = next(model.parameters()).device
    ii_np, jj_np = _window_edges(w_frames, radius)
    ii = torch.from_numpy(ii_np).to(dev)
    jj = torch.from_numpy(jj_np).to(dev)
    n_e = len(ii_np)
    p_pix = h8 * w8
    fx, fy, cx, cy = (float(k8[0, 0]), float(k8[1, 1]), float(k8[0, 2]),
                      float(k8[1, 2]))
    gy, gx = torch.meshgrid(
        torch.arange(h8, dtype=torch.float32, device=dev),
        torch.arange(w8, dtype=torch.float32, device=dev), indexing="ij")
    grid = torch.stack([gx, gy], -1)                       # (h8, w8, 2)

    def unproject(d):  # (..., h8, w8) -> (..., h8, w8, 3) camera points
        return torch.stack([(grid[..., 0] - cx) / fx * d,
                            (grid[..., 1] - cy) / fy * d, d], -1)

    def proj(pts):  # (..., 3) -> (..., 2)
        z = torch.clamp(pts[..., 2], min=1e-4)
        return torch.stack([fx * pts[..., 0] / z + cx,
                            fy * pts[..., 1] / z + cy], -1)

    def induced(rot, tr, pts_cam):
        """World-to-camera poses and each frame's camera points -> each
        edge's target coordinates and target-frame depth."""
        xw = torch.einsum("ephc,ecd->ephd",
                          pts_cam[ii] - tr[ii][:, None, None], rot[ii])
        xj = torch.einsum("ephc,edc->ephd", xw, rot[jj]) \
            + tr[jj][:, None, None]
        return proj(xj), xj[..., 2]

    def edge_res(xi, ri0, ti0, rj0, tj0, pts, tgt):
        """(12,) increments of poses i and j -> (P * 2,) residuals."""
        dri = solvers._so3_exp(xi[:3])
        drj = solvers._so3_exp(xi[6:9])
        ri = dri @ ri0
        tci = dri @ ti0 + xi[3:6]
        rj = drj @ rj0
        tcj = drj @ tj0 + xi[9:12]
        xw = (pts.reshape(-1, 3) - tci) @ ri
        xj = xw @ rj.T + tcj
        return (proj(xj) - tgt.reshape(-1, 2)).reshape(-1)

    edge_res_all = vmap(edge_res)
    edge_jac_all = vmap(jacfwd(edge_res))
    rows6 = torch.arange(6, device=dev)
    hdim = 6 * w_frames
    idx_i = 6 * ii[:, None] + rows6[None]
    idx_j = 6 * jj[:, None] + rows6[None]
    eye = torch.eye(hdim, dtype=torch.float32, device=dev)
    zero = torch.zeros((n_e, 12), dtype=torch.float32, device=dev)

    def gn_step(rot, tr, pts_cam, target, wgt, eta):
        args = (zero, rot[ii], tr[ii], rot[jj], tr[jj], pts_cam[ii], target)
        r = edge_res_all(*args)
        j = edge_jac_all(*args)
        w_flat = wgt.reshape(n_e, p_pix * 2)
        h_e = torch.einsum("epk,ep,epl->ekl", j, w_flat, j)
        b_e = torch.einsum("epk,ep->ek", j, w_flat * r)
        big_h = torch.zeros((hdim, hdim), dtype=torch.float32, device=dev)
        big_b = torch.zeros((hdim,), dtype=torch.float32, device=dev)
        _add_at(big_h, (idx_i[:, :, None], idx_i[:, None, :]), h_e[:, :6, :6])
        _add_at(big_h, (idx_i[:, :, None], idx_j[:, None, :]), h_e[:, :6, 6:])
        _add_at(big_h, (idx_j[:, :, None], idx_i[:, None, :]), h_e[:, 6:, :6])
        _add_at(big_h, (idx_j[:, :, None], idx_j[:, None, :]), h_e[:, 6:, 6:])
        _add_at(big_b, (idx_i,), b_e[:, :6])
        _add_at(big_b, (idx_j,), b_e[:, 6:])
        # damping: an LM floor plus the learned per-frame eta on the pose
        # diagonal (the depth is fixed)
        damp = 1e-4 + torch.repeat_interleave(eta.mean(dim=(1, 2)), 6)
        big_h = big_h + torch.diag(damp) + 1e-6 * eye
        # gauge: frame 0 frozen
        big_h[:6] = 0.0
        big_h[:, :6] = 0.0
        big_h[rows6, rows6] = 1.0
        big_b[:6] = 0.0
        delta = torch.linalg.solve(big_h, -big_b).reshape(w_frames, 6)
        drot = solvers._so3_exp(delta[:, :3])
        return (torch.einsum("wab,wbc->wac", drot, rot),
                torch.einsum("wab,wb->wa", drot, tr) + delta[:, 3:])

    @torch.no_grad()
    def solve(fmap, net0, inp0, depth8, wmask8):
        fm = fmap.permute(0, 2, 3, 1)
        pyr = dm.corr_pyramid(fm[ii].contiguous(), fm[jj].contiguous(),
                              cfg.corr_levels)
        net = net0[ii]
        inp = inp0[ii]
        pts_cam = unproject(depth8)
        rot = torch.eye(3, dtype=torch.float32, device=dev).repeat(
            w_frames, 1, 1)
        tr = torch.zeros((w_frames, 3), dtype=torch.float32, device=dev)
        target, _ = induced(rot, tr, pts_cam)
        eta = torch.zeros((w_frames, h8, w8), dtype=torch.float32,
                          device=dev)
        wgt = None
        for _ in range(iters):
            coords1, zj = induced(rot, tr, pts_cam)
            corr = dm.corr_lookup(pyr, coords1, cfg.corr_radius)
            flow_in = torch.cat([coords1 - grid, target - coords1], -1)
            net, delta, weight, eta, _ = model.update(
                net, inp, corr.permute(0, 3, 1, 2),
                flow_in.permute(0, 3, 1, 2), ii, w_frames)
            target = coords1 + delta.permute(0, 2, 3, 1)
            ok = ((zj > 1e-3)
                  & (target[..., 0] >= 0) & (target[..., 0] <= w8 - 1)
                  & (target[..., 1] >= 0) & (target[..., 1] <= h8 - 1)
                  & (depth8[ii] > 1e-3))
            wgt = weight.permute(0, 2, 3, 1) * (
                ok & (wmask8[ii] > 0.5))[..., None]
            for _ in range(gn_inner):
                rot, tr = gn_step(rot, tr, pts_cam, target, wgt, eta)
        coords1, _ = induced(rot, tr, pts_cam)
        resid = torch.sqrt(torch.sum((coords1 - target) ** 2, -1))
        wm = wgt.mean(dim=-1)
        mean_res = (resid * wm).sum() / torch.clamp(wm.sum(), min=1.0)
        return rot, tr, mean_res
    return solve


def droid_track_video(color_video, depth_video, params=None, cfg=None,
                      xfov=None, yfov=None, max_depth=100.0,
                      max_frames=-1, output=None, window=12, radius=2,
                      iters=6, gn_inner=2, work_long=336,
                      mask_video=None, rng_seed=0, batch=8,
                      global_ba=True, ba_iters=10, device=None):
    """The learned front-end: features at the working size (long side
    ``work_long``, multiples of 16; 1/8 of it for the features), windows
    of ``window`` frames solved from identity poses and chained with an
    overlap of one frame, then (``global_ba``, at least 3 frames) the
    global bundle adjustment over LK tracks. ``params``: a converted DROID
    / Mega-SAM tree (its configuration read from its shapes) or a port
    state dict with ``cfg``; None draws seeded weights (``rng_seed``) at
    ``cfg`` or DROID_TINY. -> (transformations path, mean residual: the
    global reprojection error in px with ``global_ba``, else the windows'
    mean flow residual)"""
    from metric_depth_video_toolbox_tpu_torch.models import droid as dm
    from metric_depth_video_toolbox_tpu_torch.models import from_jax

    device = resolve_device(device)
    cfg = cfg or (dm.config_from_params(params) if params is not None
                  else dm.DROID_TINY)
    model = dm.DroidNet(cfg)
    if params is None:
        from_jax.flax_like_init(model, torch.Generator().manual_seed(
            rng_seed))
    else:
        from_jax.load_params(model, params)
    model = model.to(device).eval()

    frames, _fps = vio.read_video_frames(color_video, max_frames=max_frames)
    t_total = frames.shape[0]
    with vio.DepthVideoReader(depth_video, max_depth) as dv:
        depth = dv.read_depth_batch(t_total)
    t_total = min(t_total, depth.shape[0])
    frames, depth = frames[:t_total], depth[:t_total]
    h, w = frames.shape[1:3]

    scale = work_long / max(h, w)
    wh = max(16, int(round(h * scale / 16)) * 16)
    ww = max(16, int(round(w * scale / 16)) * 16)
    h8, w8 = wh // 8, ww // 8
    k_full = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov,
                                        yfov_deg=yfov).numpy()
    k8 = k_full.copy()
    k8[0] *= ww / w / 8.0
    k8[1] *= wh / h / 8.0

    feats = []
    with torch.no_grad():
        for s in range(0, t_total, batch):
            x = torch.from_numpy(frames[s:s + batch]).to(
                device, torch.float32) / 255.0
            feats.append(model.features(im.resize(x, (wh, ww))))
    fmaps, nets, inps = (torch.cat(f) for f in zip(*feats))
    del feats

    depth8 = im.resize_nchw(torch.from_numpy(depth).to(device)[:, None],
                            (h8, w8))[:, 0]
    wmask8 = torch.ones((t_total, h8, w8), dtype=torch.float32,
                        device=device)
    if mask_video:
        with vio.VideoReader(mask_video, max_frames=max_frames) as mv:
            for fi in range(t_total):
                m = mv.read_batch(1)
                if m is None:
                    break
                mm = im.resize_nchw(torch.from_numpy(
                    m[0][..., 0].astype(np.float32)).to(device)[None, None],
                    (h8, w8))[0, 0]
                wmask8[fi] = (mm <= 127).to(torch.float32)

    window = max(2, min(window, t_total))
    solver_cache = {}
    out_w2c = np.zeros((t_total, 4, 4), np.float32)
    out_w2c[:] = np.eye(4, dtype=np.float32)
    residuals = []
    start = 0
    base = np.eye(4, dtype=np.float32)  # w2c of the window's frame 0
    while True:
        end = min(start + window, t_total)
        wlen = end - start
        if wlen < 2:
            break
        if wlen not in solver_cache:
            solver_cache[wlen] = _build_window_solver(
                model, cfg, k8, wlen, h8, w8, iters, gn_inner, radius)
        rot, tr, mres = solver_cache[wlen](
            fmaps[start:end], nets[start:end], inps[start:end],
            depth8[start:end], wmask8[start:end])
        rot, tr = rot.cpu().numpy(), tr.cpu().numpy()
        residuals.append(float(mres))
        for i in range(wlen):
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = rot[i]
            m[:3, 3] = tr[i]
            out_w2c[start + i] = m @ base  # local is relative to frame 0
        if end >= t_total:
            break
        base = out_w2c[end - 1].copy()  # overlap-1 chaining
        start = end - 1

    c2w = np.linalg.inv(out_w2c)
    mean_res = float(np.mean(residuals)) if residuals else 0.0
    if global_ba and t_total >= 3:
        c2w, mean_res = _global_ba_refine(
            color_video, depth, k_full, c2w, max_frames=max_frames,
            mask_video=mask_video, ba_iters=ba_iters, device=device)
    output = output or (depth_video + "_transformations.json")
    sidecar.save_transformations(output, c2w)
    return output, mean_res


def _write_motion_video(color_video, dense, weights, output_base):
    """The motion debug video ``<output_base>_motion.mkv``: each valid
    track a 3x3 dot, red when weighted down as moving, else green."""
    frames, fps = vio.read_video_frames(color_video)
    t = min(frames.shape[0], dense.shape[0])
    for fi in range(t):
        for ti in range(dense.shape[1]):
            if dense[fi, ti, 2] > 0:
                x, y = int(dense[fi, ti, 0]), int(dense[fi, ti, 1])
                if 0 <= x < frames.shape[2] and 0 <= y < frames.shape[1]:
                    col = [255, 40, 40] if weights[ti] < 0.5 else \
                        [40, 255, 40]
                    frames[fi, max(0, y - 1):y + 2,
                           max(0, x - 1):x + 2] = col
    vio.save_rgb_video(frames[:t], output_base + "_motion.mkv", fps)
