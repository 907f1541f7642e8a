"""Track-based camera aligner: 2D tracks + depth video -> per-frame 4x4
camera transforms (``*_transformations.json``); the PyTorch port of
``pipeline/align.py``.

Three pose solvers per consecutive frame pair:

  - ``two_group`` (default): three rounds of [rotation on the distant
    points -> x/y shift from the close points], then a 20-step z line
    search matching the mean 2D spread to the previous frame's;
  - ``stationary`` (``--assume_stationary_camera``): rotation only, on the
    distant points;
  - ``hybrid`` (``--use_madpose``): 64 minimal-set (3-point) Umeyama
    similarity fits, scored by reprojection and 3D-transfer inliers, the
    best refit on its inliers.

Tracks become a dense (T, N, 3) [x, y, valid] array; every solve has fixed
shapes and takes weights instead of boolean masks. The hybrid solver's
draws come from a ``torch.Generator`` seeded 0 for each pair, or from the
caller (``samples``).
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.io import video as vio
from metric_depth_video_toolbox_tpu_torch.ops import codec
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def _sample_depth(depth, pts_2d):
    """Nearest-pixel depth lookup for (N, 2) float pixel coordinates."""
    h, w = depth.shape
    xi = torch.clamp(torch.round(pts_2d[:, 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(pts_2d[:, 1]).to(torch.int64), 0, h - 1)
    return depth[yi, xi]


def _weighted_mean(x, w, dim=None):
    if dim is None:
        return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1e-9)
    return torch.sum(x * w, dim=dim) / torch.clamp(torch.sum(w, dim=dim),
                                                   min=1e-9)


def _points(pts_2d, ref_2d, depth_cur, depth_ref, k):
    p3 = geo.unproject_2d_points(pts_2d, _sample_depth(depth_cur, pts_2d), k)
    r3 = geo.unproject_2d_points(ref_2d, _sample_depth(depth_ref, ref_2d), k)
    return p3, r3


def _groups(p3, valid):
    """(distant, close) weights about the mean depth; a group of at most
    2 points falls back to all valid points."""
    mean_depth = _weighted_mean(p3[:, 2], valid)
    distant = valid * (p3[:, 2] > mean_depth)
    close = valid * (p3[:, 2] < mean_depth)
    distant = torch.where(torch.sum(distant) > 2, distant, valid)
    close = torch.where(torch.sum(close) > 2, close, valid)
    return distant, close


def _translation(shift):
    m = torch.eye(4, dtype=torch.float32, device=shift.device)
    m[:3, 3] = shift
    return m


def solve_pair_two_group(pts_2d, ref_2d, depth_cur, depth_ref, k, valid,
                         iters=3, z_steps=20):
    """The default two-group solver. pts_2d / ref_2d (N, 2) track positions
    in the current / previous frame, depth_cur / depth_ref (H, W) metric
    depth, valid (N,) 1 where the track is in both frames. -> the 4x4
    transform taking current-frame points into the previous frame's
    space."""
    p3, r3 = _points(pts_2d, ref_2d, depth_cur, depth_ref, k)
    distant, close = _groups(p3, valid)
    total = torch.eye(4, dtype=torch.float32, device=p3.device)
    zero_z = torch.tensor([1.0, 1.0, 0.0], device=p3.device)
    for _ in range(iters):
        rot = solvers.rigid_transform(p3, r3, weights=distant,
                                      zero_centroid=True)
        total = total @ rot
        p3 = geo.transform_points(p3, rot)
        close_rot = solvers.rigid_transform(p3, r3, weights=close,
                                            zero_centroid=True)
        cmean = _weighted_mean(p3, close[:, None], dim=0)
        moved = geo.transform_points(cmean[None], close_rot)[0]
        tr = _translation((moved - cmean) * zero_z)
        total = total @ tr
        p3 = geo.transform_points(p3, tr)
    final_rot = solvers.rigid_transform(p3, r3, weights=distant,
                                        zero_centroid=True)
    total = total @ final_rot
    p3 = geo.transform_points(p3, final_rot)

    # z line search: move along z until the projected 2D spread matches
    # the previous frame's
    center = torch.stack([k[0, 2], k[1, 2]])
    ref_dist = torch.linalg.norm(
        _weighted_mean(ref_2d, valid[:, None], 0) - center)
    step = torch.tensor(0.002, device=p3.device)
    direction = torch.tensor(1.0, device=p3.device)
    prev_err = torch.tensor(-1.0, device=p3.device)
    for _ in range(z_steps):
        uv, _ = geo.project_points(p3, k)
        cur = torch.linalg.norm(_weighted_mean(uv, valid[:, None], 0)
                                - center)
        err = torch.abs(cur - ref_dist)
        worse = (prev_err >= 0) & (err > prev_err)
        step = torch.where(worse & (direction < 0),
                           torch.full_like(step, 0.0001), step)
        direction = torch.where(worse, -direction, direction)
        zero = torch.zeros_like(step)
        dz = torch.where(err < 1e-5, zero, step * direction)
        tr = _translation(torch.stack([zero, zero, dz]))
        p3 = geo.transform_points(p3, tr)
        total = total @ tr
        prev_err = err
    return total


def solve_pair_stationary(pts_2d, ref_2d, depth_cur, depth_ref, k, valid):
    """Rotation only, on the distant points (a locked camera)."""
    p3, r3 = _points(pts_2d, ref_2d, depth_cur, depth_ref, k)
    distant, _ = _groups(p3, valid)
    return solvers.rigid_transform(p3, r3, weights=distant,
                                   zero_centroid=True)


def draw_hybrid_samples(valid, hypotheses=64, generator=None):
    """The hybrid solver's minimal sets: ``hypotheses`` x 3 indices drawn
    with replacement in proportion to max(valid, 1e-9) (every track may be
    drawn; an invalid one a billion times less often), from ``generator``
    (default: a new one seeded 0 on valid's device). -> (hypotheses, 3)"""
    if generator is None:
        generator = torch.Generator(device=valid.device).manual_seed(0)
    return solvers.draw_minimal_sets(generator, torch.clamp(valid, min=1e-9),
                                     hypotheses, 3, replace=True)


def solve_pair_hybrid(pts_2d, ref_2d, depth_cur, depth_ref, k, valid,
                      iters=6, hypotheses=64, inlier_px=6.0, samples=None):
    """Joint pose and depth scale with RANSAC: ``hypotheses`` minimal-set
    (3-point) Umeyama similarity fits (``samples``, (hypotheses, 3)
    indices, or :func:`draw_hybrid_samples`), each scored by the tracks
    within ``inlier_px`` of reprojection error and 5% of relative 3D
    transfer error; the best refit on its inliers (on all valid tracks
    when it has fewer than 8). ``iters`` is unused, as in the JAX
    package. -> (4x4 transform, scale)"""
    del iters
    p3, r3 = _points(pts_2d, ref_2d, depth_cur, depth_ref, k)
    n = p3.shape[0]

    def inliers(s, r, t):
        q = s[..., None, None] * (p3 @ r.transpose(-1, -2)) + t[..., None, :]
        z = torch.clamp(q[..., 2], min=1e-6)
        u = q[..., 0] / z * k[0, 0] + k[0, 2]
        v = q[..., 1] / z * k[1, 1] + k[1, 2]
        err = torch.hypot(u - ref_2d[:, 0], v - ref_2d[:, 1])
        d3 = torch.linalg.norm(q - r3, dim=-1) / torch.clamp(
            torch.linalg.norm(r3, dim=-1), min=1e-6)
        return valid * (err < inlier_px) * (d3 < 0.05)

    if samples is None:
        samples = draw_hybrid_samples(valid, hypotheses)
    samples = samples.to(p3.device)

    def fit(sel):
        w3 = torch.zeros(sel.shape[:-1] + (n,), device=p3.device)
        w3.scatter_add_(-1, sel, torch.ones(sel.shape, device=p3.device))
        return solvers.umeyama_sim3(p3.expand(w3.shape + (3,)),
                                    r3.expand(w3.shape + (3,)), weights=w3)

    scores = torch.sum(inliers(*fit(samples)), -1)
    s0, r0, t0 = fit(samples[torch.argmax(scores)])
    inl = inliers(s0, r0, t0)
    use = torch.where(torch.sum(inl) >= 8, inl, valid)
    s, r, t = solvers.umeyama_sim3(p3, r3, weights=use)
    m = torch.eye(4, dtype=torch.float32, device=p3.device)
    m[:3, :3] = r
    m[:3, 3] = t
    return m, s


SOLVERS = {
    "two_group": solve_pair_two_group,
    "stationary": solve_pair_stationary,
    "hybrid": solve_pair_hybrid,
}


def _triangulation_diagnostics(cur, cur_z, past, past_z, t_cur, t_past, k):
    """Forward-intersection residuals against an earlier frame: per track
    the ray angle, the range triangulated by the law of sines, and its
    residual against the measured depth's range (host numpy). -> a stats
    dict, or None (fewer than 3 common tracks, or no baseline)."""
    ok = (cur[:, 2] > 0) & (past[:, 2] > 0) & (cur_z > 1e-3) \
        & (past_z > 1e-3)
    if ok.sum() < 3:
        return None
    kk = np.asarray(k)

    def world_rays(pts, t_c2w):
        d = np.stack([(pts[:, 0] - kk[0, 2]) / kk[0, 0],
                      (pts[:, 1] - kk[1, 2]) / kk[1, 1],
                      np.ones(len(pts), np.float32)], axis=-1)
        nrm = np.linalg.norm(d, axis=-1, keepdims=True)
        return (d / nrm) @ t_c2w[:3, :3].T, nrm[:, 0]

    d1, n1 = world_rays(cur[ok, :2], t_cur)
    d2, _ = world_rays(past[ok, :2], t_past)
    baseline = t_past[:3, 3] - t_cur[:3, 3]
    bl = float(np.linalg.norm(baseline))
    if bl < 1e-6:
        return None
    bn = baseline / bl
    gamma = np.arccos(np.clip((d1 * d2).sum(-1), -1, 1))
    alpha = np.arccos(np.clip(d1 @ bn, -1, 1))
    beta = np.arccos(np.clip(-(d2 @ bn), -1, 1))
    tri_r1 = bl * np.sin(beta) / np.maximum(np.sin(alpha + beta), 1e-6)
    measured = cur_z[ok] * n1
    resid = np.abs(tri_r1 - measured)
    return {
        "n_common": int(ok.sum()),
        "baseline_m": bl,
        "median_ray_angle_deg": float(np.degrees(np.median(gamma))),
        "median_measured_range_m": float(np.median(measured)),
        "median_triangulated_range_m": float(np.median(tri_r1)),
        "median_residual_m": float(np.median(resid)),
    }


def _mask_tracks(frames, mask_video, w, h, strict):
    """Drop track points on masked (non-zero) pixels; ``strict`` drops a
    track touched by the mask once from every frame."""
    banned = set()
    masked = []
    with vio.VideoReader(mask_video) as mv:
        for fr in frames:
            m = mv.read_batch(1)
            if m is None:
                masked.append(fr)
                continue
            gray = m[0].astype(np.float32).mean(-1)
            keep = []
            for p in fr:
                x, y = int(p[1]), int(p[2])
                if x >= w or y >= h or gray[min(y, h - 1),
                                            min(x, w - 1)] > 0:
                    banned.add(int(p[0]))
                    continue
                keep.append(p)
            masked.append(np.asarray(keep, np.float32).reshape(-1, 3))
    if strict:
        masked = [np.asarray([p for p in fr if int(p[0]) not in banned],
                             np.float32).reshape(-1, 3) for fr in masked]
    return masked


def _draw_tracks(frame, track_rows, w, h):
    """The debug overlay's tracked points, green."""
    for _gid, x, y in np.asarray(track_rows).reshape(-1, 3):
        xi, yi = int(x), int(y)
        if 0 <= xi < w and 0 <= yi < h:
            frame[max(0, yi - 1):yi + 2, max(0, xi - 1):xi + 2] = (0, 255, 0)


def _draw_reprojection(frame, prev, prev_depth, transforms, k, w, h):
    """The debug overlay's previous-frame points through the solved
    relative pose, red."""
    ok = prev[:, 2] > 0
    z = prev_depth[np.clip(prev[ok, 1].astype(int), 0, h - 1),
                   np.clip(prev[ok, 0].astype(int), 0, w - 1)]
    p3 = geo.unproject_2d_points(torch.from_numpy(prev[ok, :2]),
                                 torch.from_numpy(z),
                                 torch.from_numpy(k)).numpy()
    m_rel = transforms[-1] @ np.linalg.inv(transforms[-2])
    p3w = p3 @ m_rel[:3, :3].T + m_rel[:3, 3]
    z = np.maximum(p3w[:, 2], 1e-6)
    us = (p3w[:, 0] * k[0, 0] / z + k[0, 2]).astype(int)
    vs = (p3w[:, 1] * k[1, 1] / z + k[1, 2]).astype(int)
    sel = (us >= 0) & (us < w) & (vs >= 0) & (vs < h)
    frame[vs[sel], us[sel]] = (255, 0, 0)


def align_video(depth_video, tracking_file, xfov=None, yfov=None,
                max_depth=100.0, solver="two_group", mask_video=None,
                strict_mask=False, max_frames=-1, output=None,
                max_tracks=4096, color_video=None, diagnostics=False,
                diag_gap=15, device=None, hybrid_samples=None):
    """Stream the depth frames, solve each consecutive pair on the device,
    chain the transforms into frame 0's space and write
    ``<depth_video>_transformations.json`` (or ``output``). A pair with
    fewer than 8 common tracks keeps the previous pose. ``color_video``
    writes the debug overlay ``<depth_video>_debug.mkv``;
    ``diagnostics`` the triangulation residuals against frame n -
    ``diag_gap`` to ``<output>_diagnostics.json``. ``hybrid_samples``:
    None, or a function of a pair's frame index and its (N,) float32
    validity returning the hybrid solver's (hypotheses, 3) indices.
    -> the output path"""
    device = resolve_device(device)
    frames = sidecar.load_tracking(tracking_file)
    solve = SOLVERS[solver]
    transforms = [np.eye(4, dtype=np.float32)]
    to_ref_zero = np.eye(4, dtype=np.float32)
    diag_hist = {}  # frame -> (dense row, sampled depths) for diag_gap
    diag_stats = []
    with contextlib.ExitStack() as stack:
        dv = stack.enter_context(vio.VideoReader(depth_video,
                                                 max_frames=max_frames))
        h, w = dv.height, dv.width
        k_np = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov,
                                          yfov_deg=yfov).numpy()
        k = torch.from_numpy(k_np).to(device)
        if mask_video:
            frames = _mask_tracks(frames, mask_video, w, h, strict_mask)
        dense, _ = sidecar.tracking_to_dense(frames, max_tracks=max_tracks)
        t_total = min(len(frames), dv.frame_count if max_frames < 0
                      else max_frames)
        cvr = dbg_writer = None
        if color_video:
            cvr = stack.enter_context(vio.VideoReader(
                color_video, max_frames=max_frames))
            dbg_writer = stack.enter_context(vio.VideoWriter(
                depth_video + "_debug.mkv", dv.fps, w, h))
        prev_depth = None
        fr_n = 0
        while fr_n < t_total:
            rgb = dv.read_batch(1)
            if rgb is None:
                break
            depth = codec.decode_depth_frame(
                torch.from_numpy(rgb[0]).to(device), max_depth,
                average_rg=True)
            if diagnostics:
                dh = depth.cpu().numpy()
                row = dense[fr_n]
                xi = np.clip(row[:, 0].astype(int), 0, w - 1)
                yi = np.clip(row[:, 1].astype(int), 0, h - 1)
                diag_hist[fr_n] = (row, dh[yi, xi].astype(np.float32))
                diag_hist.pop(fr_n - diag_gap - 1, None)
            if prev_depth is not None:
                cur = dense[fr_n]
                prev = dense[fr_n - 1]
                valid_np = cur[:, 2] * prev[:, 2]
                valid = torch.from_numpy(valid_np).to(device)
                args = (torch.from_numpy(cur[:, :2]).to(device),
                        torch.from_numpy(prev[:, :2]).to(device),
                        depth, prev_depth, k, valid)
                if solver == "hybrid":
                    samples = (None if hybrid_samples is None else
                               torch.as_tensor(np.asarray(hybrid_samples(
                                   fr_n, valid_np)), dtype=torch.int64))
                    out = solve(*args, samples=samples)
                else:
                    out = solve(*args)
                m = out[0] if isinstance(out, tuple) else out
                if float(valid_np.sum()) >= 8:
                    to_ref_zero = to_ref_zero @ m.cpu().numpy()
                transforms.append(to_ref_zero.copy())
                if diagnostics and (fr_n - diag_gap) in diag_hist:
                    past_row, past_z = diag_hist[fr_n - diag_gap]
                    cur_row, cur_z = diag_hist[fr_n]
                    st = _triangulation_diagnostics(
                        cur_row, cur_z, past_row, past_z,
                        transforms[fr_n], transforms[fr_n - diag_gap], k_np)
                    if st is not None:
                        st["frame"] = fr_n
                        diag_stats.append(st)
                        print(f"frame {fr_n}: tri-residual "
                              f"{st['median_residual_m']:.3f} m over "
                              f"{st['n_common']} tracks, ray angle "
                              f"{st['median_ray_angle_deg']:.2f} deg")
            if dbg_writer is not None:
                cb = cvr.read_batch(1)
                frame = (cb[0].copy() if cb is not None
                         else np.zeros((h, w, 3), np.uint8))
                _draw_tracks(frame, frames[fr_n], w, h)
                if prev_depth is not None:
                    _draw_reprojection(frame, dense[fr_n - 1],
                                       prev_depth.cpu().numpy(), transforms,
                                       k_np, w, h)
                dbg_writer.write(frame)
            prev_depth = depth
            fr_n += 1

    output = output or (depth_video + "_transformations.json")
    sidecar.save_transformations(output, np.asarray(transforms[:t_total]))
    if diagnostics:
        with open(output + "_diagnostics.json", "w") as f:
            json.dump(diag_stats, f)
        if diag_stats:
            med = float(np.median([s["median_residual_m"]
                                   for s in diag_stats]))
            print(f"triangulation diagnostics: {len(diag_stats)} frame "
                  f"pairs, overall median residual {med:.3f} m "
                  f"(saved {output}_diagnostics.json)")
    return output
