"""Analysis of tracks and depth (PyTorch port of ``pipeline/analyse.py``).

- :func:`detect_cuts_from_tracking`: scene cuts from a walk over the
  track-connectivity graph (a host walk, as in the JAX package).
- :func:`analyse_depth_movement`: every track reprojected into the first
  frame's camera, its mean 2D step z-scored, and a point cloud written
  with the moving tracks red: it flags moving objects and tracking
  failures. Depth decodes on the host (``io/native.py``, R and G
  averaged, as in the JAX package); the unprojection runs on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.io import native as io_native
from metric_depth_video_toolbox_tpu_torch.io import pointcloud as pcio
from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def detect_cuts_from_tracking(tracking_file, fps=24.0, low=100, high=500,
                              min_start_s=27.0):
    """Greedy walk from frame 0 to the unvisited frame sharing most
    tracks; a cut starts where the best match shares fewer than ``low``
    tracks (after ``min_start_s`` seconds) and ends where it shares more
    than ``high``. -> [(frame, 'cut_start' | 'cut_end'), ...]"""
    frames = sidecar.load_tracking(tracking_file)
    id_sets = [set(int(p[0]) for p in fr) for fr in frames]
    n = len(frames)
    used = np.zeros(n, bool)
    frame_n = 0
    used[0] = True
    events = []
    cut = False
    while used.sum() < n:
        ids = id_sets[frame_n]
        best, best_common = -1, -1
        for j in range(n):
            if used[j]:
                continue
            common = len(ids & id_sets[j])
            if common > best_common:
                best, best_common = j, common
        if best < 0:
            break
        if not cut and best_common < low and frame_n > min_start_s * fps:
            events.append((frame_n, "cut_start"))
            cut = True
        elif cut and best_common > high:
            events.append((frame_n, "cut_end"))
            cut = False
        frame_n = best
        used[best] = True
    return events


def analyse_depth_movement(depth_video, tracking_file,
                           transformation_file=None, xfov=None, yfov=None,
                           max_depth=100.0, max_frames=-1, output=None,
                           z_threshold=2.0, mask_video=None, device=None):
    """Tracks whose mean reprojected 2D step has a z-score (numpy's
    ``std``, + 1e-9) above ``z_threshold`` are moving. Writes a PLY of
    each track's first world point, red if moving, else gray. -> (PLY
    path, moving track ids)

    ``mask_video``: observations on white (> 127) pixels are dropped.
    Without ``xfov`` and ``yfov`` the camera has a 50 degree FOV."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    device = resolve_device(device)
    dense, ids = sidecar.tracking_to_dense(sidecar.load_tracking(
        tracking_file))
    t = dense.shape[0]
    if xfov is None and yfov is None:
        xfov = 50.0
    if mask_video is not None:
        mv = vio.VideoReader(mask_video, max_frames=max_frames)
        for fi in range(min(t, mv.frame_count)):
            m = mv.read_batch(1)
            if m is None:
                break
            gray = m[0][..., 0]
            xi = np.clip(np.round(dense[fi, :, 0]).astype(int), 0,
                         gray.shape[1] - 1)
            yi = np.clip(np.round(dense[fi, :, 1]).astype(int), 0,
                         gray.shape[0] - 1)
            dense[fi, :, 2] = np.where(gray[yi, xi] > 127, 0.0,
                                       dense[fi, :, 2])
        mv.close()

    dv = vio.VideoReader(depth_video, max_frames=max_frames)
    h, w = dv.height, dv.width
    k_dev = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov,
                                       yfov_deg=yfov).to(device)
    k = k_dev.cpu().numpy()
    transforms = (sidecar.load_transformations(transformation_file)
                  if transformation_file else
                  np.tile(np.eye(4, dtype=np.float32), (t, 1, 1)))
    m0 = np.linalg.inv(transforms[0])

    first_world = {}
    paths = np.zeros(dense.shape[1], np.float64)
    counts = np.zeros(dense.shape[1], np.int64)
    prev_proj = {}

    fr = 0
    while fr < t:
        rgb = dv.read_batch(1)
        if rgb is None:
            break
        depth = io_native.decode_rgb_depth(rgb[0], max_depth,
                                           average_rg=True)
        tr = dense[fr]
        ok = tr[:, 2] > 0
        xi = np.clip(np.round(tr[ok, 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(tr[ok, 1]).astype(int), 0, h - 1)
        z = depth[yi, xi]
        pts3 = geo.unproject_2d_points(
            torch.from_numpy(np.ascontiguousarray(tr[ok, :2])).to(device),
            torch.from_numpy(z).to(device), k_dev).cpu().numpy()
        m = transforms[min(fr, len(transforms) - 1)]
        world = pts3 @ m[:3, :3].T + m[:3, 3]
        for local_i, track_i in enumerate(np.where(ok)[0]):
            if track_i not in first_world:
                first_world[track_i] = world[local_i]
            # the world point in the first frame's camera
            pc = world[local_i] @ m0[:3, :3].T + m0[:3, 3]
            if pc[2] <= 1e-6:
                continue
            uv = np.array([pc[0] / pc[2] * k[0, 0] + k[0, 2],
                           pc[1] / pc[2] * k[1, 1] + k[1, 2]])
            if track_i in prev_proj:
                paths[track_i] += np.linalg.norm(uv - prev_proj[track_i])
                counts[track_i] += 1
            prev_proj[track_i] = uv
        fr += 1
    dv.close()

    seen = counts > 0
    norm_paths = np.zeros_like(paths)
    norm_paths[seen] = paths[seen] / counts[seen]
    mu = norm_paths[seen].mean() if seen.any() else 0.0
    sd = norm_paths[seen].std() + 1e-9
    zscores = (norm_paths - mu) / sd
    moving = (zscores > z_threshold) & seen

    idx = np.asarray([i for i in range(dense.shape[1]) if i in first_world],
                     np.int64)
    pts = np.asarray([first_world[i] for i in idx], np.float32)
    colors = np.where(moving[idx][:, None],
                      np.array([[255, 40, 40]], np.uint8),
                      np.array([[128, 128, 128]], np.uint8)).astype(np.uint8)
    output = output or (depth_video + "_movement.ply")
    if pts.size:
        pcio.write_ply(output, pts, colors)
    return output, ids[idx[moving[idx]]].tolist()
