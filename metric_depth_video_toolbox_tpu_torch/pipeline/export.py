"""Depth video -> other formats (PyTorch port of ``pipeline/export.py``):
grayscale videos, per-frame point clouds and meshes, clouds triangulated
from tracks, and the depth video rescaled onto them.

  pass 1: per frame on the device, decode the depth, then the rays of
          every track through its pixel from the camera's origin
          (:func:`_frame_rays`), and for the per-frame PLY / OBJ the
          unprojected, edge-culled and transformed grid;
  pass 2: every track's rays intersected in one batched solve over a
          (tracks, frames) tensor (``ops/solvers.py::intersect_rays``) ->
          ``_triangulated.ply`` and ``_avgmonodepth.ply`` (normals from
          ``ops/knn.py`` with ``save_normals``);
  pass 3: the depth video rescaled so tracked points agree with their
          triangulated positions, per frame or by one global inverse-depth
          scale and shift -> ``_rescaled.mkv``.

Union-find merging, the rescale and the file writes stay numpy on the
host, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.io import pointcloud as pcio
from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.ops import codec
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def _frame_rays(depth, pts_2d, valid, k, transform):
    """One frame's tracks: the camera origin (3,), the world-space unit
    rays through each track's pixel (N, 3), the world points at the
    tracked depth (N, 3), that depth (N,) and whether the observation
    counts (N,): valid and deeper than 0.1 mm."""
    h, w = depth.shape
    yi = torch.clamp(torch.round(pts_2d[:, 1]).to(torch.int64), 0, h - 1)
    xi = torch.clamp(torch.round(pts_2d[:, 0]).to(torch.int64), 0, w - 1)
    z = depth[yi, xi]
    p3 = geo.unproject_2d_points(pts_2d, z, k)
    world = geo.transform_points(p3[None], transform)[0]
    origin = transform[:3, 3]
    rays = world - origin
    rays = rays / (torch.linalg.norm(rays, dim=-1, keepdim=True) + 1e-12)
    ok = valid * (z > 1e-4)
    return origin, rays, world, z, ok


def export_video(depth_video, tracking_file=None, transformation_file=None,
                 color_video=None, xfov=None, yfov=None, max_depth=100.0,
                 max_frames=-1, save_ply_every=0, save_obj_every=0,
                 min_observations=10, triangulate=False,
                 save_rescaled_depth=False, global_align=False,
                 grayscale=False, bit16_grayscale=False,
                 remove_edges=True, output_prefix=None, max_tracks=8192,
                 min_frames=-1, lock_frame=0, mask_video=None,
                 strict_mask=False, merge_close_points=False,
                 ply_dir=None, obj_dir=None, save_normals=False,
                 device=None):
    """Multi-purpose exporter on ``device`` (CUDA unless the caller asks
    for the CPU). Returns a dict of the paths written.

    As in the JAX package: without ``xfov`` and ``yfov`` the camera has a
    50 degree horizontal FOV; ``lock_frame`` 0 leaves the poses as they
    are; ``min_frames`` m skips frames 0..m."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.ops import rasterize

    device = resolve_device(device)
    out = {}
    prefix = output_prefix or depth_video
    dv = vio.VideoReader(depth_video, max_frames=max_frames)
    cv = vio.VideoReader(color_video) if color_video else None
    h, w = dv.height, dv.width
    if xfov or yfov:
        k = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov, yfov_deg=yfov)
    else:
        k = geo.camera_matrix_from_fov(w, h, xfov_deg=50.0)
    k = k.to(device)

    transforms = None
    if transformation_file:
        transforms = sidecar.load_transformations(transformation_file)
        if lock_frame:
            # re-base every pose on the lock frame
            inv_lock = np.linalg.inv(transforms[lock_frame])
            transforms = [t @ inv_lock for t in transforms]

    dense = None
    if tracking_file:
        dense, _ = sidecar.tracking_to_dense(
            sidecar.load_tracking(tracking_file), max_tracks=max_tracks)
        if mask_video:
            dense = _mask_filter_tracks(dense, mask_video, strict_mask)

    # per observed frame: camera origin, rays, world points, validity
    track_origins, track_rays, track_world, track_valid = [], [], [], []
    all_depths = []          # kept only for the rescale's pass
    depth_frame_ids = []     # their absolute frame numbers
    gray_written = 0

    gray_writer = None
    if grayscale:
        gpath = prefix + ("_grayscale16.mkv" if bit16_grayscale
                          else "_grayscale.mkv")
        gray_writer = vio.VideoWriter(gpath, dv.fps, w, h)
        out["grayscale"] = gpath

    fr_n = 0
    while True:
        rgb = dv.read_batch(1)
        if rgb is None:
            break
        if min_frames != -1 and min_frames >= fr_n:
            if cv is not None:
                cv.read_batch(1)
            fr_n += 1
            continue
        depth = codec.decode_depth_frame(
            torch.from_numpy(rgb[0]).to(device), max_depth, average_rg=True)
        col = None
        if cv is not None:
            cb = cv.read_batch(1)
            col = cb[0] if cb is not None else None
        m = (torch.as_tensor(np.asarray(transforms[fr_n], np.float32),
                             device=device)
             if transforms is not None
             else torch.eye(4, dtype=torch.float32, device=device))

        if dense is not None and fr_n < dense.shape[0]:
            tr = torch.from_numpy(dense[fr_n]).to(device)
            origin, rays, world, _, ok = [
                v.cpu().numpy() for v in _frame_rays(depth, tr[:, :2],
                                                     tr[:, 2], k, m)]
            track_origins.append(origin)
            track_rays.append(rays)
            track_world.append(world)
            track_valid.append(ok)

        if ply_dir is not None or (save_ply_every
                                   and fr_n % save_ply_every == 0):
            pts = geo.transform_depth_map(geo.unproject_depth(depth, k), m)
            ppath = (os.path.join(ply_dir, f"{fr_n:06d}.ply")
                     if ply_dir is not None
                     else f"{prefix}_frame{fr_n:06d}.ply")
            pcio.write_ply(ppath, pts.reshape(-1, 3).cpu().numpy(),
                           col.reshape(-1, 3) if col is not None else None)
            out.setdefault("ply_frames", []).append(ppath)
        if obj_dir is not None or (save_obj_every
                                   and fr_n % save_obj_every == 0):
            pts3 = geo.unproject_depth(depth, k, of_by_one=True)
            keep = (~rasterize.cell_edge_mask(pts3)).cpu().numpy() \
                if remove_edges else None
            world_pts = geo.transform_depth_map(pts3, m).cpu().numpy()
            opath = (os.path.join(obj_dir, f"{fr_n:06d}.obj")
                     if obj_dir is not None
                     else f"{prefix}_frame{fr_n:06d}.obj")
            pcio.write_obj(opath, world_pts.reshape(-1, 3),
                           pcio.grid_mesh_faces(h, w, keep=keep),
                           col.reshape(-1, 3) / 255.0
                           if col is not None else None)
            out.setdefault("obj_frames", []).append(opath)

        if gray_writer is not None:
            d = depth.cpu().numpy()
            if bit16_grayscale:
                g16 = np.clip(d / max_depth * 65535.0, 0,
                              65535).astype(np.uint16)
                g8 = (g16 >> 8).astype(np.uint8)
            else:
                g8 = np.clip(d / max_depth * 255.0, 0, 255).astype(np.uint8)
            gray_writer.write(np.stack([g8, g8, g8], axis=-1))
            gray_written += 1

        if save_rescaled_depth:
            all_depths.append(depth.cpu().numpy())
            depth_frame_ids.append(fr_n)
        fr_n += 1

    dv.close()
    if cv is not None:
        cv.close()
    if gray_writer is not None:
        gray_writer.commit(gray_written)

    if triangulate and dense is not None and track_origins:
        t_frames = len(track_origins)
        n_tracks = dense.shape[1]
        origins = np.broadcast_to(np.stack(track_origins)[:, None, :],
                                  (t_frames, n_tracks, 3))
        rays = np.stack(track_rays)          # (T, N, 3)
        valid = np.stack(track_valid)        # (T, N)
        world = np.stack(track_world)        # (T, N, 3)
        good = valid.sum(0) >= min_observations

        # every track's rays at once, (N, T, ...)
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(
                a.swapaxes(0, 1))).to(device)
        tri = solvers.intersect_rays(dev(origins), dev(rays),
                                     valid=dev(valid)).cpu().numpy()
        tri_points = tri[good]
        avg_mono = ((world * valid[..., None]).sum(0)
                    / np.maximum(valid.sum(0), 1)[:, None])

        tri_path = prefix + "_triangulated.ply"
        avg_path = prefix + "_avgmonodepth.ply"
        avg_out = avg_mono[good]
        if merge_close_points:
            tri_points, _ = merge_near_points(tri_points)
            avg_out, _ = merge_near_points(avg_out)

        def cloud_normals(pts):
            # KNN-covariance normals (ops/knn.py), flipped toward the
            # first camera's center
            if not save_normals or pts.shape[0] < 8:
                return None
            from metric_depth_video_toolbox_tpu_torch.ops import knn
            c0 = (np.asarray(transforms[0])[:3, 3]
                  if transforms is not None else np.zeros(3, np.float32))
            vd = pts - c0[None]
            vd = vd / np.maximum(np.linalg.norm(vd, axis=1, keepdims=True),
                                 1e-9)
            return knn.knn_normals(
                torch.as_tensor(pts, dtype=torch.float32, device=device),
                k=min(16, pts.shape[0] - 1),
                view_dirs=torch.as_tensor(vd, dtype=torch.float32,
                                          device=device)).cpu().numpy()

        pcio.write_ply(tri_path, tri_points,
                       normals=cloud_normals(tri_points))
        pcio.write_ply(avg_path, avg_out, normals=cloud_normals(avg_out))
        out["triangulated"] = tri_path
        out["avgmonodepth"] = avg_path

        if save_rescaled_depth and all_depths:
            out["rescaled"] = _rescale_depth_video(
                prefix, all_depths, dense, tri, good, transforms, max_depth,
                dv.fps, global_align, frame_ids=depth_frame_ids)
    return out


def _rescale_depth_video(prefix, depths, dense, tri_points, good, transforms,
                         max_depth, fps, global_align, frame_ids=None):
    """Pass 3: the mono depth video rescaled so tracked points agree with
    their triangulated positions, by a mean ratio per frame or by one
    global inverse-depth scale and shift. -> the ``_rescaled.mkv`` path"""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    t_frames = len(depths)
    path = prefix + "_rescaled.mkv"
    h, w = depths[0].shape

    # per frame: each triangulated track's z in that frame's camera
    # against the mono depth at its pixel
    scales = np.ones(t_frames, np.float32)
    ratios_all = []
    for fi in range(t_frames):
        abs_fi = frame_ids[fi] if frame_ids is not None else fi
        m = transforms[abs_fi] if transforms is not None else np.eye(4)
        w2c = np.linalg.inv(m)
        pts_cam = tri_points[good] @ w2c[:3, :3].T + w2c[:3, 3]
        tr = dense[abs_fi][good]
        ok = tr[:, 2] > 0
        if ok.sum() < 4:
            ratios_all.append(None)
            continue
        xi = np.clip(np.round(tr[ok, 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(tr[ok, 1]).astype(int), 0, h - 1)
        mono_z = depths[fi][yi, xi]
        ref_z = pts_cam[ok][:, 2]
        sel = (mono_z > 1e-3) & (ref_z > 1e-3)
        if sel.sum() < 4:
            ratios_all.append(None)
            continue
        ratios_all.append((ref_z[sel], mono_z[sel]))
        scales[fi] = float(np.mean(ref_z[sel] / mono_z[sel]))

    if global_align:
        pairs = [r for r in ratios_all if r is not None]
        refs = np.concatenate([p[0] for p in pairs])
        monos = np.concatenate([p[1] for p in pairs])
        s, t = solvers.scale_and_shift(
            torch.from_numpy(1.0 / np.maximum(monos, 1e-3)),
            torch.from_numpy(1.0 / np.maximum(refs, 1e-3)))
        s, t = float(s), float(t)
        frames_out = [1.0 / np.maximum(
            (1.0 / np.maximum(d, 1e-3)) * s + t, 1e-6) for d in depths]
    else:
        frames_out = [d * scales[i] for i, d in enumerate(depths)]

    vio.save_depth_video(np.stack(frames_out), path, fps, max_depth)
    return path


# the turntable's colours of point sets that have none
_FALLBACK_COLORS = np.asarray([[220, 90, 60], [60, 140, 220], [90, 200, 90]],
                              np.float32)


def render_point_cloud_video(point_sets, path, fps=24, out_hw=(480, 640),
                             xfov=60.0, n_frames=72, radius=1, device=None):
    """A turntable video of point clouds (``--show_scene_point_clouds``):
    ``n_frames`` views orbiting the clouds' median, splatted with
    ``ops/rasterize.py::splat_points``. Each set is (points, colors or
    None); sets without colors get distinct fallback colors. -> path"""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.ops import rasterize

    device = resolve_device(device)
    pts_all, col_all = [], []
    for i, (pts, cols) in enumerate(point_sets):
        pts = np.asarray(pts, np.float32)
        if cols is None:
            cols = np.broadcast_to(
                _FALLBACK_COLORS[i % len(_FALLBACK_COLORS)], pts.shape)
        pts_all.append(pts)
        col_all.append(np.asarray(cols, np.float32))
    pts = np.concatenate(pts_all)
    cols = np.concatenate(col_all)
    center = np.median(pts, axis=0)
    rad = float(np.percentile(np.linalg.norm(pts - center, axis=1), 90))
    rad = max(rad, 1e-3) * 2.2
    k = geo.camera_matrix_from_fov(out_hw[1], out_hw[0],
                                   xfov_deg=xfov).to(device)[None]
    pts_dev = torch.from_numpy(pts).to(device)
    cols_dev = torch.from_numpy(cols).to(device)[None]

    wr = vio.VideoWriter(path, fps, out_hw[1], out_hw[0])
    for fi in range(n_frames):
        ang = 2 * np.pi * fi / n_frames
        eye = center + rad * np.asarray(
            [np.sin(ang), -0.25, np.cos(ang)], np.float32)
        z = center - eye
        z = z / np.linalg.norm(z)
        x = np.cross(np.asarray([0, 1, 0], np.float32), z)
        x = x / (np.linalg.norm(x) + 1e-9)
        y = np.cross(z, x)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.stack([x, y, z])
        w2c[:3, 3] = -w2c[:3, :3] @ eye
        w2c = torch.from_numpy(w2c).to(device)
        cam = pts_dev @ w2c[:3, :3].T + w2c[:3, 3]
        img, _, mask = rasterize.splat_points(cam[None], cols_dev, k, out_hw,
                                              radius=radius)
        img = torch.where(mask[0, ..., None], img[0], 16.0)
        wr.write(torch.clamp(img, 0, 255).to(torch.uint8).cpu().numpy())
    wr.commit(n_frames)
    return path


def _mask_filter_tracks(dense, mask_video, strict):
    """Track observations that land on a masked pixel (or outside the
    frame) are dropped; ``strict`` drops a track wholly once any of its
    observations was."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    dense = dense.copy()
    mv = vio.VideoReader(mask_video)
    ever_masked = np.zeros(dense.shape[1], bool)
    h, w = mv.height, mv.width
    for fi in range(dense.shape[0]):
        mb = mv.read_batch(1)
        if mb is None:
            print("WARNING: mask video ended before other videos")
            break
        mask = mb[0][..., 0]
        tr = dense[fi]
        ok = tr[:, 2] > 0
        xi = np.clip(np.round(tr[:, 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(tr[:, 1]).astype(int), 0, h - 1)
        oob = (tr[:, 0] >= w) | (tr[:, 1] >= h)
        hit = ok & (oob | (mask[yi, xi] > 0))
        dense[fi][hit, 2] = 0.0
        ever_masked |= hit
    mv.close()
    if strict:
        dense[:, ever_masked, 2] = 0.0
    return dense


def merge_near_points(points, colors=None, radius=0.003):
    """Points sharing a ``radius`` voxel merged into their mean (and
    their colors' mean). -> (points, colors or None)"""
    pts = np.asarray(points, np.float32)
    keys = np.floor(pts / radius).astype(np.int64)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    n_cells = inverse.max() + 1
    sums = np.zeros((n_cells, 3), np.float64)
    counts = np.zeros(n_cells, np.int64)
    np.add.at(sums, inverse, pts)
    np.add.at(counts, inverse, 1)
    merged = (sums / counts[:, None]).astype(np.float32)
    if colors is None:
        return merged, None
    cols = np.asarray(colors, np.float64)
    csum = np.zeros((n_cells, cols.shape[1]), np.float64)
    np.add.at(csum, inverse, cols)
    return merged, (csum / counts[:, None]).astype(colors.dtype)


def export_camera_track(transformations, xfov, width, height, fps,
                        output_base, points=None, colors=None):
    """The camera track for DCC tools: ``<output_base>_camera_track.json``
    (per frame a Blender-convention 4x4, the FOV and fps), the cloud as
    ``_cloud.ply``, and with ``bpy`` importable an Alembic file. -> dict
    of the paths written"""
    import json

    transformations = np.asarray(transformations, np.float32)
    # OpenCV camera (x right, y down, z forward) -> Blender (z up), the
    # camera looking down -Z
    cv2blender = np.array([[1, 0, 0, 0],
                           [0, 0, 1, 0],
                           [0, -1, 0, 0],
                           [0, 0, 0, 1]], np.float32)
    camflip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    blender_mats = np.einsum("ij,njk,kl->nil", cv2blender, transformations,
                             camflip)

    try:
        import bpy  # noqa: F401
        has_bpy = True
    except ImportError:
        has_bpy = False

    outputs = {}
    if has_bpy:  # pragma: no cover - bpy is not installed here
        abc_path = output_base + ".abc"
        _bpy_export_alembic(blender_mats, xfov, fps, abc_path, points)
        outputs["alembic"] = abc_path
    track_path = output_base + "_camera_track.json"
    with open(track_path, "w", encoding="utf-8") as f:
        json.dump({
            "fps": fps, "width": width, "height": height,
            "xfov_deg": float(xfov),
            "convention": "blender (x right, z up, camera looks -Z)",
            "frames": [m.tolist() for m in blender_mats],
        }, f)
    outputs["camera_track"] = track_path
    if points is not None:
        cloud_path = output_base + "_cloud.ply"
        pcio.write_ply(cloud_path, points, colors)
        outputs["cloud"] = cloud_path
    return outputs


def _bpy_export_alembic(mats, xfov, fps, path, points):  # pragma: no cover
    """The Alembic export inside Blender (only where ``bpy`` imports)."""
    import math

    import bpy
    bpy.ops.wm.read_factory_settings(use_empty=True)
    cam_data = bpy.data.cameras.new("mdvt_cam")
    cam_data.angle = math.radians(float(xfov))
    cam = bpy.data.objects.new("mdvt_cam", cam_data)
    bpy.context.collection.objects.link(cam)
    scene = bpy.context.scene
    scene.render.fps = int(round(fps))
    scene.frame_start = 1
    scene.frame_end = len(mats)
    for i, m in enumerate(mats, start=1):
        cam.matrix_world = [list(r) for r in m]
        cam.keyframe_insert(data_path="location", frame=i)
        cam.keyframe_insert(data_path="rotation_euler", frame=i)
    if points is not None:
        mesh = bpy.data.meshes.new("mdvt_cloud")
        mesh.from_pydata([tuple(p) for p in np.asarray(points)], [], [])
        obj = bpy.data.objects.new("mdvt_cloud", mesh)
        bpy.context.collection.objects.link(obj)
    bpy.ops.wm.alembic_export(filepath=path, selected=False)
    bpy.ops.wm.save_as_mainfile(filepath=path + ".blend")
