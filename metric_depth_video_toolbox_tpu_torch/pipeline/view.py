"""Novel-view rendering of depth videos (PyTorch port of
``pipeline/view.py``): every frame re-rendered from a free camera
(position, optional look-at target) through the forward-warp z-buffer,
or splatted as points, into ``<depth_video>_render.mkv``."""

from __future__ import annotations

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.io import pointcloud as pcio
from metric_depth_video_toolbox_tpu_torch.ops import codec
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.ops import rasterize
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def view_camera(camera_pos, look_at_target=None):
    """The render camera's view (4, 4) float32 numpy: a look-at from
    ``camera_pos`` to the target with up -Y, flipped from GL (looking
    down -Z) to CV (looking down +Z); else a translation by -camera_pos."""
    eye = np.asarray(camera_pos, np.float32)
    if look_at_target is None:
        cam = np.eye(4, dtype=np.float32)
        cam[:3, 3] = -eye
        return cam
    view = geo.look_at(torch.from_numpy(eye),
                       torch.as_tensor(np.asarray(look_at_target,
                                                  np.float32)),
                       torch.tensor([0.0, -1.0, 0.0])).numpy()
    flip = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    return flip @ view


def render_novel_view_video(depth_video, color_video=None, output=None,
                            xfov=50.0, yfov=None, max_depth=100.0,
                            camera_pos=(0, 0, 0), look_at_target=None,
                            transformations=None, mask_video=None,
                            invert_mask=False, background_ply=None,
                            as_pointcloud=False, max_frames=-1,
                            batch_size=8, remove_edges=False,
                            show_camera=False, draw_frame=-1,
                            compressed=False, transformation_lock_frame=0,
                            device=None):
    """Render every frame (or only ``draw_frame``) from a free camera on
    ``device`` (CUDA unless the caller asks for the CPU). Returns the
    output path.

    As in the JAX package, ``background_ply`` is read and not drawn, and
    ``remove_edges`` is accepted and not used: the surface render always
    culls edges."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    del remove_edges
    device = resolve_device(device)
    dv = vio.VideoReader(depth_video, max_frames=max_frames)
    cv = vio.VideoReader(color_video) if color_video else None
    mv = vio.VideoReader(mask_video) if mask_video else None
    h, w = dv.height, dv.width
    k = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov, yfov_deg=yfov)

    if transformations is not None and transformation_lock_frame != 0:
        tf = np.asarray(transformations, np.float32)
        transformations = tf @ np.linalg.inv(tf[transformation_lock_frame])
    cam = view_camera(camera_pos, look_at_target)
    if background_ply:
        pcio.read_ply(background_ply)
    k_dev = k.to(device)
    cam_dev = torch.as_tensor(cam, device=device)

    def step(depth_rgb, color, transform):
        b = depth_rgb.shape[0]
        depth = codec.decode_depth_frame(depth_rgb, max_depth)
        colf = color.to(torch.float32) / 255.0
        m = cam_dev @ transform
        kb = k_dev.expand(b, 3, 3)
        if as_pointcloud:
            pts = geo.transform_depth_map(geo.unproject_depth(depth, kb), m)
            img, dep, _ = rasterize.splat_points(
                pts.reshape(b, -1, 3), colf.reshape(b, -1, 3), kb, (h, w))
        else:
            res = rasterize.forward_warp(depth, colf, kb, kb, m, (h, w),
                                         subsample=2, remove_edges=True)
            img, dep = res.color, res.depth
        return torch.clamp(img * 255, 0, 255).to(torch.uint8), dep

    output = output or (depth_video + "_render.mkv")
    writer = vio.VideoWriter(output, dv.fps, w, h,
                             codec_fourcc="mp4v" if compressed else "FFV1")
    n = 0
    src_frame_n = 0
    try:
        while True:
            rgb = dv.read_batch(batch_size)
            if rgb is None:
                break
            b = rgb.shape[0]
            color = cv.read_batch(b) if cv is not None else rgb
            if color is None:
                break
            if mv is not None:
                m = mv.read_batch(b)
                if m is not None:
                    sel = m.mean(-1) > 128
                    if invert_mask:
                        sel = ~sel
                    color = np.where(sel[..., None], color, 0).astype(
                        np.uint8)
            tfs = (np.asarray(transformations[src_frame_n:src_frame_n + b],
                              np.float32)
                   if transformations is not None
                   else np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)))
            if draw_frame >= 0 and not (
                    src_frame_n <= draw_frame < src_frame_n + b):
                src_frame_n += b
                continue
            imgs, deps = step(torch.as_tensor(rgb, device=device),
                              torch.as_tensor(color, device=device),
                              torch.as_tensor(tfs, device=device))
            imgs = imgs.cpu().numpy()
            far = deps.amax((1, 2)).cpu().numpy()
            for i in range(b):
                if draw_frame >= 0 and src_frame_n + i != draw_frame:
                    continue
                frame = imgs[i]
                if show_camera:
                    frame = _draw_camera_frustum(frame.copy(), k, cam,
                                                 tfs[i], far=float(far[i]))
                writer.write(frame)
                n += 1
            src_frame_n += b
    finally:
        dv.close()
        if cv is not None:
            cv.close()
        if mv is not None:
            mv.close()
    writer.commit(n)
    return output


def _draw_camera_frustum(frame, k, view_cam, transform, far=10.0):
    """Draw the source camera's frustum (near plane at 2% of ``far``,
    clipped to 0.5..1e4 m) into the render as 12 line segments of 64
    points each, on the host."""
    kn = np.asarray(k)
    h, w = frame.shape[:2]
    far = float(np.clip(far, 0.5, 1e4))
    corners = geo.frustum_corners(
        torch.as_tensor(kn), w, h, near=far * 0.02, far=far,
        cam_to_world=torch.as_tensor(np.asarray(transform))).numpy()
    cam = np.asarray(view_cam)
    pts = corners @ cam[:3, :3].T + cam[:3, 3]
    z = np.maximum(pts[:, 2], 1e-6)
    uv = (pts[:, :2] * np.asarray([kn[0, 0], kn[1, 1]]) / z[:, None]
          + np.asarray([kn[0, 2], kn[1, 2]]))
    edges = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    for a, b in edges:
        if pts[a, 2] <= 1e-6 or pts[b, 2] <= 1e-6:
            continue
        for t in np.linspace(0.0, 1.0, 64):
            x = int(round(uv[a, 0] * (1 - t) + uv[b, 0] * t))
            y = int(round(uv[a, 1] * (1 - t) + uv[b, 1] * t))
            if 0 <= x < w and 0 <= y < h:
                frame[y, x] = (255, 60, 60)
    return frame
