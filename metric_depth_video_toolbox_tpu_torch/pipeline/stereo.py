"""Stereo re-renderer: depth + color video -> side-by-side 3D video
(PyTorch port of the sweep path of ``pipeline/stereo.py``).

One step renders both eyes of a batch of frames as one batch of
frames x eyes: decode depth -> master-FOV scale -> edge cull -> per-eye
disparity sweep (main surface, then the edge-anchor layer; or both in one
fused sweep) -> infill-mask normals (border defaults + diffusion inpaint +
masked blur) -> SBS u8.
Host <-> device traffic is uint8 in, uint8 out.

Output naming matches the JAX package: ``<depth_video>_stereo.mkv`` and
``<depth_video>_stereo.mkv_infillmask.mkv``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.ops import codec
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.ops import image as im
from metric_depth_video_toolbox_tpu_torch.ops import infill as infill_ops
from metric_depth_video_toolbox_tpu_torch.ops import rasterize
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Configuration of the stereo renderer: the JAX package's fields for
    the sweep path at the source size (its Touchly/VR180 outputs and
    other warps are not ported yet)."""
    width: int
    height: int
    max_depth: float = 100.0
    pupillary_distance_m: float = 0.063
    remove_edges: bool = True
    place_edge_points: bool = True
    make_infill_mask: bool = False
    green_and_black_infill_mask: bool = False
    # fill the holes with the normal-march infill before the SBS output
    do_basic_infill: bool = False
    inpaint_iters: int = 48
    num_planes: int = 128
    has_convergence: bool = True
    # 'shift' = horizontal image translation folded into the plane
    # disparities; 'rotate' = exact toe-in through a rotation resample
    convergence_mode: str = "shift"
    # render the main surface and the edge-anchor layer in one fused sweep
    # (rasterize.stereo_sweep_warp_dual, anchors over the full plane set)
    # instead of a second anchor-only sweep at num_planes // 4
    fused_anchor_sweep: bool = False


def _border_default_normals(mask_img, hole):
    """Screen-edge holes get inward-pointing default normals (encoded
    (n+1)/2) so infill pulls from inside the frame. (N, H, W, 3)."""
    h, w = hole.shape[-2:]
    dev = hole.device
    col = torch.arange(w, device=dev)[None, :]
    row = torch.arange(h, device=dev)[:, None]

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    out = mask_img
    for where, n in (((col == 0) & hole, vec([1.0, 0.5, 0.5])),
                     ((col == w - 1) & hole, vec([0.0, 0.5, 0.5])),
                     ((row == 0) & hole, vec([0.5, 0.5, 0.0])),
                     ((row == h - 1) & hole, vec([0.5, 0.5, 1.0]))):
        out = torch.where(where[..., None], n, out)
    return out


def _normalized(n):
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-8)


def render_eye(depth, color, k, transform, eye_shift_m, conv_angle,
               cfg: StereoConfig, shared=None):
    """Render a batch of eyes (N = frames x eyes): the JAX package's
    ``render_eye`` on the sweep path, batched.

    depth (N, H, W); color (N, H, W, 3) in [0, 1]; k (N, 3, 3); transform
    (N, 4, 4) camera-motion cancel; eye_shift_m, conv_angle (N,).
    ``shared``: optional (edge_mask, normals), both eye-invariant.
    Returns (image f32 [0,1], depth, infill-mask normals image, hole).
    """
    edge_pre, normals_pre = shared if shared is not None else (None, None)
    dev = depth.device
    sign = torch.where(eye_shift_m < 0, -1.0, 1.0)
    shift = geo.translation_matrix(-eye_shift_m, 0.0, 0.0)
    m_eye = shift @ geo.rotation_y(sign * conv_angle) @ transform

    rotate_conv = cfg.has_convergence and cfg.convergence_mode == "rotate"
    half_ipd = cfg.pupillary_distance_m / 2.0
    conv_inv_z = torch.tan(conv_angle) / half_ipd
    m_sweep = m_eye if rotate_conv else shift
    sweep_conv = 0.0 if rotate_conv else conv_inv_z

    anchors = cfg.place_edge_points and cfg.remove_edges
    fused = cfg.fused_anchor_sweep and anchors
    if anchors:
        normals = normals_pre if normals_pre is not None \
            else geo.normals_from_depth(depth, k)
        normals_enc = (torch.einsum("nij,nhwj->nhwi", m_eye[:, :3, :3],
                                    normals) + 1.0) / 2.0
    if fused:
        res, a_color, a_extra, a_found = rasterize.stereo_sweep_warp_dual(
            depth, color, normals_enc, k, m_sweep, num_planes=cfg.num_planes,
            neutralize_rotation=rotate_conv, conv_inv_z=sweep_conv,
            edge=edge_pre)
    else:
        res = rasterize.stereo_sweep_warp(
            depth, color, k, m_sweep, num_planes=cfg.num_planes,
            remove_edges=cfg.remove_edges, neutralize_rotation=rotate_conv,
            conv_inv_z=sweep_conv, edge=edge_pre)
    hole = ~res.mask
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    image = torch.where(hole[..., None], zero, res.color)
    green = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    mask_img = torch.where(hole[..., None], green, zero)

    if anchors:
        # edge anchors: the culled silhouette pixels re-rendered into the
        # holes, carrying color + encoded normals: out of the fused sweep,
        # or from a second sweep of the edge-only depth at num_planes//4
        if not fused:
            eres = rasterize.stereo_sweep_warp(
                torch.where(res.edge_mask, depth, zero),
                torch.cat([color, normals_enc], dim=-1), k, m_sweep,
                num_planes=max(cfg.num_planes // 4, 8), remove_edges=False,
                neutralize_rotation=rotate_conv, conv_inv_z=sweep_conv)
            a_color, a_extra = eres.color[..., :3], eres.color[..., 3:]
            a_found = eres.mask
        write = (a_found & hole)[..., None]
        image = torch.where(write, a_color, image)
        if not cfg.green_and_black_infill_mask:
            a_n = _normalized(a_extra * 2.0 - 1.0)
            mask_img = torch.where(write, (a_n + 1.0) / 2.0, mask_img)

    if ((cfg.make_infill_mask or cfg.do_basic_infill)
            and not cfg.green_and_black_infill_mask):
        mask_img = _border_default_normals(mask_img, hole)
        # pixels still green (no anchor or border normal) or black get
        # normals diffused in from the seeded ones
        is_green = torch.all(mask_img == green, dim=-1)
        is_black = torch.all(mask_img == 0.0, dim=-1)
        filled = im.inpaint_diffusion_multiscale(
            mask_img, is_green | is_black,
            coarse_iters=cfg.inpaint_iters // 3, fine_iters=2, factor=8)
        mask_img = torch.where(is_green[..., None], filled, mask_img)
        keep = ~torch.all(mask_img == 0.0, dim=-1)
        mask_img = im.masked_blur(mask_img, ksize=5, valid_mask=keep)
        mask_img = torch.where(hole[..., None], mask_img, zero)

    if cfg.do_basic_infill:
        image = infill_ops.normal_march_infill(image, hole,
                                               mask_img * 2.0 - 1.0)

    return image, res.depth, mask_img, hole


def _to_u8(x):
    """[0, 1] floats -> uint8 by truncation (the JAX package's cast)."""
    return (x * 255).to(torch.uint8)


def stereo_frame(depth_rgb, color, k, render_k, transform, conv_depth,
                 master_scale, cfg: StereoConfig):
    """Both eyes of a batch of frames, as one batch of frames x eyes.

    depth_rgb, color: (B, H, W, 3) uint8; k, render_k: (B, 3, 3);
    transform: (B, 4, 4) camera-motion cancel (identity if none);
    conv_depth: (B,) convergence distance in meters (0 = none);
    master_scale: (B,) depth scale for the master FOV (1 = none).
    Returns {"image", "infill_mask"} (B, H, 2W, 3) uint8 and
    {"depth_left", "depth_right"} (B, H, W) float32.
    """
    del render_k  # the sweep renders through the source camera
    b = depth_rgb.shape[0]
    scale = master_scale.to(torch.float32)
    depth = codec.decode_depth_frame(depth_rgb, cfg.max_depth) \
        * scale[:, None, None]
    colf = color.to(torch.float32) / 255.0
    conv_d = conv_depth.to(torch.float32) * scale
    conv = torch.where(conv_d > 0,
                       geo.convergence_angle(conv_d,
                                             cfg.pupillary_distance_m),
                       torch.zeros_like(conv_d))
    half = cfg.pupillary_distance_m / 2.0

    shared = None
    if cfg.remove_edges:
        edge = rasterize.cell_edge_mask(geo.unproject_depth(depth, k))
        normals = (geo.normals_from_depth(depth, k)
                   if cfg.place_edge_points else None)
        shared = (torch.cat([edge, edge]),
                  torch.cat([normals, normals]) if normals is not None
                  else None)

    def twice(x):
        return torch.cat([x, x])

    shift = torch.cat([torch.full((b,), -half, device=depth.device),
                       torch.full((b,), half, device=depth.device)])
    img, dep, mask_img, _ = render_eye(
        twice(depth), twice(colf), twice(k), twice(transform), shift,
        twice(conv), cfg, shared)
    image = torch.cat([_to_u8(img[:b]), _to_u8(img[b:])], dim=2)
    mask_out = torch.cat([_to_u8(mask_img[:b]), _to_u8(mask_img[b:])],
                         dim=2)
    return {"image": image, "infill_mask": mask_out,
            "depth_left": dep[:b], "depth_right": dep[b:]}


def smooth_convergence(values):
    """NaN-fill + tail-extended Savitzky-Golay smoothing of per-frame
    convergence depths."""
    from scipy.signal import savgol_filter

    v = np.asarray(values, np.float64).copy()
    nans = np.isnan(v)
    if nans.all():
        return np.zeros_like(v)
    if nans.any():
        idx = np.arange(v.size)
        good = idx[~nans]
        v[nans] = v[good[np.abs(good[None, :] - idx[nans, None]).argmin(1)]]
    n_tail = min(50, v.size)
    ext = np.concatenate([v, v[-n_tail:]])
    wl = min(100, ext.size)
    if wl % 2 == 0:
        wl -= 1
    if wl >= 3:
        sm = savgol_filter(ext, window_length=wl, polyorder=min(2, wl - 1))
        v = sm[:-n_tail] if n_tail else sm
    return v


def stereo_step(cfg, depth_rgb, color, ks, transforms, convs, scales,
                want_depth=False):
    """One batch through :func:`stereo_frame` on the tensors' device,
    with the SBS image, infill mask and (optionally) the RGB-encoded SBS
    depth brought back to the host as uint8 numpy arrays."""
    out = stereo_frame(depth_rgb, color, ks, ks, transforms, convs, scales,
                       cfg)
    res = {"image": out["image"]}
    if cfg.make_infill_mask:
        res["infill_mask"] = out["infill_mask"]
    if want_depth:
        res["sbs_depth"] = torch.cat(
            [codec.encode_depth_frame(out["depth_left"], cfg.max_depth),
             codec.encode_depth_frame(out["depth_right"], cfg.max_depth)],
            dim=2)
    return {key: v.cpu().numpy() for key, v in res.items()}


def render_stereo_video(depth_video, color_video=None, output=None,
                        xfov=None, yfov=None, xfovs=None,
                        transformations=None, convergence_depths=None,
                        master_xfov=45.0, max_depth=100.0,
                        pupillary_distance_mm=63.0, max_frames=-1,
                        batch_size=8, infill_mask=False, vr180=False,
                        touchly0=False, touchly1=False, remove_edges=True,
                        do_basic_infill=False, place_edge_points=True,
                        green_and_black_infill_mask=False,
                        create_sbs_depth=False, mask_video=None,
                        render_as_pointcloud=False, num_planes=128,
                        compressed=False, fused_anchor_sweep=False,
                        device=None):
    """Stream a depth(+color) video through the stereo step on
    ``device`` (CUDA unless the caller asks for the CPU). Returns the
    output path."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    for given, what in (
            (transformations is not None, "per-frame camera "
             "transformations (ROADMAP A3: forward_warp)"),
            (mask_video is not None, "background mode (ROADMAP A4)"),
            (render_as_pointcloud, "point-cloud rendering (ROADMAP A3)"),
            (vr180 or touchly0 or touchly1,
             "Touchly/VR180 outputs (ROADMAP A4)")):
        if given:
            raise NotImplementedError(f"not ported yet: {what}")
    device = resolve_device(device)
    dv = vio.VideoReader(depth_video, max_frames=max_frames)
    h, w, fps = dv.height, dv.width, dv.fps
    total = dv.frame_count if max_frames < 0 else min(max_frames,
                                                      dv.frame_count)
    dv.close()
    if color_video:
        with vio.VideoReader(color_video) as cv:
            if (cv.width, cv.height) != (w, h):
                raise ValueError("depth video and color video must have "
                                 "the same size")

    cfg = StereoConfig(
        width=w, height=h, max_depth=max_depth,
        pupillary_distance_m=pupillary_distance_mm / 1000.0,
        remove_edges=remove_edges, place_edge_points=place_edge_points,
        make_infill_mask=infill_mask,
        green_and_black_infill_mask=green_and_black_infill_mask,
        do_basic_infill=do_basic_infill, num_planes=num_planes,
        has_convergence=convergence_depths is not None,
        fused_anchor_sweep=fused_anchor_sweep)
    output = output or (depth_video + "_stereo.mkv")
    if convergence_depths is not None:
        convergence_depths = smooth_convergence(convergence_depths)

    dv = vio.PrefetchingBatchReader(depth_video, batch_size,
                                    max_frames=max_frames)
    cv = (vio.PrefetchingBatchReader(color_video, batch_size)
          if color_video else None)
    writer = vio.AsyncVideoWriter(output, fps, 2 * w, h,
                                  codec_fourcc="mp4v" if compressed
                                  else None)
    mask_writer = (vio.AsyncVideoWriter(output + "_infillmask.mkv", fps,
                                        2 * w, h) if infill_mask else None)
    depth_writer = (vio.AsyncVideoWriter(output + "_depth.mkv", fps, 2 * w,
                                         h) if create_sbs_depth else None)

    frame_n = 0
    try:
        while True:
            depth_rgb = dv.read_batch()
            if depth_rgb is None:
                break
            color = cv.read_batch() if cv is not None else depth_rgb
            if color is None:
                break
            b = min(depth_rgb.shape[0], color.shape[0])
            ks, convs, scales = [], [], []
            for i in range(b):
                fi = frame_n + i
                xf = xfovs[fi] if xfovs is not None else xfov
                ks.append(geo.camera_matrix_from_fov(
                    w, h, xfov_deg=xf, yfov_deg=yfov if xf is None
                    else None).numpy())
                scale_disp = (math.tan(math.radians(master_xfov / 2))
                              / math.tan(math.radians(
                                  xf if xf else master_xfov) / 2))
                scales.append(1.0 / scale_disp)
                convs.append(float(convergence_depths[fi])
                             if convergence_depths is not None else 0.0)

            def dev(a, dtype=None):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device)
            out = stereo_step(
                cfg, dev(depth_rgb[:b]), dev(color[:b]),
                dev(np.stack(ks), torch.float32),
                torch.eye(4, device=device).expand(b, 4, 4),
                dev(convs, torch.float32), dev(scales, torch.float32),
                want_depth=create_sbs_depth)
            for i in range(b):
                writer.write(out["image"][i])
                if mask_writer is not None:
                    mask_writer.write(out["infill_mask"][i])
                if depth_writer is not None:
                    depth_writer.write(out["sbs_depth"][i])
            frame_n += b
            if 0 <= max_frames <= frame_n:
                break
    finally:
        dv.close()
        if cv is not None:
            cv.close()
    writer.commit(min(frame_n, total) if total else frame_n)
    if mask_writer is not None:
        mask_writer.commit(frame_n)
    if depth_writer is not None:
        depth_writer.commit(frame_n)
    return output
