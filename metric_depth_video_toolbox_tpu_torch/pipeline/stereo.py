"""Stereo re-renderer: depth + color video -> side-by-side 3D video,
Touchly or VR180 (PyTorch port of ``pipeline/stereo.py``).

One step renders both eyes of a batch of frames as one batch of
frames x eyes: decode depth -> master-FOV scale -> per-eye (toe-in
convergence + IPD offset, after the camera-motion cancel) -> warp ->
edge anchors -> infill-mask normals (border defaults + diffusion inpaint
+ masked blur) -> optional normal-march infill -> SBS / Touchly layout
-> VR180 equirect resample, all on the device. Host <-> device traffic is
uint8 in, uint8 out. The warp is the disparity sweep (kernel B1, or B2
with ``fused_anchor_sweep``) where the only transform is the stereo eye
shift, else the scatter z-buffer of ``rasterize.forward_warp``.

Output naming matches the JAX package: ``<depth_video>_stereo.mkv``,
``_Touchly0.mkv`` (left | right | depth), ``_Touchly1.mkv`` (mono over
reversed 8-bit depth), ``<output>_infillmask.mkv``, ``<output>_depth.mkv``
and, in the background mode, ``<depth_video>_background.npy``.
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
from metric_depth_video_toolbox_tpu_torch.utils.timer import add, span

# the ``pass`` attribute of the ``stereo.sweep`` spans
_MAIN, _ANCHOR = {"pass": "main"}, {"pass": "anchor"}


@dataclasses.dataclass(frozen=True)
class StereoConfig:
    """Configuration of the stereo renderer (the JAX package's fields).

    ``out_width`` / ``out_height`` (the render size) default to the
    source size."""
    width: int
    height: int
    out_width: int = 0
    out_height: int = 0
    max_depth: float = 100.0
    pupillary_distance_m: float = 0.063
    remove_edges: bool = True
    place_edge_points: bool = True
    make_infill_mask: bool = False
    green_and_black_infill_mask: bool = False
    # fill the holes with the normal-march infill before the SBS output
    do_basic_infill: bool = False
    touchly0: bool = False
    touchly1: bool = False
    touchly_max_depth: float = 5.0
    touchly_min_depth: float = 0.0
    # taken and never read, as in the JAX package (the renderer gets VR180
    # from its render size and camera)
    vr180: bool = False
    # samples per grid cell side of the forward warp (1 = points)
    subsample: int = 2
    inpaint_iters: int = 48
    # 'sweep' = the disparity sweep (valid when the only transform is the
    # stereo eye shift [+ toe-in]); 'forward' = the scatter z-buffer (any
    # transform and render camera); 'plane_sweep' = the gather sweep (any
    # transform and render camera, bilinear source sampling); any other
    # value is 'forward'
    warp_method: str = "sweep"
    num_planes: int = 128
    has_convergence: bool = True
    # 'shift' = horizontal image translation folded into the plane
    # disparities; 'rotate' = exact toe-in through a rotation resample
    convergence_mode: str = "shift"
    # render the main surface and the edge-anchor layer in one fused sweep
    # (rasterize.stereo_sweep_warp_dual, anchors over the full plane set)
    # instead of a second anchor-only sweep at num_planes // 4
    fused_anchor_sweep: bool = False

    def __post_init__(self):
        object.__setattr__(self, "out_width", self.out_width or self.width)
        object.__setattr__(self, "out_height",
                           self.out_height or self.height)


def _touchly_depth8(depth, mask, cfg: StereoConfig):
    """Reversed 8-bit depth panel (..., H, W, 3): clip to [min, max], scale
    to 0..255, unrendered pixels far, then invert."""
    rng = cfg.touchly_max_depth - cfg.touchly_min_depth
    d8 = torch.round(torch.clamp(torch.clamp(depth, max=cfg.touchly_max_depth)
                                 - cfg.touchly_min_depth, min=0.0)
                     * (255.0 / rng))
    d8 = torch.where(mask, d8, torch.zeros_like(d8))
    d8 = torch.where(d8 == 0, torch.full_like(d8, 255.0), d8)
    return (255.0 - d8).to(torch.uint8)[..., None].expand(
        *d8.shape, 3).contiguous()


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


def _splat_anchors(depth, color, normals_t, k, render_k, m_eye, edge_mask,
                   out_hw):
    """The edge anchors of the non-sweep warps: the culled silhouette
    pixels as points, splatted into the render camera with their color and
    (rotated, not encoded) normals; the other points pushed behind the
    camera. -> (color, unit normals, found)."""
    n_img, h, w = depth.shape
    pts = geo.transform_depth_map(geo.unproject_depth(depth, k), m_eye)
    valid = (edge_mask & (depth > 1e-4)).reshape(n_img, h * w, 1)
    behind = torch.tensor([0.0, 0.0, -1.0], device=depth.device)
    anchor, _, found = rasterize.splat_points(
        torch.where(valid, pts.reshape(n_img, h * w, 3), behind),
        torch.cat([color, normals_t], dim=-1).reshape(n_img, h * w, 6),
        render_k, out_hw)
    return anchor[..., :3], _normalized(anchor[..., 3:]), found


def render_eye(depth, color, k, render_k, transform, eye_shift_m, conv_angle,
               cfg: StereoConfig, shared=None):
    """Render a batch of eyes (N = frames x eyes): the JAX package's
    ``render_eye``, batched.

    depth (N, H, W); color (N, H, W, 3) in [0, 1]; k, render_k (N, 3, 3)
    source and render cameras; transform (N, 4, 4) camera-motion cancel;
    eye_shift_m, conv_angle (N,).
    ``shared``: optional (edge_mask, normals), both eye-invariant (the
    sweep's).
    Returns (image f32 [0,1], depth, infill-mask normals image, hole), at
    the render size.
    """
    edge_pre, normals_pre = shared if shared is not None else (None, None)
    dev = depth.device
    out_hw = (cfg.out_height, cfg.out_width)
    sign = torch.where(eye_shift_m < 0, -1.0, 1.0)
    shift = geo.translation_matrix(-eye_shift_m, 0.0, 0.0)
    m_eye = shift @ geo.rotation_y(sign * conv_angle) @ transform

    sweep = cfg.warp_method == "sweep"
    rotate_conv = cfg.has_convergence and cfg.convergence_mode == "rotate"
    half_ipd = cfg.pupillary_distance_m / 2.0
    conv_inv_z = torch.tan(conv_angle) / half_ipd
    m_sweep = m_eye if rotate_conv else shift
    sweep_conv = 0.0 if rotate_conv else conv_inv_z

    anchors = cfg.place_edge_points and cfg.remove_edges
    fused = cfg.fused_anchor_sweep and anchors and sweep
    if anchors:
        if normals_pre is not None:
            normals = normals_pre
        else:
            with span("stereo.edges", device=dev):
                normals = geo.normals_from_depth(depth, k)
        normals_t = torch.einsum("nij,nhwj->nhwi", m_eye[:, :3, :3],
                                 normals)
    with span("stereo.sweep", device=dev, **_MAIN):
        if fused:
            res, a_color, a_extra, a_found = \
                rasterize.stereo_sweep_warp_dual(
                    depth, color, (normals_t + 1.0) / 2.0, k, m_sweep,
                    num_planes=cfg.num_planes,
                    neutralize_rotation=rotate_conv, conv_inv_z=sweep_conv,
                    edge=edge_pre)
        elif sweep:
            res = rasterize.stereo_sweep_warp(
                depth, color, k, m_sweep, num_planes=cfg.num_planes,
                remove_edges=cfg.remove_edges,
                neutralize_rotation=rotate_conv, conv_inv_z=sweep_conv,
                edge=edge_pre)
        elif cfg.warp_method == "plane_sweep":
            res = rasterize.plane_sweep_warp(
                depth, color, k, render_k, m_eye, out_hw,
                num_planes=cfg.num_planes, remove_edges=cfg.remove_edges,
                of_by_one=True)
        else:
            res = rasterize.forward_warp(
                depth, color, k, render_k, m_eye, out_hw,
                subsample=cfg.subsample, remove_edges=cfg.remove_edges,
                of_by_one=True)
    hole = ~res.mask
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    image = torch.where(hole[..., None], zero, res.color)
    green = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    mask_img = torch.where(hole[..., None], green, zero)

    if anchors:
        # edge anchors: the culled silhouette pixels re-rendered into the
        # holes, carrying color + normals: out of the fused sweep, from a
        # second sweep of the edge-only depth at num_planes//4, or (other
        # warps) splatted as points
        if sweep:
            if not fused:
                with span("stereo.sweep", device=dev, **_ANCHOR):
                    eres = rasterize.stereo_sweep_warp(
                        torch.where(res.edge_mask, depth, zero),
                        torch.cat([color, (normals_t + 1.0) / 2.0], dim=-1),
                        k, m_sweep, num_planes=max(cfg.num_planes // 4, 8),
                        remove_edges=False, neutralize_rotation=rotate_conv,
                        conv_inv_z=sweep_conv)
                a_color, a_extra = eres.color[..., :3], eres.color[..., 3:]
                a_found = eres.mask
            a_n = _normalized(a_extra * 2.0 - 1.0)
        else:
            with span("stereo.sweep", device=dev, **_ANCHOR):
                a_color, a_n, a_found = _splat_anchors(
                    depth, color, normals_t, k, render_k, m_eye,
                    res.edge_mask, out_hw)
        write = (a_found & hole)[..., None]
        image = torch.where(write, a_color, image)
        if not cfg.green_and_black_infill_mask:
            mask_img = torch.where(write, (a_n + 1.0) / 2.0, mask_img)

    if ((cfg.make_infill_mask or cfg.do_basic_infill)
            and not cfg.green_and_black_infill_mask):
        with span("stereo.mask", device=dev):
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
    """Both eyes of a batch of frames, as one batch of frames x eyes (one
    mono render with Touchly1).

    depth_rgb, color: (B, H, W, 3) uint8; k, render_k: (B, 3, 3) source
    and render cameras; transform: (B, 4, 4) camera-motion cancel
    (identity if none); conv_depth: (B,) convergence distance in meters
    (0 = none); master_scale: (B,) depth scale for the master FOV (1 =
    none).
    Returns {"image", "infill_mask"} uint8: (B, Ho, 2 Wo, 3), with
    Touchly0 (B, Ho, 3 Wo, 3), with Touchly1 (B, 2 Ho, Wo, 3); and
    {"depth_left", "depth_right"} (B, Ho, Wo) float32.
    """
    b = depth_rgb.shape[0]
    dev = depth_rgb.device
    with span("stereo.decode", device=dev):
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
    if cfg.warp_method == "sweep" and cfg.remove_edges:
        with span("stereo.edges", device=dev):
            shared = (rasterize.cell_edge_mask(geo.unproject_depth(depth,
                                                                   k)),
                      geo.normals_from_depth(depth, k)
                      if cfg.place_edge_points else None)

    if cfg.touchly1:
        # mono render over the reversed depth panel
        zero = torch.zeros(b, device=dev)
        img, dep, mask_img, hole = render_eye(
            depth, colf, k, render_k, transform, zero, zero, cfg, shared)
        panel = _touchly_depth8(dep, ~hole, cfg)
        return {"image": torch.cat([_to_u8(img), panel], dim=1),
                "infill_mask": torch.cat([_to_u8(mask_img),
                                          torch.zeros_like(panel)], dim=1),
                "depth_left": dep, "depth_right": dep}

    def twice(x):
        return torch.cat([x, x]) if x is not None else None

    if shared is not None:
        shared = tuple(map(twice, shared))
    shift = torch.cat([torch.full((b,), -half, device=dev),
                       torch.full((b,), half, device=dev)])
    img, dep, mask_img, _ = render_eye(
        twice(depth), twice(colf), twice(k), twice(render_k),
        twice(transform), shift, twice(conv), cfg, shared)
    panels = [_to_u8(img[:b]), _to_u8(img[b:])]
    mask_panels = [_to_u8(mask_img[:b]), _to_u8(mask_img[b:])]
    if cfg.touchly0:
        panel = _touchly_depth8(dep[:b], dep[:b] < rasterize.INF_DEPTH, cfg)
        panels.append(panel)
        mask_panels.append(torch.zeros_like(panel))
    return {"image": torch.cat(panels, dim=2),
            "infill_mask": torch.cat(mask_panels, dim=2),
            "depth_left": dep[:b], "depth_right": dep[b:]}


def equirect_maps(h, w, input_fov_deg):
    """The VR180 rectilinear -> equirect sampling grid (h, w, 2) float32 of
    source (x, y) per output pixel; -10 outside the input FOV."""
    cx = (w - 1) / 2.0
    cy = (h - 1) / 2.0
    gx, gy = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    theta = (gx - cx) / cx * (np.pi / 2)
    phi = (gy - cy) / cy * (np.pi / 2)
    half = math.radians(input_fov_deg / 2.0)
    fx = cx / math.tan(half)
    fy = cy / math.tan(half)
    valid = (np.abs(theta) <= half) & (np.abs(phi) <= half)
    map_x = np.where(valid, fx * np.tan(theta) + cx, -10.0)
    map_y = np.where(valid, fy * np.tan(phi) + cy, -10.0)
    return np.stack([map_x, map_y], axis=-1).astype(np.float32)


def apply_equirect(img_u8, xy_map):
    """Resample (N, H, W, 3) uint8 images through one (Ho, Wo, 2) map."""
    xy = xy_map.expand(img_u8.shape[0], *xy_map.shape)
    out = im.bilinear_sample(img_u8.to(torch.float32), xy, fill=0.0)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _equirect_batch(images_u8, eq_map, three_panel):
    """The equirect resample of each eye panel of a batch of SBS (or
    three-panel) frames (B, H, n W, 3) uint8."""
    n_panels = 3 if three_panel else 2
    pw = images_u8.shape[2] // n_panels
    return torch.cat([apply_equirect(images_u8[:, :, i * pw:(i + 1) * pw],
                                     eq_map) for i in range(n_panels)],
                     dim=2)


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
                want_depth=False, render_ks=None, eq_map=None):
    """One batch through :func:`stereo_frame` on the tensors' device, then
    (``eq_map``, VR180) the equirect resample of the image and infill mask
    there, with the image, infill mask and (optionally) the RGB-encoded SBS
    depth brought back to the host as uint8 numpy arrays. ``render_ks``
    defaults to ``ks``."""
    with span("stereo.batch", frames=depth_rgb.shape[0]):
        out = stereo_frame(depth_rgb, color, ks,
                           ks if render_ks is None else render_ks,
                           transforms, convs, scales, cfg)
        res = {"image": out["image"]}
        if cfg.make_infill_mask:
            res["infill_mask"] = out["infill_mask"]
        if eq_map is not None:
            res = {key: _equirect_batch(v, eq_map, cfg.touchly0)
                   for key, v in res.items()}
        if want_depth:
            res["sbs_depth"] = torch.cat(
                [codec.encode_depth_frame(out["depth_left"], cfg.max_depth),
                 codec.encode_depth_frame(out["depth_right"],
                                          cfg.max_depth)], dim=2)
        with span("stereo.to_host"):
            res = {key: v.cpu().numpy() for key, v in res.items()}
            add("bytes", sum(v.nbytes for v in res.values()))
        return res


def render_stereo_video(depth_video, color_video=None, output=None,
                        xfov=None, yfov=None, xfovs=None,
                        transformations=None, convergence_depths=None,
                        master_xfov=45.0, max_depth=100.0,
                        pupillary_distance_mm=63.0, max_frames=-1,
                        batch_size=8, infill_mask=False, vr180=False,
                        touchly0=False, touchly1=False, remove_edges=True,
                        do_basic_infill=False, place_edge_points=True,
                        green_and_black_infill_mask=False,
                        create_sbs_depth=False, touchly_max_depth=5.0,
                        touchly_min_depth=0.0, transformation_lock_frame=0,
                        mask_video=None, save_background=False,
                        load_background=None, render_as_pointcloud=False,
                        vr180_eye_size=1920, num_planes=128,
                        compressed=False, fused_anchor_sweep=False,
                        device=None):
    """Stream a depth(+color) video through the stereo step on
    ``device`` (CUDA unless the caller asks for the CPU), with the JAX
    package's flags, output names and sizes. Returns the output path."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

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
    if mask_video is not None or load_background is not None:
        return _render_background_mode(
            depth_video, color_video, mask_video, output=output, xfov=xfov,
            yfov=yfov, transformations=transformations,
            convergence_depths=convergence_depths, max_depth=max_depth,
            pupillary_distance_mm=pupillary_distance_mm,
            max_frames=max_frames, save_background=save_background,
            load_background=load_background, infill_mask=infill_mask,
            device=device)

    out_w, out_h = w, h
    vr180 = vr180 or touchly0
    if vr180:
        # a square equirect render per eye
        out_w = out_h = vr180_eye_size
    # the sweep needs a same-camera, x-only warp: no camera path and not
    # VR180's render camera; point clouds are forward splats of 1 sample
    warp_method = ("sweep" if transformations is None and not vr180
                   and not render_as_pointcloud else "forward")
    cfg = StereoConfig(
        width=w, height=h, out_width=out_w, out_height=out_h,
        max_depth=max_depth,
        pupillary_distance_m=pupillary_distance_mm / 1000.0,
        remove_edges=remove_edges, place_edge_points=place_edge_points,
        make_infill_mask=infill_mask,
        green_and_black_infill_mask=green_and_black_infill_mask,
        do_basic_infill=do_basic_infill, touchly0=touchly0,
        touchly1=touchly1, touchly_max_depth=touchly_max_depth,
        touchly_min_depth=touchly_min_depth, vr180=vr180,
        warp_method=warp_method, num_planes=num_planes,
        subsample=1 if render_as_pointcloud else StereoConfig.subsample,
        has_convergence=convergence_depths is not None,
        fused_anchor_sweep=fused_anchor_sweep)

    if touchly1:
        suffix, out_size = "_Touchly1.mkv", (w, h * 2)
    elif touchly0:
        suffix, out_size = "_Touchly0.mkv", (out_w * 3, out_h)
    else:
        suffix, out_size = "_stereo.mkv", (out_w * 2, out_h)
    output = output or (depth_video + suffix)

    if transformations is not None:
        transformations = np.asarray(transformations, np.float32)
        if transformation_lock_frame != 0:
            transformations = transformations @ np.linalg.inv(
                transformations[transformation_lock_frame])
    if convergence_depths is not None:
        convergence_depths = smooth_convergence(convergence_depths)

    dv = vio.PrefetchingBatchReader(depth_video, batch_size,
                                    max_frames=max_frames)
    cv = (vio.PrefetchingBatchReader(color_video, batch_size)
          if color_video else None)
    writer = vio.AsyncVideoWriter(output, fps, *out_size,
                                  codec_fourcc="mp4v" if compressed
                                  else None)
    mask_writer = (vio.AsyncVideoWriter(output + "_infillmask.mkv", fps,
                                        *out_size) if infill_mask else None)
    depth_writer = (vio.AsyncVideoWriter(output + "_depth.mkv", fps,
                                         out_w * 2, out_h)
                    if create_sbs_depth else None)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    eq_map = None
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
            ks, rks, tfs, convs, scales = [], [], [], [], []
            for i in range(b):
                fi = frame_n + i
                xf = xfovs[fi] if xfovs is not None else xfov
                k = geo.camera_matrix_from_fov(
                    w, h, xfov_deg=xf, yfov_deg=yf_or_none(xf, yfov))
                rk = k
                frame_master = master_xfov
                if vr180:
                    fov_x, fov_y = geo.fov_from_camera_matrix(k)
                    render_fov = max(75.0, float(fov_x), float(fov_y))
                    frame_master = render_fov
                    rk = geo.camera_matrix_from_fov(
                        out_w, out_h, xfov_deg=render_fov,
                        yfov_deg=render_fov)
                scale_disp = (math.tan(math.radians(frame_master / 2))
                              / math.tan(math.radians(
                                  xf if xf else master_xfov) / 2))
                scales.append(1.0 / scale_disp)
                ks.append(k.numpy())
                rks.append(rk.numpy())
                tfs.append(transformations[fi] if transformations is not None
                           else np.eye(4, dtype=np.float32))
                convs.append(float(convergence_depths[fi])
                             if convergence_depths is not None else 0.0)
            if vr180 and eq_map is None:
                # built once, from the first batch's (last) render FOV
                eq_map = dev(equirect_maps(out_h, out_w, render_fov))
            out = stereo_step(
                cfg, dev(depth_rgb[:b]), dev(color[:b]),
                dev(np.stack(ks), torch.float32), dev(np.stack(tfs),
                                                      torch.float32),
                dev(convs, torch.float32), dev(scales, torch.float32),
                want_depth=create_sbs_depth,
                render_ks=dev(np.stack(rks), torch.float32), eq_map=eq_map)
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


def yf_or_none(xf, yfov):
    """The y FOV a frame's camera takes: ``yfov`` where no x FOV is
    given, else None (the x FOV sets the focal)."""
    return yfov if xf is None else None


def _render_background_mode(depth_video, color_video, mask_video,
                            output=None, xfov=None, yfov=None,
                            transformations=None, convergence_depths=None,
                            max_depth=100.0, pupillary_distance_mm=63.0,
                            max_frames=-1, save_background=False,
                            load_background=None, infill_mask=False,
                            downsample_every=10, voxel=0.003, device=None):
    """The background mode: accumulate the unmasked (background) pixels of
    every frame into a growing world-space point cloud and render that per
    frame, giving a clean plate. ``save_background`` writes
    ``<depth_video>_background.npy`` (an object array [points, colors])
    and renders nothing; ``load_background`` starts from a saved cloud.
    The cloud lives on the host; each frame's points and each render run
    on ``device``. Convergence depths are used as given (not smoothed)."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.ops import voxel as voxel_mod

    device = resolve_device(device)
    dv = vio.VideoReader(depth_video, max_frames=max_frames)
    cv = vio.VideoReader(color_video) if color_video else None
    mv = vio.VideoReader(mask_video) if mask_video else None
    h, w = dv.height, dv.width
    k = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov, yfov_deg=yfov,
                                   device=device)
    half = pupillary_distance_mm / 2000.0

    bg_points = np.zeros((0, 3), np.float32)
    bg_colors = np.zeros((0, 3), np.float32)
    if load_background:
        loaded = np.load(load_background, allow_pickle=True)
        bg_points = np.asarray(loaded[0], np.float32).reshape(-1, 3)
        bg_colors = np.asarray(loaded[1], np.float32).reshape(-1, 3)

    def frame_points(depth_rgb, color_u8, transform):
        depth = codec.decode_depth_frame(depth_rgb, max_depth)
        pts_cam = geo.unproject_depth(depth, k)
        edge = rasterize.cell_edge_mask(pts_cam)
        world = geo.transform_depth_map(pts_cam, transform)
        keep = (~edge) & (depth > 1e-3)
        return (world.reshape(-1, 3).cpu().numpy(),
                (color_u8.to(torch.float32) / 255.0).reshape(-1, 3)
                .cpu().numpy(), keep.reshape(-1).cpu().numpy())

    output = output or (depth_video + "_stereo.mkv")
    writer = None if save_background else vio.VideoWriter(
        output, dv.fps, w * 2, h)
    mask_writer = (vio.VideoWriter(output + "_infillmask.mkv", dv.fps,
                                   w * 2, h)
                   if infill_mask and not save_background else None)

    fr = 0
    try:
        while True:
            rgb = dv.read_batch(1)
            if rgb is None:
                break
            color = cv.read_batch(1) if cv is not None else rgb
            if color is None:
                break
            m = (np.asarray(transformations[fr], np.float32)
                 if transformations is not None
                 else np.eye(4, dtype=np.float32))
            if mv is not None:
                mk = mv.read_batch(1)
                fg = ((mk[0].mean(-1) > 128) if mk is not None
                      else np.zeros((h, w), bool))
                world, cols, keep = frame_points(
                    torch.as_tensor(rgb[0], device=device),
                    torch.as_tensor(color[0], device=device),
                    torch.as_tensor(m, device=device))
                keep = keep & ~fg.reshape(-1)
                bg_points = np.concatenate([bg_points, world[keep]], axis=0)
                bg_colors = np.concatenate([bg_colors, cols[keep]], axis=0)
                if (fr + 1) % downsample_every == 0:
                    bg_points, bg_colors = \
                        voxel_mod.perspective_aware_downsample(
                            bg_points, bg_colors, voxel)

            if writer is not None and bg_points.shape[0]:
                conv = 0.0
                if (convergence_depths is not None
                        and fr < len(convergence_depths)):
                    d = float(convergence_depths[fr])
                    if d > 0:
                        conv = float(np.arctan(half / d))
                inv_m = torch.linalg.inv(torch.as_tensor(m))
                # both eyes in one splat: left (shift +half, toe-in
                # +conv), then right
                m_eye = torch.stack([
                    geo.translation_matrix(shift, 0.0, 0.0)
                    @ geo.rotation_y(sign * -conv) @ inv_m
                    for sign, shift in ((-1.0, half), (1.0, -half))
                ]).to(device)
                pts = geo.transform_points(
                    torch.as_tensor(bg_points, device=device)[None], m_eye)
                img, _, found = rasterize.splat_points(
                    pts, torch.as_tensor(bg_colors, device=device)
                    .expand(2, -1, -1), k.expand(2, 3, 3), (h, w), radius=1)
                img = torch.clamp(img * 255, 0, 255).to(torch.uint8)
                hole = (~found).to(torch.uint8) * 255
                zero = torch.zeros_like(hole)
                writer.write(torch.cat([img[0], img[1]], dim=1).cpu().numpy())
                if mask_writer is not None:
                    mask_writer.write(torch.cat(
                        [torch.stack([zero[i], hole[i], zero[i]], -1)
                         for i in range(2)], dim=1).cpu().numpy())
            fr += 1
    finally:
        dv.close()
        if cv is not None:
            cv.close()
        if mv is not None:
            mv.close()
    if save_background:
        path = depth_video + "_background.npy"
        np.save(path, np.array([bg_points, bg_colors], dtype=object))
        return path
    writer.commit(fr)
    if mask_writer is not None:
        mask_writer.commit(fr)
    return output
