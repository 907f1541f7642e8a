"""Depth estimation stage: color video -> RGB-encoded metric depth video
(PyTorch port of the VDA and DA3 engines of ``pipeline/depth.py``).

The VDA engine runs Video-Depth-Anything over overlapping windows,
stitched, and makes the relative disparity metric with a closed-form
scale/shift fit against a per-frame Depth-Anything metric anchor (or a
reference depth video). Without weights the engine draws them from a
seeded ``torch.Generator``; plumbing and throughput are the same.

The single-frame engines (:class:`SingleFrameEngine`: UniDepth, UniK3D,
MoGe, DepthPro and their Depth-Anything stand-ins) run frame batches and
write the depth video, with an ``_xfovs.json`` sidecar where asked.

The DA3 engine (:class:`DA3PipelineEngine`, ``models.da3.DA3Engine``) runs
multi-view windows and writes the depth video with its ``_xfovs.json`` and
``_transformations.json`` sidecars.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from metric_depth_video_toolbox_tpu_torch.models import depth_anything as da
from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import video_depth as vd
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def _downsample_bilinear(frames, out_hw):
    """(T, h, w) float32 -> (T, out_h, out_w), plain bilinear with
    half-pixel centers and no antialias (the JAX engine's cv2
    INTER_LINEAR for a reference depth video of another size)."""
    return F.interpolate(frames[:, None], size=tuple(out_hw),
                         mode="bilinear", align_corners=False)[:, 0]


def _check_grid(params, model, work_hw, patch):
    """Weights made for another patch grid raise, naming both grids (the
    JAX engine's Flax ``apply`` refuses the position embedding's shape)."""
    if from_jax.is_state_dict(params):
        pe = params.get("backbone.pos_embed")
    else:
        tree = params.get("params", params)
        pe = tree.get("backbone", {}).get("pos_embed")
    if pe is None:
        return
    have = int(pe.shape[1]) - 1
    want = model.backbone.pos_embed.shape[1] - 1
    if have != want:
        side = int(round(have ** 0.5))
        grid = (f" ({side} x {side} if square)" if side * side == have
                else "")
        raise ValueError(
            f"the weights' position embedding holds {have} patches{grid}; "
            f"the clip's working resolution {work_hw[0]} x {work_hw[1]} "
            f"is a grid of {work_hw[0] // patch} x {work_hw[1] // patch} = "
            f"{want} patches: convert the checkpoint for this grid, or "
            f"choose --input_size to match it")


ENGINES: Dict[str, Callable] = {}


def register_engine(name):
    def deco(fn):
        ENGINES[name] = fn
        return fn
    return deco


def read_list_file(path):
    """.txt batch protocol: one video path per line, '#' comments."""
    with open(path, encoding="utf-8") as f:
        return [ln.strip() for ln in f
                if ln.strip() and not ln.strip().startswith("#")]


def expand_batch(path_or_txt):
    """A video path, a list of them, or a .txt list file -> paths."""
    if isinstance(path_or_txt, (list, tuple)):
        return list(path_or_txt)
    if isinstance(path_or_txt, str) and path_or_txt.lower().endswith(".txt"):
        return read_list_file(path_or_txt)
    return [path_or_txt]


class VDAEngine:
    """Video-Depth-Anything engine: temporally consistent relative video
    depth made metric against a metric anchor model or a reference depth
    video.

    ``params`` / ``anchor_params``: weights of
    :class:`~..models.video_depth.VideoDepthAnything` and
    :class:`~..models.depth_anything.DepthAnything` at the clip's working
    resolution, as port state dicts or as trees in the JAX package's Flax
    layout (``models.convert.convert_vda``, ``load_checkpoint``); None
    draws seeded weights (``rng_seed``). A tree's leaves that the model
    has no place for are ignored, as the JAX engine's Flax ``apply``
    ignores them (a ``convert_vda`` tree's learned resize layers: this
    engine runs the default decode, not the weight-exact one); their
    names are in ``ignored_leaves``. ``fp32`` selects float32 compute
    (default bfloat16).
    """

    def __init__(self, size="vits", input_size=518, window=None,
                 overlap=None, params=None, anchor_params=None, rng_seed=0,
                 metric_anchor_frames=32, max_depth=100.0, fp32=False,
                 data_parallel=False, quantize=None, rolling_average=0,
                 anchor_stride=4, device=None):
        if quantize:
            raise NotImplementedError("not ported yet: --quantize "
                                      "(ROADMAP A13)")
        if data_parallel:
            raise NotImplementedError("not ported yet: data-parallel "
                                      "inference over several GPUs "
                                      "(ROADMAP A16)")
        window = window or vd.VideoDepthConfig.window
        if overlap is None:
            overlap = min(vd.VideoDepthConfig.overlap, max(window // 4, 1))
        vit_cfg = vit_mod.PRESETS[size]
        dpt_cfg = dpt_mod.DPT_TINY if size == "vitt" else dpt_mod.DPTConfig()
        if fp32:
            vit_cfg = dataclasses.replace(vit_cfg, dtype="float32")
            dpt_cfg = dataclasses.replace(dpt_cfg, dtype="float32")
        self.cfg = vd.VideoDepthConfig(
            vit=vit_cfg, dpt=dpt_cfg, temporal_layers=1,
            temporal_heads=2 if size == "vitt" else 8,
            norm_groups=4 if size == "vitt" else 32,
            window=window, overlap=min(overlap, window - 1))
        self.anchor_cfg = da.preset(size, metric=True, max_depth=20.0)
        self.input_size = input_size
        self.metric_anchor_frames = metric_anchor_frames
        self.max_depth = max_depth
        self.rolling_average = int(rolling_average or 0)
        self.anchor_stride = max(1, int(anchor_stride))
        self.device = resolve_device(device)
        self._params = params
        self._anchor_params = anchor_params
        self._seed = rng_seed
        self._models = {}
        self.ignored_leaves = []

    def models(self, work_hw):
        """(video model, anchor model) at a working resolution."""
        work_hw = tuple(work_hw)
        if work_hw not in self._models:
            gen = torch.Generator().manual_seed(self._seed)
            model = vd.VideoDepthAnything(self.cfg, work_hw)
            anchor = da.DepthAnything(self.anchor_cfg, work_hw)
            for mod, sd in ((model, self._params),
                            (anchor, self._anchor_params)):
                if sd is None:
                    vit_mod.seeded_init(mod, gen,
                                        self.cfg.vit.layerscale_init)
                else:
                    _check_grid(sd, mod, work_hw, self.cfg.vit.patch_size)
                    from_jax.load_params(mod, sd, ignore_unused=True,
                                         ignored=self.ignored_leaves)
            self._models[work_hw] = (model.to(self.device).eval(),
                                     anchor.to(self.device).eval())
        return self._models[work_hw]

    @torch.no_grad()
    def infer_video(self, frames_u8, reference_depth=None):
        """(T, H, W, 3) uint8 -> (T, H, W) float32 metric depth (numpy)."""
        t, h, w = frames_u8.shape[:3]
        work_hw = da.working_resolution(h, w, self.input_size,
                                        self.cfg.vit.patch_size)
        model, anchor = self.models(work_hw)
        frames = torch.as_tensor(np.asarray(frames_u8))
        disp = vd.infer_video_depth(model, frames, work_hw, (h, w),
                                    window=self.cfg.window,
                                    overlap=self.cfg.overlap,
                                    device=self.device)
        anchor_hw = tuple(disp.shape[1:3])

        def anchor_depth(idx):
            if reference_depth is not None:
                ref = torch.as_tensor(np.asarray(reference_depth)[idx],
                                      device=self.device)
                return (_downsample_bilinear(ref, anchor_hw)
                        if tuple(ref.shape[1:3]) != anchor_hw else ref)
            chunks = [da.infer_depth(anchor,
                                     frames[idx[i:i + 16]].to(self.device),
                                     anchor_hw, work_hw)
                      for i in range(0, len(idx), 16)]
            return torch.cat(chunks, dim=0)

        if self.rolling_average > 0:
            idx = np.arange(0, t, self.anchor_stride)
            inv_anchor = 1.0 / torch.clamp(anchor_depth(idx), min=1e-3)
            s_t, t_t = solvers.rolling_scale_shift(
                disp[idx], inv_anchor, idx, t, window=self.rolling_average)
            inv = (disp * torch.as_tensor(s_t, device=self.device)[:, None,
                                                                   None]
                   + torch.as_tensor(t_t, device=self.device)[:, None, None])
        else:
            idx = np.arange(min(self.metric_anchor_frames, t))
            inv_anchor = 1.0 / torch.clamp(anchor_depth(idx), min=1e-3)
            s, sh = solvers.scale_and_shift(disp[:len(idx)], inv_anchor)
            inv = disp * s + sh
        depth = 1.0 / torch.clamp(inv, min=1e-6)
        depth = torch.where(inv <= 0, torch.full_like(depth, self.max_depth),
                            depth)
        return torch.clamp(depth, 0.0, self.max_depth).cpu().numpy()


@register_engine("vda")
def run_vda(color_video, max_depth=100.0, max_frames=-1, engine=None,
            reference_depth_video=None, target_fps=-1, **kw):
    """Color video -> ``<video>_depth.mkv``; returns the output path."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    eng = engine or VDAEngine(max_depth=max_depth, **kw)
    frames, fps = vio.read_video_frames(color_video, max_frames=max_frames,
                                        target_fps=target_fps)
    ref = None
    if reference_depth_video:
        with vio.DepthVideoReader(reference_depth_video, max_depth) as r:
            ref = r.read_depth_batch(frames.shape[0])
    depth = eng.infer_video(frames, reference_depth=ref)
    out = color_video + "_depth.mkv"
    vio.save_depth_video(depth, out, fps, max_depth)
    return out


def _tree_has(params, *path):
    """Whether ``params`` (a Flax tree, with or without its ``params``
    level, or a port state dict) holds the module at ``path``."""
    if params is None:
        return False
    if from_jax.is_state_dict(params):
        prefix = ".".join(path) + "."
        return any(k.startswith(prefix) for k in params)
    node = params.get("params", params)
    for key in path:
        if not hasattr(node, "get") or key not in node:
            return False
        node = node[key]
    return True


def _resize_frames(frames_u8, work_hw):
    """uint8 (B, H, W, 3) -> float32 [0, 1] (B, h, w, 3) at ``work_hw``
    (``jax.image.resize`` bilinear: antialiased when shrinking)."""
    x = frames_u8.to(torch.float32).permute(0, 3, 1, 2) / 255.0
    return resize_nchw(x, work_hw).permute(0, 2, 3, 1)


class SingleFrameEngine:
    """Per-frame metric depth engines, batched over frames, one
    distinguishing behaviour per ``variant``:

      'unidepth'  known-camera conditioning: rays from the mandatory
                  ``xfov`` condition the model
      'unik3d'    per-frame focal refit from the model's point map
      'moge'      affine point map + mask: per-frame focal and z-shift
                  recovered (``ops.geometry.recover_focal_shift``; a
                  given ``xfov`` fixes the focal and conditions the
                  stand-in), masked sky -> max_depth
      'depthpro'  the model estimates each frame's FOV
      'da'        plain metric depth (default)

    Without a checkpoint each runs a Depth-Anything stand-in with the
    variant's head. A tree that holds the real graph's modules switches
    onto it: ``patch_encoder`` -> DepthPro (``depthpro_cfg``, default
    DEPTHPRO_L, DEPTHPRO_TINY for size vitt), ``head.upsample0`` -> MoGe,
    ``camera`` -> UniDepth-V2, ``angular`` -> UniK3D (``moge_cfg``,
    ``unidepth_cfg``, L or TINY alike). ``params``: a Flax-layout tree
    (``models.convert``, ``load_checkpoint``) or a port state dict; leaves
    the model has no place for are ignored, as Flax ``apply`` ignores them
    (their names in ``ignored_leaves``); None draws seeded weights
    (``rng_seed``). The real DepthPro graph runs ``DEPTHPRO_MICRO_BATCH``
    frames at a time (its float32 decode at 1536 x 1536 holds several GiB
    a frame).
    """

    DEPTHPRO_MICRO_BATCH = 4

    def __init__(self, size="vits", input_size=518, params=None,
                 max_depth=100.0, rng_seed=0,
                 data_parallel=False, variant="da", xfov=None, yfov=None,
                 depthpro_cfg=None, quantize=None, moge_cfg=None,
                 unidepth_cfg=None, device=None):
        from metric_depth_video_toolbox_tpu_torch.models import depthpro
        from metric_depth_video_toolbox_tpu_torch.models import moge
        from metric_depth_video_toolbox_tpu_torch.models import unidepth

        if quantize:
            raise NotImplementedError("not ported yet: --quantize "
                                      "(ROADMAP A13c)")
        if data_parallel:
            raise NotImplementedError("not ported yet: data-parallel "
                                      "inference over several GPUs "
                                      "(ROADMAP A16)")
        if variant == "unidepth" and xfov is None:
            raise ValueError("unidepth engine requires --xfov (reference "
                             "unidepth_video.py makes FOV mandatory)")
        self.variant = variant
        self.xfov = xfov
        self.yfov = yfov
        tiny = size in ("vitt", "tiny")
        self.cfg = da.preset(size, metric=True, max_depth=max_depth)
        point_cfg = dataclasses.replace(
            self.cfg, point_head=True,
            dpt=dataclasses.replace(self.cfg.dpt, n_out=4, head_act="none"))
        # the real graph a tree switches onto: (kind, its config)
        self.graph = None
        if variant == "depthpro" and _tree_has(params, "patch_encoder"):
            self.graph = ("depthpro", depthpro_cfg or (
                depthpro.DEPTHPRO_TINY if tiny else depthpro.DEPTHPRO_L))
        elif variant == "moge" and _tree_has(params, "head", "upsample0"):
            self.graph = ("moge", moge_cfg or (
                moge.MOGE_TINY if tiny else moge.MOGE_L))
            self.cfg = point_cfg
        elif variant == "unidepth" and _tree_has(params, "camera"):
            self.graph = ("unidepth", unidepth_cfg or (
                unidepth.UNIDEPTH_TINY if tiny else unidepth.UNIDEPTH_L))
        elif variant == "unik3d" and _tree_has(params, "angular"):
            self.graph = ("unik3d", unidepth_cfg or (
                unidepth.UNIDEPTH_TINY if tiny else unidepth.UNIDEPTH_L))
            self.cfg = dataclasses.replace(self.cfg, point_head=True)
        else:
            if variant == "unidepth" or (variant == "moge" and xfov):
                self.cfg = dataclasses.replace(self.cfg, k_condition=True)
            if variant in ("moge", "unik3d"):
                self.cfg = dataclasses.replace(
                    point_cfg, k_condition=self.cfg.k_condition)
            if variant == "depthpro" and not xfov:
                self.cfg = dataclasses.replace(self.cfg, fov_head=True)
        self.input_size = input_size
        self.max_depth = max_depth
        self.device = resolve_device(device)
        self._params = params
        self._seed = rng_seed
        self._models = {}
        self.ignored_leaves = []

    def model(self, work_hw):
        """The engine's model at a working resolution (built and loaded,
        or seeded, on first use)."""
        from metric_depth_video_toolbox_tpu_torch.models import depthpro
        from metric_depth_video_toolbox_tpu_torch.models import moge
        from metric_depth_video_toolbox_tpu_torch.models import unidepth

        work_hw = tuple(work_hw)
        if work_hw in self._models:
            return self._models[work_hw]
        kind, gcfg = self.graph or (None, None)
        if kind == "depthpro":
            mod = depthpro.DepthProNet(gcfg)
        elif kind == "moge":
            mod = moge.MoGeNet(gcfg, work_hw)
        elif kind == "unidepth":
            mod = unidepth.UniDepthNet(gcfg, work_hw)
        elif kind == "unik3d":
            mod = unidepth.UniK3DNet(gcfg, work_hw)
        else:
            mod = da.DepthAnything(self.cfg, work_hw)
        if self._params is None:
            vit_mod.seeded_init(mod, torch.Generator().manual_seed(
                self._seed), (gcfg or self.cfg).vit.layerscale_init)
        else:
            if kind != "depthpro":
                patch = (gcfg or self.cfg).vit.patch_size
                _check_grid(self._params, mod, work_hw, patch)
            from_jax.load_params(mod, self._params, ignore_unused=True,
                                 ignored=self.ignored_leaves)
        self._models[work_hw] = mod.to(self.device).eval()
        return self._models[work_hw]

    def share_weights(self, other, work_hw):
        """Alias this engine's parameters at ``work_hw`` to ``other``'s
        where names and shapes agree (the same draws a second seeded
        engine would make); returns the number of tensors shared."""
        mine = self.model(work_hw)
        theirs = dict(other.model(work_hw).named_parameters())
        n = 0
        for name, p in mine.named_parameters():
            q = theirs.get(name)
            if q is not None and q.shape == p.shape:
                p.data = q.data
                n += 1
        return n

    def _depthpro(self, model, x, h, w):
        """The real DepthPro step: the square working size, the HF
        processor's normalization, canonical inverse depth scaled by
        2 tan(fov / 2) and inverted."""
        from metric_depth_video_toolbox_tpu_torch.models import depthpro

        s = depthpro.working_size(self.graph[1])
        x = depthpro.resize(x.to(torch.float32) / 255.0, (s, s))
        x = (x - 0.5) / 0.5
        invs, fovs = [], []
        for i in range(0, x.shape[0], self.DEPTHPRO_MICRO_BATCH):
            inv, fov = model(x[i:i + self.DEPTHPRO_MICRO_BATCH])
            if fov is not None:
                inv = inv * (2.0 * torch.tan(torch.deg2rad(fov) * 0.5)
                             )[:, None, None]
                fovs.append(fov)
            invs.append(resize_nchw(inv[:, None], (h, w))[:, 0])
        d = 1.0 / torch.clamp(torch.cat(invs), 1e-4, 1e4)
        return (torch.clamp(d, max=self.max_depth),
                torch.cat(fovs) if fovs else None)

    def _rays(self, work_hw, b):
        p = (self.graph[1] if self.graph else self.cfg).vit.patch_size
        gh, gw = work_hw[0] // p, work_hw[1] // p
        rays = torch.from_numpy(da.patch_center_rays(
            self.xfov, gh, gw, self.yfov)).to(self.device)
        return rays.expand(b, gh, gw, 3)

    @torch.no_grad()
    def _step(self, frames, h, w, work_hw):
        """One batch: uint8 (B, H, W, 3) on the device -> (depth (B, H, W),
        xfov (B,) or None)."""
        from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo

        model = self.model(work_hw)
        kind = self.graph[0] if self.graph else None
        if kind == "depthpro":
            return self._depthpro(model, frames, h, w)
        b = frames.shape[0]
        x = _resize_frames(frames, work_hw)
        if kind == "unidepth":
            d, _conf, _cam4 = model(x, self._rays(work_hw, b))
            d = resize_nchw(torch.clamp(d, 0.0, self.max_depth)[:, None],
                            (h, w))[:, 0]
            return d, torch.full((b,), float(self.xfov), device=d.device)
        cfg = self.cfg
        if cfg.k_condition or cfg.fov_head:
            rays = (self._rays(work_hw, b) if cfg.k_condition
                    and self.xfov is not None else None)
            out = model(x, rays)
        else:
            out = model(x)
        wh, ww = work_hw
        if cfg.point_head and self.variant == "moge":
            pts, mlogit = out
            fixed_f = (ww / wh / math.tan(math.radians(self.xfov) / 2.0)
                       if self.xfov else None)
            wts = torch.sigmoid(mlogit)
            # frame by frame: (33, H, W) temporaries per frame
            fs, ts = [], []
            for i in range(b):
                f, t, _ = geo.recover_focal_shift(pts[i], wts[i],
                                                  focal=fixed_f)
                fs.append(f)
                ts.append(t)
            fs, ts = torch.stack(fs), torch.stack(ts)
            d = pts[..., 2] + ts[:, None, None]
            d = torch.where(mlogit > 0, d, torch.full_like(d, math.nan))
            xf = (torch.full(fs.shape, float(self.xfov), device=d.device)
                  if self.xfov else
                  geo.xfov_from_normalized_focal(fs, wh, ww))
            d = torch.where(torch.isfinite(d), d,
                            torch.full_like(d, self.max_depth))
            d = torch.clamp(d, 0.0, self.max_depth)
        elif cfg.point_head:
            pts, mlogit = out
            fx, _ = geo.estimate_focal_from_points(pts, wh, ww,
                                                   torch.sigmoid(mlogit))
            xf = torch.rad2deg(2.0 * torch.atan2(
                torch.full_like(fx, ww / 2.0), torch.abs(fx) + 1e-6))
            d = torch.clamp(pts[..., 2], 0.0, self.max_depth)
        elif cfg.fov_head:
            d, xf = out
        else:
            d, xf = out, None
        return resize_nchw(d[:, None], (h, w))[:, 0], xf

    def infer_video(self, frames_u8, batch=16, return_fov=False):
        """(T, H, W, 3) uint8 -> (T, H, W) float32 metric depth (numpy);
        with ``return_fov``, also the per-frame xfov (T,) or None. The last
        batch is padded with its last frame."""
        t, h, w = frames_u8.shape[:3]
        work_hw = da.working_resolution(h, w, self.input_size,
                                        self.cfg.vit.patch_size)
        frames = torch.as_tensor(np.asarray(frames_u8))
        outs, fovs = [], []
        for i in range(0, t, batch):
            chunk = frames[i:i + batch]
            n = chunk.shape[0]
            if n < batch:
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    (batch - n,) + tuple(chunk.shape[1:]))])
            d, xf = self._step(chunk.to(self.device), h, w, work_hw)
            outs.append(d[:n].cpu())
            if xf is not None:
                fovs.append(xf[:n].to(torch.float32).cpu())
        depth = torch.cat(outs).numpy()
        if return_fov:
            return depth, (torch.cat(fovs).numpy() if fovs else None)
        return depth


@register_engine("single_frame")
def run_single_frame(color_video, max_depth=100.0, max_frames=-1,
                     engine=None, xfov=None, save_xfovs=False,
                     target_fps=-1, **kw):
    """Color video -> ``<video>_depth.mkv`` (+ ``_xfovs.json`` with
    ``save_xfovs``: the estimated per-frame FOV, else ``xfov`` or 50);
    returns the depth video's path."""
    from metric_depth_video_toolbox_tpu_torch.io import sidecar
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    eng = engine or SingleFrameEngine(max_depth=max_depth, xfov=xfov, **kw)
    frames, fps = vio.read_video_frames(color_video, max_frames=max_frames,
                                        target_fps=target_fps)
    depth, est_fovs = eng.infer_video(frames, return_fov=True)
    out = color_video + "_depth.mkv"
    vio.save_depth_video(depth, out, fps, max_depth)
    if save_xfovs:
        if est_fovs is not None:
            sidecar.save_xfovs(out + "_xfovs.json",
                               np.asarray(est_fovs, np.float32))
        else:
            xf = xfov if xfov is not None else 50.0
            sidecar.save_xfovs(out + "_xfovs.json",
                               np.full(frames.shape[0], xf, np.float32))
    return out


class DA3PipelineEngine:
    """DA3-class engine wrapper: depth + transformations + xfovs sidecars.
    ``size`` picks the DA3 preset (default ViT-L), ``input_size`` the
    working resolution; the other keywords go to
    :class:`~..models.da3.DA3Engine` (``cfg=`` chooses the attention
    route)."""

    def __init__(self, max_depth=100.0, size=None, input_size=None,
                 quantize=None, **kw):
        from metric_depth_video_toolbox_tpu_torch.models import da3 as da3_mod

        if quantize:
            raise NotImplementedError("not ported yet: --quantize "
                                      "(ROADMAP A13)")
        if size == "tiny":
            size = "vitt"
        if size is not None:
            kw.setdefault("cfg", da3_mod.preset(size))
        if input_size is not None:
            kw.setdefault("resolution", input_size)
        self.engine = da3_mod.DA3Engine(**kw)
        self.max_depth = max_depth


@register_engine("da3")
def run_da3(color_video, max_depth=100.0, max_frames=-1, engine=None, **kw):
    """Color video -> ``<video>_depth.mkv`` + ``_xfovs.json`` +
    ``_transformations.json``; returns the depth video's path."""
    from metric_depth_video_toolbox_tpu_torch.io import sidecar
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    eng = engine or DA3PipelineEngine(max_depth=max_depth, **kw)
    frames, fps = vio.read_video_frames(color_video, max_frames=max_frames)
    depth, c2w, xfovs = eng.engine.infer_video(frames)
    out = color_video + "_depth.mkv"
    vio.save_depth_video(np.clip(depth, 0, max_depth), out, fps, max_depth)
    sidecar.save_xfovs(out + "_xfovs.json", xfovs)
    sidecar.save_transformations(out + "_transformations.json", c2w)
    return out


_RUN_KEYS = ("max_depth", "max_frames", "reference_depth_video", "xfov",
             "yfov", "save_xfovs", "transformation_file", "target_fps")
_ENGINE_CLASSES = {"vda": VDAEngine, "single_frame": SingleFrameEngine,
                   "da3": DA3PipelineEngine}
# the JAX package's engines not ported yet, with their ROADMAP item
LATER_ENGINES = {"depthcrafter": "A13b", "geometrycrafter": "A13b",
                  "mvsa": "A13c"}


def run_batch(engine_name, videos_or_txt, **kw):
    """Batch mode: the model loads once and runs over every listed video;
    videos whose output exists already are skipped."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    if engine_name not in ENGINES:
        item = LATER_ENGINES.get(engine_name, "A13")
        raise NotImplementedError(f"not ported yet: depth engine "
                                  f"{engine_name!r} (ROADMAP {item})")
    fn = ENGINES[engine_name]
    run_kw = {k: v for k, v in kw.items() if k in _RUN_KEYS}
    eng_kw = {k: v for k, v in kw.items() if k not in _RUN_KEYS}
    if "max_depth" in kw:
        eng_kw["max_depth"] = kw["max_depth"]
    if engine_name in ("single_frame", "da3"):
        # the engine itself needs the FOV (ray conditioning, the focal
        # solve)
        for k in ("xfov", "yfov"):
            if kw.get(k) is not None:
                eng_kw[k] = kw[k]
    outs = []
    eng = None
    for v in expand_batch(videos_or_txt):
        out_path = v + "_depth.mkv"
        if vio.is_valid_video(out_path):
            outs.append(out_path)
            continue
        if eng is None:
            eng = _ENGINE_CLASSES[engine_name](**eng_kw)
        outs.append(fn(v, engine=eng, **run_kw))
    return outs
