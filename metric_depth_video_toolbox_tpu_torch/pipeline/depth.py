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

The diffusion engines run the SVD-class denoiser in windows:
:class:`DepthCrafterEngine` (relative disparity made metric against a
reference depth video) and :class:`GeometryCrafterEngine` (a prior's point
maps refined, with GeometryCrafter's point-map VAE when given).
:class:`MVSEngine` runs plane-sweep multi-view stereo over a camera track.
``quantize="int8"`` runs the ViT blocks' matmuls of the VDA, single-frame
and DA3 engines in int8 (``ops/quant.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from metric_depth_video_toolbox_tpu_torch.models import depth_anything as da
from metric_depth_video_toolbox_tpu_torch.models import diffusion as dif
from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import video_depth as vd
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device
from metric_depth_video_toolbox_tpu_torch.utils.timer import add, span


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

    ``data_parallel`` (default, as in the JAX package): with more than one
    card (``parallel.mesh.replicas``) the window's time axis splits over
    the largest count of them that divides the window (printed when it is
    fewer): the backbone and the DPT head run per replica on its frames,
    and each of the head's four motion modules gathers the whole window
    from every replica before it runs (``parallel.sharding.FrameReplicas``).
    On one card no mesh is built. The metric anchor runs on ``device``.
    """

    def __init__(self, size="vits", input_size=518, window=None,
                 overlap=None, params=None, anchor_params=None, rng_seed=0,
                 metric_anchor_frames=32, max_depth=100.0, fp32=False,
                 data_parallel=True, quantize=None, rolling_average=0,
                 anchor_stride=4, device=None):
        window = window or vd.VideoDepthConfig.window
        if overlap is None:
            overlap = min(vd.VideoDepthConfig.overlap, max(window // 4, 1))
        vit_cfg = vit_mod.PRESETS[size]
        dpt_cfg = dpt_mod.DPT_TINY if size == "vitt" else dpt_mod.DPTConfig()
        if fp32:
            vit_cfg = dataclasses.replace(vit_cfg, dtype="float32")
            dpt_cfg = dataclasses.replace(dpt_cfg, dtype="float32")
        if quantize:
            vit_cfg = dataclasses.replace(vit_cfg, quant=quantize)
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
        self._replicas = {}
        self.ignored_leaves = []
        self._mesh = None
        if data_parallel:
            from metric_depth_video_toolbox_tpu_torch.parallel import mesh
            self._mesh = mesh.engine_mesh(self.device, self.cfg.window,
                                          "window")

    def replicas(self, work_hw):
        """The video model's ``FrameReplicas`` over the frame mesh at a
        working resolution, or None without a mesh."""
        if self._mesh is None:
            return None
        work_hw = tuple(work_hw)
        if work_hw not in self._replicas:
            from metric_depth_video_toolbox_tpu_torch.parallel import \
                sharding
            self._replicas[work_hw] = sharding.FrameReplicas(
                self.models(work_hw)[0], self._mesh,
                {vd.TemporalModule: (0,)})
        return self._replicas[work_hw]

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
        with span("depth.video", frames=t):
            return self._infer_video(frames_u8, reference_depth, t, h, w)

    def _infer_video(self, frames_u8, reference_depth, t, h, w):
        work_hw = da.working_resolution(h, w, self.input_size,
                                        self.cfg.vit.patch_size)
        model, anchor = self.models(work_hw)
        frames = torch.as_tensor(np.asarray(frames_u8))
        disp = vd.infer_video_depth(model, frames, work_hw, (h, w),
                                    window=self.cfg.window,
                                    overlap=self.cfg.overlap,
                                    device=self.device,
                                    mesh=self.replicas(work_hw))
        anchor_hw = tuple(disp.shape[1:3])

        def anchor_depth(idx):
            if reference_depth is not None:
                ref = torch.as_tensor(np.asarray(reference_depth)[idx],
                                      device=self.device)
                return (_downsample_bilinear(ref, anchor_hw)
                        if tuple(ref.shape[1:3]) != anchor_hw else ref)
            with span("depth.anchor", device=self.device, frames=len(idx)):
                chunks = []
                for i in range(0, len(idx), 16):
                    with span("depth.to_device"):
                        x = frames[idx[i:i + 16]]
                        add("bytes", x.nbytes)
                        x = x.to(self.device)
                    chunks.append(da.infer_depth(anchor, x, anchor_hw,
                                                 work_hw))
                return torch.cat(chunks, dim=0)

        if self.rolling_average > 0:
            idx = np.arange(0, t, self.anchor_stride)
            inv_anchor = 1.0 / torch.clamp(anchor_depth(idx), min=1e-3)
            with span("depth.align"):
                s_t, t_t = solvers.rolling_scale_shift(
                    disp[idx], inv_anchor, idx, t,
                    window=self.rolling_average)
                inv = (disp * torch.as_tensor(s_t, device=self.device)[
                    :, None, None] + torch.as_tensor(
                        t_t, device=self.device)[:, None, None])
        else:
            idx = np.arange(min(self.metric_anchor_frames, t))
            inv_anchor = 1.0 / torch.clamp(anchor_depth(idx), min=1e-3)
            with span("depth.align"):
                s, sh = solvers.scale_and_shift(disp[:len(idx)], inv_anchor)
                inv = disp * s + sh
        depth = 1.0 / torch.clamp(inv, min=1e-6)
        depth = torch.where(inv <= 0, torch.full_like(depth, self.max_depth),
                            depth)
        depth = torch.clamp(depth, 0.0, self.max_depth)
        with span("depth.to_host"):
            out = depth.cpu().numpy()
            add("bytes", out.nbytes)
        return out


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

    ``data_parallel`` (default, as in the JAX package): with more than one
    card (``parallel.mesh.replicas``) the model is replicated on each, the
    batch rounded to a multiple of their count and each batch split across
    the replicas; on one card no mesh is built.
    """

    DEPTHPRO_MICRO_BATCH = 4

    def __init__(self, size="vits", input_size=518, params=None,
                 max_depth=100.0, rng_seed=0,
                 data_parallel=True, variant="da", xfov=None, yfov=None,
                 depthpro_cfg=None, quantize=None, moge_cfg=None,
                 unidepth_cfg=None, device=None):
        from metric_depth_video_toolbox_tpu_torch.models import depthpro
        from metric_depth_video_toolbox_tpu_torch.models import moge
        from metric_depth_video_toolbox_tpu_torch.models import unidepth

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
        if quantize:
            # the ViT blocks' matmuls of the graph that runs, in int8
            if self.graph is not None:
                kind, gcfg = self.graph
                self.graph = (kind, dataclasses.replace(
                    gcfg, vit=dataclasses.replace(gcfg.vit, quant=quantize)))
            else:
                self.cfg = dataclasses.replace(
                    self.cfg, vit=dataclasses.replace(self.cfg.vit,
                                                      quant=quantize))
        self.input_size = input_size
        self.max_depth = max_depth
        self.device = resolve_device(device)
        self._params = params
        self._seed = rng_seed
        self._models = {}
        self._replicas = {}
        self.ignored_leaves = []
        self._mesh = None
        if data_parallel:
            from metric_depth_video_toolbox_tpu_torch.parallel import mesh
            self._mesh = mesh.engine_mesh(self.device)

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

    def _rays(self, work_hw, b, device):
        p = (self.graph[1] if self.graph else self.cfg).vit.patch_size
        gh, gw = work_hw[0] // p, work_hw[1] // p
        rays = torch.from_numpy(da.patch_center_rays(
            self.xfov, gh, gw, self.yfov)).to(device)
        return rays.expand(b, gh, gw, 3)

    @torch.no_grad()
    def _step(self, model, frames, h, w, work_hw):
        """One batch through ``model`` (the engine's, or a replica): uint8
        (B, H, W, 3) on its device -> (depth (B, H, W), xfov (B,) or
        None)."""
        from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo

        kind = self.graph[0] if self.graph else None
        if kind == "depthpro":
            return self._depthpro(model, frames, h, w)
        b = frames.shape[0]
        x = _resize_frames(frames, work_hw)
        if kind == "unidepth":
            d, _conf, _cam4 = model(x, self._rays(work_hw, b, x.device))
            d = resize_nchw(torch.clamp(d, 0.0, self.max_depth)[:, None],
                            (h, w))[:, 0]
            return d, torch.full((b,), float(self.xfov), device=d.device)
        cfg = self.cfg
        if cfg.k_condition or cfg.fov_head:
            rays = (self._rays(work_hw, b, x.device) if cfg.k_condition
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
        batch is padded with its last frame. With a frame mesh, ``batch``
        is rounded to a multiple of its size, as in the JAX package."""
        t, h, w = frames_u8.shape[:3]
        work_hw = da.working_resolution(h, w, self.input_size,
                                        self.cfg.vit.patch_size)
        model = self.model(work_hw)
        step = functools.partial(self._step, h=h, w=w, work_hw=work_hw)
        if self._mesh is not None:
            from metric_depth_video_toolbox_tpu_torch.parallel import \
                sharding
            n = len(self._mesh)
            batch = max(batch, n) // n * n
            if work_hw not in self._replicas:
                self._replicas[work_hw] = sharding.FrameReplicas(
                    model, self._mesh)
            reps = self._replicas[work_hw]
            run = functools.partial(reps, step)
        else:
            run = functools.partial(step, model)
        frames = torch.as_tensor(np.asarray(frames_u8))
        outs, fovs = [], []
        for i in range(0, t, batch):
            chunk = frames[i:i + batch]
            n = chunk.shape[0]
            if n < batch:
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    (batch - n,) + tuple(chunk.shape[1:]))])
            d, xf = run(chunk.to(self.device))
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

        if size == "tiny":
            size = "vitt"
        if size is not None:
            kw.setdefault("cfg", da3_mod.preset(size))
        if quantize:
            cfg = kw.get("cfg") or da3_mod.preset("vitl")
            kw["cfg"] = dataclasses.replace(
                cfg, vit=dataclasses.replace(cfg.vit, quant=quantize))
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


def _build_denoiser(cfg, vae_cfg=None, mono=False):
    """The diffusion depth engines' denoiser: an ``SVDConfig`` (it has a
    cross_attention_dim) selects the weight-exact SVD graph
    (``models.svd.SVDInpainter``; DepthCrafter and GeometryCrafter are SVD
    fine-tunes), a ``DiffusionConfig`` the generic ``VideoInpainter``.
    ``mono``: the conditioning carries a second latent (GeometryCrafter's
    point map), so the UNet takes 4 more channels."""
    if hasattr(cfg, "cross_attention_dim"):
        from metric_depth_video_toolbox_tpu_torch.models import svd as svdm
        return svdm.SVDInpainter(cfg, vae_cfg or svdm.SVDVAEConfig(),
                                 mono=mono)
    return dif.VideoInpainter(cfg, mono=mono)


def _windows(t, window, overlap):
    """Start frames of the sliding windows over ``t`` frames, and each
    window's frame indices: past the clip's end the last frame repeats, so
    a short clip runs one full window."""
    out = []
    start, step = 0, max(window - overlap, 1)
    while start < t:
        out.append((start, np.clip(np.arange(start, start + window), 0,
                                   t - 1)))
        if start + window >= t:
            break
        start += step
    return out


class _DiffusionDepthEngine:
    """What the DepthCrafter and GeometryCrafter engines share: the
    denoiser (``_build_denoiser``), its weights (``params``: a port state
    dict or a Flax tree; None draws seeded ones from ``rng_seed``), the
    sampler's noise from a ``torch.Generator`` on the engine's device, and
    the window loop."""

    mono = False

    def __init__(self, cfg, params, vae_cfg, window, overlap, rng_seed,
                 max_depth, device):
        self.cfg = cfg or dif.DIFFUSION_TINY
        self.vae_cfg = vae_cfg
        self.window = window
        self.overlap = overlap
        self.max_depth = max_depth
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rng_seed)
        self._params = params
        self._model = None

    @property
    def model(self):
        """The denoiser, built on the engine's device at first use."""
        if self._model is None:
            with torch.device(self.device):
                model = _build_denoiser(self.cfg, self.vae_cfg, self.mono)
            if self._params is None:
                dif.init_weights(model, self.generator)
            else:
                from_jax.load_params(model, self._params)
            self._params = None
            self._model = dif.store_in_compute_dtype(model).eval()
        return self._model

    def _sample(self, latent, cond, noise=None, init=None):
        """Denoised latents of ``latent``'s shape. ``noise``: the sampler's
        standard normal draw, from the engine's generator when None."""
        if noise is None:
            noise = torch.randn(latent.shape, generator=self.generator,
                                device=self.device)
        model = self.model
        return dif.sample(lambda zz, s, c: model.denoise(zz, s, c),
                          torch.as_tensor(noise, device=self.device),
                          self.cfg, cond, init=init)

    def _run_windows(self, frames_u8, per_window, noise=None):
        """``per_window(idx, noise)`` -> (window, H, W) on the device, over
        every window; the windows' new frames stitched -> (T, H, W).
        ``noise``: None, or one noise array per window."""
        t = frames_u8.shape[0]
        outs = []
        for n_w, (start, idx) in enumerate(_windows(t, self.window,
                                                    self.overlap)):
            d = per_window(idx, None if noise is None else noise[n_w])
            outs.append(d[:min(self.window, t - start)])
        if len(outs) > 1:
            return vd.stitch_windows(outs, self.overlap, t)
        return outs[0][:t]


class DepthCrafterEngine(_DiffusionDepthEngine):
    """DepthCrafter-class video depth by diffusion: relative disparity in
    windows (110 / 25, the denoiser's own steps), stitched, then made
    metric against a reference depth video by a scale/shift fit of its
    inverse.

    ``cfg``: None (``DIFFUSION_TINY``, the JAX package's default too) or
    an ``SVDConfig`` (the production SVD graph, with ``vae_cfg``, default
    ``SVDVAEConfig()``). ``work_hw`` None: from the clip's aspect ratio,
    the long side at most ``max_res``, each side rounded to a multiple of
    64 (1080p -> 448 x 768). ``use_depth_prompting``: the reference depth's
    normalized inverse rides into the sampler as an SDEdit-style init
    latent through the VAE. Other keywords (the movie's generic engine
    keywords) are ignored, as in the JAX package."""

    def __init__(self, cfg=None, params=None, window=110, overlap=25,
                 work_hw=None, max_res=768, rng_seed=0, max_depth=100.0,
                 vae_cfg=None, use_depth_prompting=False, device=None, **_):
        super().__init__(cfg, params, vae_cfg, window, overlap, rng_seed,
                         max_depth, device)
        self.work_hw = None if work_hw is None else tuple(work_hw)
        self.max_res = max_res
        self.use_depth_prompting = use_depth_prompting

    def _resolve_work_hw(self, h, w):
        if self.work_hw is None:
            s = min(1.0, self.max_res / max(h, w))
            self.work_hw = (max(64, int(round(h * s / 64)) * 64),
                            max(64, int(round(w * s / 64)) * 64))
        return self.work_hw

    @torch.no_grad()
    def infer_window(self, frames_u8, ref_depth=None, noise=None):
        """One window: uint8 (T, H, W, 3) -> relative disparity (T, H, W) on
        the device. ``ref_depth`` (T, H, W) prompts the sampler with
        ``use_depth_prompting``."""
        from metric_depth_video_toolbox_tpu_torch.ops import image as im

        t, h, w = frames_u8.shape[:3]
        wh, ww = self._resolve_work_hw(h, w)
        model, dev = self.model, self.device
        f = torch.as_tensor(np.ascontiguousarray(frames_u8), device=dev)
        fw = im.resize(f.to(torch.float32) / 255.0, (wh, ww))
        cond_lat = model.encode(fw)
        cond = torch.cat([cond_lat, torch.zeros(
            tuple(cond_lat.shape[:3]) + (1,), device=dev,
            dtype=cond_lat.dtype)], dim=-1)
        init = None
        if self.use_depth_prompting and ref_depth is not None:
            dref = torch.as_tensor(np.ascontiguousarray(ref_depth),
                                   device=dev).to(torch.float32)
            inv = 1.0 / torch.clamp(dref, min=1e-3)
            inv = inv / torch.clamp(torch.amax(inv), min=1e-6)
            dimg = im.resize(inv[..., None].expand(-1, -1, -1, 3), (wh, ww))
            init = model.encode(dimg)
        z = self._sample(cond_lat, cond, noise, init)
        disp = model.decode(z).to(torch.float32).mean(dim=-1)
        return resize_nchw(disp[:, None], (h, w))[:, 0]

    @torch.no_grad()
    def infer_video(self, frames_u8, reference_depth, noise=None):
        """uint8 (T, H, W, 3) and the reference metric depth (T, H, W) ->
        metric depth (T, H, W) float32 numpy. ``noise``: None, or the
        sampler's draw for each window."""
        t = frames_u8.shape[0]
        ref = np.asarray(reference_depth)
        disp = self._run_windows(frames_u8, lambda idx, nz: self.infer_window(
            frames_u8[idx], ref[idx] if self.use_depth_prompting else None,
            nz), noise)
        target = 1.0 / torch.clamp(torch.as_tensor(
            np.ascontiguousarray(ref[:t]), device=self.device).to(
                torch.float32), min=1e-3)
        s, sh = solvers.scale_and_shift(disp, target)
        inv = disp * s + sh
        depth = 1.0 / torch.clamp(inv, min=1e-6)
        depth = torch.where(inv <= 0, torch.full_like(depth, self.max_depth),
                            depth)
        return torch.clamp(depth, 0.0, self.max_depth).cpu().numpy()


class GeometryCrafterEngine(_DiffusionDepthEngine):
    """GeometryCrafter-class depth stabilizer: the prior depth (a depth
    video, or MoGe's) is unprojected to point maps at the working size
    (384 x 640) and normalized by the window's median z; the denoiser is
    conditioned on the RGB latent, a zero mask and the point-map latent;
    its refined point map's Z channel, de-normalized, is the depth, which
    is stitched over windows (110 / 5) and rescaled to the prior by the
    median ratio.

    ``pmap_vae_params``: a converted point-map VAE (``convert_svd_vae`` at
    ``PMAP_VAE``, config inferred from the tree unless ``pmap_vae_cfg``)
    encodes the point maps and decodes xyz and a valid-mask logit;
    without it the shared denoiser VAE stands in. ``xfov`` (default 60)
    unprojects the prior."""

    mono = True

    def __init__(self, cfg=None, params=None, window=110, overlap=5,
                 work_hw=(384, 640), rng_seed=0, max_depth=100.0, xfov=60.0,
                 vae_cfg=None, pmap_vae_params=None, pmap_vae_cfg=None,
                 device=None, **_):
        super().__init__(cfg, params, vae_cfg, window, overlap, rng_seed,
                         max_depth, device)
        self.work_hw = tuple(work_hw)
        self.xfov = xfov or 60.0
        self.pmap_enc = self.pmap_dec = None
        if pmap_vae_params is not None:
            from metric_depth_video_toolbox_tpu_torch.models import svd as svdm
            pcfg = pmap_vae_cfg or svdm.vae_config_from_params(
                pmap_vae_params)
            with torch.device(self.device):
                enc, dec = svdm.SVDVAEEncoder(pcfg), svdm.SVDVAEDecoder(pcfg)
            for mod, part in ((enc, "encoder"), (dec, "decoder")):
                from_jax.load_params(mod, pmap_vae_params[part])
            self.pmap_enc = dif.store_in_compute_dtype(enc).eval()
            self.pmap_dec = dif.store_in_compute_dtype(dec).eval()

    @torch.no_grad()
    def infer_window(self, frames_u8, prior_depth, noise=None):
        """One window: uint8 (T, H, W, 3) and the prior depth (T, H, W) ->
        depth (T, H, W) on the device, before the median-ratio rescale."""
        from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
        from metric_depth_video_toolbox_tpu_torch.ops import image as im

        t, h, w = frames_u8.shape[:3]
        wh, ww = self.work_hw
        model, dev = self.model, self.device
        f = torch.as_tensor(np.ascontiguousarray(frames_u8), device=dev)
        fw = im.resize(f.to(torch.float32) / 255.0, (wh, ww))
        prior = torch.as_tensor(np.ascontiguousarray(prior_depth),
                                device=dev).to(torch.float32)
        pw = resize_nchw(prior[:, None], (wh, ww))[:, 0]
        k = geo.camera_matrix_from_fov(ww, wh, xfov_deg=self.xfov, device=dev)
        scale = torch.clamp(solvers.median(pw), min=1e-3)
        pmap = geo.unproject_depth(pw, k) / scale
        rgb_lat = model.encode(fw)
        pmap_lat = (self.pmap_enc(pmap) if self.pmap_enc is not None
                    else model.encode(pmap))
        cond = torch.cat([rgb_lat, torch.zeros(
            tuple(rgb_lat.shape[:3]) + (1,), device=dev,
            dtype=rgb_lat.dtype), pmap_lat.to(rgb_lat.dtype)], dim=-1)
        z = self._sample(rgb_lat, cond, noise)
        out = (self.pmap_dec(z) if self.pmap_dec is not None
               else model.decode(z))
        zd = out[..., 2].to(torch.float32) * scale
        return resize_nchw(zd[:, None], (h, w))[:, 0]

    @torch.no_grad()
    def infer_video(self, frames_u8, reference_depth, noise=None):
        """uint8 (T, H, W, 3) and the prior depth (T, H, W) -> stabilized
        depth (T, H, W) float32 numpy. ``noise``: None, or the sampler's
        draw for each window."""
        t = frames_u8.shape[0]
        ref = np.asarray(reference_depth)
        depth = self._run_windows(frames_u8, lambda idx, nz: self.infer_window(
            frames_u8[idx], ref[idx], nz), noise)
        prior = torch.as_tensor(np.ascontiguousarray(ref[:t]),
                                device=self.device).to(torch.float32)
        ok = (depth > 1e-3) & (prior > 1e-3)
        if bool(ok.any()):
            depth = depth * solvers.median(prior[ok] / depth[ok])
        return torch.clamp(depth, 0.0, self.max_depth).cpu().numpy()


@register_engine("geometrycrafter")
def run_geometrycrafter(color_video, max_depth=100.0, max_frames=-1,
                        engine=None, reference_depth_video=None, xfov=None,
                        **kw):
    """Stabilize a prior: the reference depth video, or, without one, a
    MoGe single-frame pass (``size`` and ``input_size`` from ``kw``) ->
    ``<video>_depth.mkv``; returns its path."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    frames, fps = vio.read_video_frames(color_video, max_frames=max_frames)
    eng = engine or GeometryCrafterEngine(max_depth=max_depth, xfov=xfov,
                                          **kw)
    if reference_depth_video and vio.is_valid_video(reference_depth_video):
        with vio.DepthVideoReader(reference_depth_video, max_depth) as r:
            prior = r.read_depth_batch(frames.shape[0])
    else:
        moge = SingleFrameEngine(max_depth=max_depth, variant="moge",
                                 xfov=xfov, device=eng.device,
                                 **{k: v for k, v in kw.items()
                                    if k in ("size", "input_size")})
        prior = moge.infer_video(frames)
        del moge
    depth = eng.infer_video(frames, prior)
    out = color_video + "_depth.mkv"
    vio.save_depth_video(depth, out, fps, max_depth)
    return out


@register_engine("depthcrafter")
def run_depthcrafter(color_video, max_depth=100.0, max_frames=-1,
                     engine=None, reference_depth_video=None, **kw):
    """Color video and a reference depth video -> ``<video>_depth.mkv``;
    returns its path."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    if reference_depth_video is None:
        raise ValueError("depthcrafter engine requires a reference depth "
                         "video for metric alignment")
    eng = engine or DepthCrafterEngine(max_depth=max_depth, **kw)
    frames, fps = vio.read_video_frames(color_video, max_frames=max_frames)
    with vio.DepthVideoReader(reference_depth_video, max_depth) as r:
        ref = r.read_depth_batch(frames.shape[0])
    depth = eng.infer_video(frames, ref)
    out = color_video + "_depth.mkv"
    vio.save_depth_video(depth, out, fps, max_depth)
    return out


class MVSEngine:
    """MVSAnywhere-class pose-conditioned plane-sweep MVS
    (``models.mvs.MVSNet``): each frame against a window of +-``window``//2
    source views from the camera track, at ``resize_w`` wide (aspect kept,
    sides multiples of 4), in batches of ``batch`` frames (the last frame
    repeated); the refined depth, resized back by nearest neighbour.

    ``size``: "base" (``MVSConfig``) or "tiny" / "vitt" (``MVS_TINY``).
    ``rescale_to_cost_volume``: each frame times the median ratio of its
    cost-volume depth to its refined depth over the confident pixels.
    ``fast_cost_volume``: half the hypotheses (at least 8). ``params``: a
    Flax tree or a port state dict; None draws seeded weights.
    ``data_parallel`` (default): with more than one card
    (``parallel.mesh.replicas``) ``batch`` is rounded to a multiple of
    their count and each batch's references, sources, poses and
    validities split across replicas of the model; on one card no mesh is
    built."""

    def __init__(self, size="base", max_depth=100.0, window=7,
                 resize_w=1024, params=None, batch=4, rng_seed=0,
                 rescale_to_cost_volume=False, data_parallel=True,
                 fast_cost_volume=False, device=None, **_):
        from metric_depth_video_toolbox_tpu_torch.models import mvs as mvs_mod

        self.cfg = mvs_mod.preset(size, max_depth=max_depth)
        if fast_cost_volume:
            self.cfg = dataclasses.replace(
                self.cfg, num_depths=max(8, self.cfg.num_depths // 2))
        self.max_depth = max_depth
        self.half_w = max(1, int(window) // 2)
        self.resize_w = resize_w
        self.batch = batch
        self.rescale = rescale_to_cost_volume
        self.device = resolve_device(device)
        self._params = params
        self._seed = rng_seed
        self._model = None
        self._replicas = None
        self._mesh = None
        if data_parallel:
            from metric_depth_video_toolbox_tpu_torch.parallel import mesh
            self._mesh = mesh.engine_mesh(self.device)
        if self._mesh is not None:
            n = len(self._mesh)
            self.batch = max(self.batch, n) // n * n

    @property
    def model(self):
        from metric_depth_video_toolbox_tpu_torch.models import mvs as mvs_mod

        if self._model is None:
            model = mvs_mod.MVSNet(self.cfg)
            if self._params is None:
                dif.init_weights(model, torch.Generator().manual_seed(
                    self._seed))
            else:
                from_jax.load_params(model, self._params)
            self._model = model.to(self.device).eval()
        return self._model

    def _window_indices(self, i, n):
        """Source indices around frame i, padded to 2 * half_w with i
        itself marked invalid -> (indices, validity)."""
        idx = [j for j in range(i - self.half_w, i + self.half_w + 1)
               if 0 <= j < n and j != i]
        if not idx:
            idx = [min(n - 1, max(0, i + 1))]
        valid = [1.0] * len(idx)
        v = 2 * self.half_w
        while len(idx) < v:
            idx.append(i)
            valid.append(0.0)
        return idx[:v], valid[:v]

    @torch.no_grad()
    def infer_video(self, frames_u8, transforms, xfov, yfov=None):
        """uint8 (N, H, W, 3), camera-to-world (N, 4, 4) and the FOV ->
        metric depth (N, H, W) float32 numpy."""
        from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
        from metric_depth_video_toolbox_tpu_torch.ops import image as im

        n, h, w = frames_u8.shape[:3]
        dev = self.device
        scale = min(1.0, self.resize_w / w)
        wh = int(round(h * scale)) // 4 * 4
        ww = int(round(w * scale)) // 4 * 4
        k_work = geo.camera_matrix_from_fov(ww, wh, xfov, yfov).numpy()
        k_feat = torch.tensor(np.diag([0.25, 0.25, 1.0]) @ k_work,
                              dtype=torch.float32, device=dev)
        frames = torch.as_tensor(np.asarray(frames_u8))
        small = torch.cat([im.resize(frames[i:i + 16].to(dev).to(
            torch.float32), (wh, ww)) for i in range(0, n, 16)])
        c2w = np.asarray(transforms, np.float32)
        w2c = np.stack([np.linalg.inv(t) for t in c2w])
        model = self.model
        if self._mesh is not None and self._replicas is None:
            from metric_depth_video_toolbox_tpu_torch.parallel import \
                sharding
            self._replicas = sharding.FrameReplicas(model, self._mesh)

        def run(m, refs, srcs, poses, valids):
            return m(refs, srcs, k_feat.to(refs.device), poses, valids)
        outs = []
        b = self.batch
        for start in range(0, n, b):
            ids = list(range(start, min(start + b, n)))
            ids += [ids[-1]] * (b - len(ids))
            srcs, poses, valids = [], [], []
            for i in ids:
                idx, val = self._window_indices(i, n)
                srcs.append(idx)
                poses.append(np.stack([w2c[j] @ c2w[i] for j in idx]))
                valids.append(val)
            batch = (small[ids] / 255.0,
                     small[torch.tensor(srcs, device=dev)] / 255.0,
                     torch.from_numpy(np.stack(poses)).to(dev),
                     torch.tensor(valids, device=dev))
            out = (run(model, *batch) if self._replicas is None
                   else self._replicas(run, *batch))
            d = out["depth"]
            if self.rescale:
                s = torch.stack([solvers.median_ratio_scale(
                    out["depth_cv"][i], d[i], out["mask"][i].to(
                        torch.float32)) for i in range(b)])
                d = d * s[:, None, None]
            d = dif.resize_nearest(d[:, None], (h, w))[:, 0]
            outs.append(torch.clamp(d, 0.0, self.max_depth)[
                :min(b, n - start)].cpu())
        return torch.cat(outs).numpy()[:n]


@register_engine("mvsa")
def run_mvsa(color_video, max_depth=100.0, max_frames=-1, engine=None,
             transformation_file=None, xfov=None, yfov=None, **kw):
    """Color video, its camera track and FOV -> ``<video>_depth.mkv``;
    returns its path."""
    from metric_depth_video_toolbox_tpu_torch.io import sidecar
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    if transformation_file is None:
        raise ValueError("mvsa engine requires --transformation_file")
    if xfov is None and yfov is None:
        raise ValueError("mvsa engine requires --xfov or --yfov")
    eng = engine or MVSEngine(max_depth=max_depth, **kw)
    frames, fps = vio.read_video_frames(color_video, max_frames=max_frames)
    transforms = sidecar.load_transformations(transformation_file)
    if len(transforms) < frames.shape[0]:
        raise ValueError(
            f"transformation file has {len(transforms)} entries for "
            f"{frames.shape[0]} frames")
    depth = eng.infer_video(frames, transforms[:frames.shape[0]], xfov, yfov)
    out = color_video + "_depth.mkv"
    vio.save_depth_video(depth, out, fps, max_depth)
    return out


_RUN_KEYS = ("max_depth", "max_frames", "reference_depth_video", "xfov",
             "yfov", "save_xfovs", "transformation_file", "target_fps")
_ENGINE_CLASSES = {"vda": VDAEngine, "single_frame": SingleFrameEngine,
                   "da3": DA3PipelineEngine,
                   "depthcrafter": DepthCrafterEngine,
                   "geometrycrafter": GeometryCrafterEngine,
                   "mvsa": MVSEngine}


def run_batch(engine_name, videos_or_txt, **kw):
    """Batch mode: the model loads once and runs over every listed video;
    videos whose output exists already are skipped."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

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
    if engine_name == "geometrycrafter" and kw.get("xfov") is not None:
        eng_kw["xfov"] = kw["xfov"]    # the point maps' unprojection
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
