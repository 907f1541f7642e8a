"""Depth estimation stage: color video -> RGB-encoded metric depth video
(PyTorch port of the VDA and DA3 engines of ``pipeline/depth.py``).

The VDA engine runs Video-Depth-Anything over overlapping windows,
stitched, and makes the relative disparity metric with a closed-form
scale/shift fit against a per-frame Depth-Anything metric anchor (or a
reference depth video). Without weights the engine draws them from a
seeded ``torch.Generator``; plumbing and throughput are the same.

The DA3 engine (:class:`DA3PipelineEngine`, ``models.da3.DA3Engine``) runs
multi-view windows and writes the depth video with its ``_xfovs.json`` and
``_transformations.json`` sidecars.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from metric_depth_video_toolbox_tpu_torch.models import depth_anything as da
from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import video_depth as vd
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def _downsample_bilinear(frames, out_hw):
    """(T, h, w) float32 -> (T, out_h, out_w), plain bilinear with
    half-pixel centers and no antialias (the JAX engine's cv2
    INTER_LINEAR for a reference depth video of another size)."""
    return F.interpolate(frames[:, None], size=tuple(out_hw),
                         mode="bilinear", align_corners=False)[:, 0]


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

    ``params`` / ``anchor_params``: state dicts of
    :class:`~..models.video_depth.VideoDepthAnything` and
    :class:`~..models.depth_anything.DepthAnything` (e.g. from
    ``models.from_jax``) at the clip's working resolution; None draws
    seeded weights (``rng_seed``). ``fp32`` selects float32 compute
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
                    mod.load_state_dict(sd, strict=True)
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
             "yfov", "target_fps")
_ENGINE_CLASSES = {"vda": VDAEngine, "da3": DA3PipelineEngine}


def run_batch(engine_name, videos_or_txt, **kw):
    """Batch mode: the model loads once and runs over every listed video;
    videos whose output exists already are skipped."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    if engine_name not in ENGINES:
        raise NotImplementedError(f"not ported yet: depth engine "
                                  f"{engine_name!r} (ROADMAP A13)")
    fn = ENGINES[engine_name]
    run_kw = {k: v for k, v in kw.items() if k in _RUN_KEYS}
    eng_kw = {k: v for k, v in kw.items() if k not in _RUN_KEYS}
    if "max_depth" in kw:
        eng_kw["max_depth"] = kw["max_depth"]
    if engine_name == "da3":
        # the engine itself needs the FOV (ray conditioning)
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
