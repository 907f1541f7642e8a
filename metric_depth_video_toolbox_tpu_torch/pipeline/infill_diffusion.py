"""Diffusion infill of SBS video (PyTorch port of
``pipeline/infill_diffusion.py``): the SVD-class engines (stereocrafter,
m2svid, the ``diffusion`` engine) and the InSpatio-World-class causal
engine, behind one chunk loop.

:class:`DiffusionInfillEngine` runs ``models.diffusion.VideoInpainter`` (or,
with an ``SVDConfig``, the weight-exact ``models.svd.SVDInpainter``) at a
fixed working size: the masked frames and the hole mask are encoded to
latents (plus the mono video's latent with ``mono_conditioning``, plus a
CLIP embedding of the first masked frame with ``clip_params``), the
sampler denoises from noise, and the decoded frames are resized back,
LHM colour-matched against the non-hole pixels and pasted inside the holes.

:class:`CausalInfillEngine` runs the Wan-class causal DiT over Wan-VAE
latents, conditioned on three latent videos: the render with its holes
blacked out, the source video (encoded once and shared by both eyes), and
the hole mask (4 temporal channels per latent frame). The chunk pads so its
latent frames split into causal blocks of 3; the sampler generates them
block by block in a few flow steps; the decode is interleaved with the
composite, so the full decoded video never exists at once.

:func:`infill_sbs_frames` is the per-eye chunk loop on in-memory arrays,
with the lower-edge halo blend; :func:`infill_sbs_video_diffusion` reads and
writes the files around it; :func:`infill_sbs_video_external` runs a
user's command with the same file contract.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.models import diffusion as dif
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import wan as wan_mod
from metric_depth_video_toolbox_tpu_torch.ops import drift as dr
from metric_depth_video_toolbox_tpu_torch.ops import image as im
from metric_depth_video_toolbox_tpu_torch.ops import infill as infill_ops
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device
from metric_depth_video_toolbox_tpu_torch.utils.timer import span


class DiffusionInfillEngine:
    """SVD-class infill of one eye's chunk at a fixed working size.

    ``cfg``: a ``DiffusionConfig`` (default ``DIFFUSION_TINY``) or an
    ``SVDConfig`` (the weight-exact StereoCrafter graph, with ``vae_cfg``,
    default ``SVDVAEConfig()``). ``params``: the inpainter's weights as a
    port state dict or a Flax tree; None draws seeded weights (``rng_seed``)
    with a ``torch.Generator`` on the engine's device. ``clip_params``
    (state dict or Flax tree of ``models.clip.CLIPVisionTower`` at
    ``clip_cfg``, default ``CLIP_VIT_H``) conditions the SVD graph's
    cross-attention on the CLIP embedding of the chunk's first masked
    frame.

    ``data_parallel`` (default, as in the JAX package): with more than one
    card (``parallel.mesh.replicas``) the chunk's time axis splits over the
    largest count of them that divides ``chunk`` (printed when it is
    fewer): the VAE and the denoiser run per replica on its frames, and the
    layers that mix frames (the UNet's temporal attentions; in the SVD
    graph its temporal resnet blocks, its spatio-temporal transformers and
    the decoder's temporal layers) gather the whole chunk from every
    replica (``parallel.sharding.FrameReplicas``). The noise is drawn on
    ``device`` from the engine's generator, the same draws with and without
    a mesh. On one card no mesh is built.

    ``on_latents``: None, or a callable that ``infill_chunk`` calls with
    each chunk's sampled latents (T, lh, lw, latent) before they are
    decoded.
    """

    def __init__(self, cfg=None, params=None, work_hw=(256, 256),
                 chunk=25, overlap=6, rng_seed=0, mono_conditioning=False,
                 data_parallel=True, vae_cfg=None, clip_params=None,
                 clip_cfg=None, device=None):
        self.cfg = cfg or dif.DIFFUSION_TINY
        self.vae_cfg = vae_cfg
        self.clip_cfg = clip_cfg
        self.work_hw = tuple(work_hw)
        self.chunk = chunk
        self.overlap = overlap
        self.mono_conditioning = mono_conditioning
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rng_seed)
        self._params = params
        self._clip_params = clip_params
        self.model = self.clip = self._replicas = None
        self.on_latents = None
        self._mesh = None
        if data_parallel:
            from metric_depth_video_toolbox_tpu_torch.parallel import mesh
            self._mesh = mesh.engine_mesh(self.device, chunk, "chunk")

    def _ensure(self):
        if self.model is not None:
            return
        with torch.device(self.device):
            if hasattr(self.cfg, "cross_attention_dim"):
                from metric_depth_video_toolbox_tpu_torch.models import \
                    svd as svdm
                model = svdm.SVDInpainter(
                    self.cfg, self.vae_cfg or svdm.SVDVAEConfig(),
                    mono=self.mono_conditioning)
                if self._clip_params is not None:
                    from metric_depth_video_toolbox_tpu_torch.models import \
                        clip as clip_mod
                    self.clip = from_jax.load_params(clip_mod.CLIPVisionTower(
                        self.clip_cfg or clip_mod.CLIP_VIT_H),
                        self._clip_params).eval()
            else:
                model = dif.VideoInpainter(self.cfg,
                                           mono=self.mono_conditioning)
        if self._params is None:
            dif.init_weights(model, self.generator)
        else:
            from_jax.load_params(model, self._params)
        self._params = self._clip_params = None
        self.model = dif.store_in_compute_dtype(model).eval()
        if self._mesh is not None:
            from metric_depth_video_toolbox_tpu_torch.models import \
                svd as svdm
            from metric_depth_video_toolbox_tpu_torch.parallel import \
                sharding
            self._replicas = sharding.FrameReplicas(self.model, self._mesh, {
                dif.TemporalAttention: (0,), svdm.TemporalResnetBlock: (0, 0),
                svdm.TransformerST: (0, 0), svdm.TimeConv: (2,)})

    def _frames(self, fn, *batches):
        """``fn(model, *batches)``, split over the frame mesh when there
        is one."""
        if self._replicas is None:
            return fn(self.model, *batches)
        return self._replicas(fn, *batches)

    def num_parameters(self):
        """Parameters of the inpainter (and of the CLIP tower, if any)."""
        self._ensure()
        mods = [self.model] + ([self.clip] if self.clip is not None else [])
        return sum(p.numel() for m in mods for p in m.parameters())

    def _to_work(self, frames_u8):
        """(T, H, W, 3) uint8 on the device -> (T, wh, ww, 3) in [0, 1],
        bilinear (antialiased when shrinking)."""
        return im.resize(frames_u8.float() / 255.0, self.work_hw)

    @torch.no_grad()
    def infill_chunk(self, frames_u8, hole_mask, mono_u8=None, noise=None):
        """(T, H, W, 3) uint8 + (T, H, W) bool holes -> infilled (T, H, W, 3)
        uint8 numpy. ``mono_u8``: the source view's frames, the
        conditioning of an engine built with ``mono_conditioning`` (zeros
        when None). ``noise``: the sampler's standard normal draw (T, lh,
        lw, latent), from the engine's generator when None."""
        self._ensure()
        dev = self.device
        f_dev = torch.as_tensor(np.ascontiguousarray(frames_u8), device=dev)
        m_dev = torch.as_tensor(np.ascontiguousarray(hole_mask), device=dev)
        h, w = f_dev.shape[1:3]
        with span("infill.encode"):
            fw = self._to_work(f_dev)
            mw = resize_mask(m_dev, self.work_hw)
            masked = fw * (1.0 - mw[..., None])
            del fw
            cond_lat = self._frames(lambda m, x: m.encode(x), masked)
            # the mask on the latent grid: the antialiased linear shrink
            parts = [cond_lat, im.resize(mw[..., None], cond_lat.shape[1:3])]
            if self.mono_conditioning:
                mono = (torch.zeros_like(f_dev) if mono_u8 is None else
                        torch.as_tensor(np.ascontiguousarray(mono_u8),
                                        device=dev))
                parts.append(self._frames(lambda m, x: m.encode(x),
                                          self._to_work(mono)))
            cond = torch.cat(parts, dim=-1)
            ctx = None
            if self.clip is not None:
                from metric_depth_video_toolbox_tpu_torch.models import \
                    clip as clip_mod
                # the SVD graph cross-attends to the CLIP embedding of the
                # conditioning frame (chunk frame 0)
                ctx = self.clip(clip_mod.preprocess(
                    masked[:1], self.clip.cfg.image_size))[:, None, :]
            del masked
        if noise is None:
            noise = torch.randn(cond_lat.shape, generator=self.generator,
                                device=dev)
        def denoise(zz, s, c):
            return self._frames(lambda m, z_, c_: m.denoise(
                z_, s.to(z_.device), c_,
                None if ctx is None else ctx.to(z_.device)), zz, c)

        with span("infill.sample"):
            z = dif.sample(denoise, noise.to(dev), self.cfg, cond)
        del cond
        if self.on_latents is not None:
            self.on_latents(z)
        with span("infill.decode_composite"):
            out = im.resize(self._frames(lambda m, zz: m.decode(zz), z)
                            .float(), (h, w)) * 255.0
            return _paste(out, f_dev, m_dev).cpu().numpy()


class CausalInfillEngine:
    """InSpatio-World-class infill: a Wan-rate causal video DiT over
    Wan-VAE latents (``models.wan``).

    ``params``: ``{"dit", "enc", "dec"}``, each a port state dict or a
    tree in the JAX package's Flax layout (a converted checkpoint: e.g.
    ``convert_wan``'s tree as ``dit``); None draws seeded weights
    (``rng_seed``). A bare ``convert_wan`` tree, the DiT alone, raises
    ``KeyError``, as it fails in the JAX engine. In
    bfloat16 mode the DiT's parameters are stored in bfloat16 (every matmul
    casts to bfloat16 anyway). The initial noise of each chunk is drawn from
    the engine's ``torch.Generator`` unless ``infill_chunk`` is given one.

    ``on_latents``: None, or a callable that ``infill_chunk`` calls with
    each chunk's sampled latents (1, T_lat, lh, lw, z_ch) before they are
    decoded (to check or record them; its result is ignored).
    """

    # frames per streamed encode segment (a multiple of 4) and latents per
    # interleaved decode + composite segment; streaming is exact, so these
    # only bound the memory of the VAE's full-resolution activations
    ENC_SEG = 16
    DEC_SEG = 4

    def __init__(self, cfg=None, params=None, work_hw=(480, 832),
                 chunk=225, overlap=6, rng_seed=0, mono_conditioning=True,
                 data_parallel=True, device=None):
        del data_parallel   # one card runs the chunk, as in the JAX package
        self.cfg = cfg or wan_mod.WAN_1_3B
        self.work_hw = tuple(work_hw)
        self.chunk = chunk
        self.overlap = overlap
        self.mono_conditioning = mono_conditioning
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rng_seed)
        self._params = params
        self.dit = self.enc = self.dec = None
        self._ref_cache = (None, None)   # (key, ref latent)
        self.on_latents = None

    def clear_cache(self):
        """Forget the cached source latent, so the next chunk encodes its
        source video again."""
        self._ref_cache = (None, None)

    def _t_pad(self, t):
        return wan_mod.pad_to_valid_t(t, self.cfg.block_frames)

    def _ensure(self):
        if self.dit is not None:
            return
        with torch.device(self.device):
            mods = {"dit": wan_mod.WanDiT(self.cfg),
                    "enc": wan_mod.WanVAEEncoder(self.cfg.vae),
                    "dec": wan_mod.WanVAEDecoder(self.cfg.vae)}
        if self._params is not None and "dit" not in self._params:
            raise KeyError(
                "dit: the engine's weights are a {'dit', 'enc', 'dec'} tree; "
                f"this one holds {sorted(self._params)[:4]} (a bare "
                "convert_wan tree, the DiT alone, fails in the JAX package "
                "too)")
        for name, mod in mods.items():
            if self._params is None:
                wan_mod.init_weights(mod, self.generator)
            else:
                from_jax.load_params(mod, self._params[name])
        self._params = None
        if self.cfg.dtype == "bfloat16":
            mods["dit"].to(torch.bfloat16)
        self.dit, self.enc, self.dec = (mods[k].eval() for k in
                                        ("dit", "enc", "dec"))

    def params(self):
        """The engine's weights as ``{"dit", "enc", "dec"}`` state dicts."""
        self._ensure()
        return {"dit": self.dit.state_dict(), "enc": self.enc.state_dict(),
                "dec": self.dec.state_dict()}

    def _vae_encode(self, x):
        """(1, T, wh, ww, 3) -> (1, T_lat, lh, lw, z), streamed."""
        outs, cache = [], None
        for s in range(0, x.shape[1], self.ENC_SEG):
            z, cache = self.enc.stream(x[:, s:s + self.ENC_SEG], cache)
            outs.append(z)
        return torch.cat(outs, dim=1)

    def _to_work(self, frames_u8):
        """(T, H, W, 3) uint8 on the device -> (T, wh, ww, 3) float in
        [-1, 1], resized (antialiased when shrinking)."""
        return im.resize(frames_u8.float() / 127.5 - 1.0, self.work_hw)

    def _encode_ref(self, mono_u8, tp):
        """The source latent, cached by content, so the second eye's pass
        reuses the first's encode."""
        key = (mono_u8.shape, hash(np.ascontiguousarray(
            mono_u8[::max(1, mono_u8.shape[0] // 4), ::16, ::16]).tobytes()))
        if self._ref_cache[0] == key:
            return self._ref_cache[1]
        mono = torch.as_tensor(mono_u8, device=self.device)
        ref = self._vae_encode(_pad_frames(self._to_work(mono), tp)[None])
        self._ref_cache = (key, ref)
        return ref

    @torch.no_grad()
    def infill_chunk(self, frames_u8, hole_mask, mono_u8=None, noise=None):
        """(T, H, W, 3) uint8 render + (T, H, W) bool holes -> infilled
        (T, H, W, 3) uint8 numpy, composited into the holes and LHM
        colour-matched. ``noise``: the sampler's initial latents (1, T_lat,
        lh, lw, z_ch), drawn from the engine's generator when None."""
        self._ensure()
        frames_u8 = np.ascontiguousarray(frames_u8)
        t, h, w = frames_u8.shape[:3]
        tp = self._t_pad(t)
        mono_u8 = (np.zeros_like(frames_u8) if mono_u8 is None
                   else np.ascontiguousarray(mono_u8))
        # the stages carry profiler ranges (free unless a profiler runs)
        with span("infill.encode"):
            ref = self._encode_ref(mono_u8, tp)
            tl, lh, lw = ref.shape[1:4]
            f_dev = torch.as_tensor(frames_u8, device=self.device)
            m_dev = torch.as_tensor(np.ascontiguousarray(hole_mask),
                                    device=self.device)
            mw = resize_mask(m_dev, self.work_hw)
            # holes are blacked out of the render: black = 0 u8 = -1
            fw = torch.where(mw[..., None] > 0, -1.0, self._to_work(f_dev))
            fw, mw = _pad_frames(fw, tp), _pad_frames(mw, tp)
            render = self._vae_encode(fw[None])
            del fw
            cond = torch.cat([render, ref, wan_mod.mask_to_latent(
                mw, tl, lh, lw)[None]], dim=-1)
            del render, mw
        if noise is None:
            noise = torch.randn((1, tl, lh, lw, self.cfg.z_ch),
                                generator=self.generator,
                                device=self.device)
        with span("infill.sample"):
            z = wan_mod.sample_causal(self.dit, cond, self.cfg,
                                      noise.to(self.device))
        del cond
        if self.on_latents is not None:
            self.on_latents(z)

        out = np.empty((t, h, w, 3), np.uint8)
        cache, s_lat, s_pix = None, 0, 0
        with span("infill.decode_composite"):
            while s_lat < tl and s_pix < t:
                y, cache = self.dec.stream(
                    z[:, s_lat:s_lat + self.DEC_SEG], cache)
                n = min(y.shape[1], t - s_pix)
                sl = slice(s_pix, s_pix + n)
                out[sl] = _composite(y[0, :n], f_dev[sl],
                                     m_dev[sl]).cpu().numpy()
                s_lat += self.DEC_SEG
                s_pix += n
        return out


def resize_mask(mask, out_hw):
    """(T, H, W) mask -> (T, h, w) float32 by nearest neighbour with
    half-pixel centres (``jax.image.resize(..., "nearest")``; torch's
    ``nearest`` mode rounds differently)."""
    return dif.resize_nearest(mask.float()[:, None], out_hw)[:, 0]


def _pad_frames(x, tp):
    """Pad (T, ...) to tp frames by repeating the last one."""
    t = x.shape[0]
    if tp <= t:
        return x
    return torch.cat([x, x[-1:].expand((tp - t,) + tuple(x.shape[1:]))])


def _composite(decoded, f_u8, hole):
    """Decoded frames (L, wh, ww, 3) in [-1, 1] -> resized to the render's
    size and pasted (:func:`_paste`)."""
    h, w = f_u8.shape[1:3]
    return _paste(im.resize((decoded.float() * 0.5 + 0.5) * 255.0, (h, w)),
                  f_u8, hole)


def _paste(out, f_u8, hole):
    """Generated frames (L, H, W, 3) on [0, 255] -> LHM colour-matched
    against the render's non-hole pixels, pasted inside the holes:
    (L, H, W, 3) uint8 (clip, then truncate, as the JAX package)."""
    f = f_u8.float()
    outm = infill_ops.lhm_color_transfer(out, f, 1.0 - hole.float())
    comp = torch.where(hole[..., None], outm, f)
    return torch.clamp(comp, 0, 255).to(torch.uint8)


# frames per batch of the halo blend on the device (a 1080p SBS frame's
# float32 temporaries are ~50 MB each)
HALO_BATCH = 8


def infill_sbs_frames(frames, hole, engine, mono=None, mirror_left=True,
                      drift_correct=False, apply_edge_blending=False,
                      masks_rgb=None):
    """The chunked SBS loop on in-memory arrays: (T, H, 2W, 3) uint8 SBS
    frames and (T, H, 2W) bool holes -> infilled SBS frames (numpy).

    Each eye runs in chunks of ``engine.chunk`` frames overlapping by
    ``engine.overlap``; the first overlap/2 frames of a chunk are the last
    chunk's infilled frames, as context. ``mono``: the source video, the
    engine's conditioning. ``drift_correct`` runs the phase-correlation
    drift fix of each generated chunk against its render, and
    ``apply_edge_blending`` the halo blend (``ops.infill.halo_blend``) of the
    result by ``masks_rgb`` (T, H, 2W, 3), both on the engine's device."""
    if apply_edge_blending and masks_rgb is None:
        raise ValueError("apply_edge_blending needs the infill-mask frames "
                         "(masks_rgb)")
    t = frames.shape[0]
    half = frames.shape[2] // 2
    out_frames = frames.copy()
    for eye in ("left", "right"):
        cols = slice(0, half) if eye == "left" else slice(half, None)
        f, m = frames[:, :, cols], hole[:, :, cols]
        mono_eye = mono
        flip = eye == "left" and mirror_left
        if flip:
            f, m = f[:, :, ::-1], m[:, :, ::-1]
            if mono_eye is not None:
                mono_eye = mono_eye[:, :, ::-1]
        result = np.empty_like(f)
        start, context = 0, None
        while start < t:
            end = min(start + engine.chunk, t)
            idx = np.clip(np.arange(start, start + engine.chunk), 0, t - 1)
            cf = f[idx].copy()
            cm = m[idx].copy()
            if context is not None:
                n_ctx = min(engine.overlap // 2, context.shape[0])
                if n_ctx > 0:   # overlap < 2 carries no context frames
                    cf[:n_ctx] = context[-n_ctx:]
                    cm[:n_ctx] = False   # already infilled, as context
            filled = engine.infill_chunk(
                cf, cm, mono_u8=mono_eye[idx] if mono_eye is not None
                else None)
            if drift_correct:
                dev = engine.device
                filled = dr.drift_correct_video(
                    torch.as_tensor(filled, device=dev),
                    torch.as_tensor(cf, device=dev)).cpu().numpy()
            n_new = end - start
            result[start:end] = filled[:n_new]
            context = filled[:n_new]
            start += engine.chunk - engine.overlap if end < t else \
                engine.chunk
        out_frames[:, :, cols] = result[:, :, ::-1] if flip else result
    if apply_edge_blending:
        with span("infill.halo_blend"):
            for s in range(0, t, HALO_BATCH):
                sl = slice(s, s + HALO_BATCH)
                out_frames[sl] = infill_ops.halo_blend(
                    torch.as_tensor(out_frames[sl], device=engine.device),
                    torch.as_tensor(np.ascontiguousarray(masks_rgb[sl]),
                                    device=engine.device)).cpu().numpy()
    return out_frames


def infill_sbs_video_diffusion(sbs_video, infill_mask_video, output=None,
                               color_video=None, engine=None,
                               max_frames=-1, chunk=25, overlap=6,
                               mirror_left=True, drift_correct=False,
                               apply_edge_blending=True, device=None):
    """Chunked diffusion infill of an SBS video file (see
    :func:`infill_sbs_frames`); writes ``output`` (default
    ``<sbs>_infilled.mkv``) and returns its path. Without ``engine`` it
    builds the JAX package's default: ``DiffusionInfillEngine(chunk=chunk,
    overlap=overlap)``, which is ``DIFFUSION_TINY`` at 256 x 256 on seeded
    weights (the movie's ``--infill_engine diffusion`` runs this)."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    engine = engine or DiffusionInfillEngine(chunk=chunk, overlap=overlap,
                                             device=device)
    output = output or (sbs_video + "_infilled.mkv")
    with vio.VideoReader(sbs_video, max_frames=max_frames) as sv:
        frames = sv.read_all()
        fps = sv.fps
    with vio.VideoReader(infill_mask_video) as mv:
        masks_rgb = mv.read_all()
    t = frames.shape[0]
    masks_rgb = masks_rgb[:t]
    hole = np.any(masks_rgb != 0, axis=-1)
    mono = None
    if color_video and getattr(engine, "mono_conditioning", False):
        with vio.VideoReader(color_video, max_frames=max_frames) as cvr:
            mono = cvr.read_all()[:t]
    out = infill_sbs_frames(frames, hole, engine, mono=mono,
                            mirror_left=mirror_left,
                            drift_correct=drift_correct,
                            apply_edge_blending=apply_edge_blending,
                            masks_rgb=masks_rgb)
    vio.save_rgb_video(out, output, fps)
    return output


# Engine presets mirroring the reference infill zoo's working shapes:
# chunk/overlap/resolution and behavioral flags.
ENGINE_PRESETS = {
    # 25/6 chunks at 1024x768
    "stereocrafter": dict(chunk=25, overlap=6, work_hw=(768, 1024),
                          mirror_left=True, drift_correct=False),
    # 512x512 frames, mono-video conditioning; edge blending opt-in
    "m2svid": dict(chunk=25, overlap=6, work_hw=(512, 512),
                   mirror_left=True, drift_correct=False,
                   mono_conditioning=True, apply_edge_blending=False),
    # 225/6 chunks at 480x832, shared source latents + drift correction;
    # edge blending opt-in
    "inspatio_world": dict(chunk=225, overlap=6, work_hw=(480, 832),
                           mirror_left=False, drift_correct=True,
                           mono_conditioning=True,
                           apply_edge_blending=False),
}


def make_engine(preset="stereocrafter", cfg=None, params=None, device=None,
                **overrides):
    """Build an infill engine + the chunk loop's keyword arguments from a
    preset. ``inspatio_world`` (or any WanConfig cfg) builds the Wan-class
    causal engine; the other presets build the SVD-class
    :class:`DiffusionInfillEngine` (``cfg`` None: ``DIFFUSION_TINY``, as in
    the JAX package)."""
    p = dict(ENGINE_PRESETS[preset])
    p.update(overrides)
    if preset == "inspatio_world" or isinstance(cfg, wan_mod.WanConfig):
        eng = CausalInfillEngine(
            cfg=cfg if isinstance(cfg, wan_mod.WanConfig) else None,
            params=params, work_hw=p.pop("work_hw"), chunk=p["chunk"],
            overlap=p["overlap"],
            mono_conditioning=p.pop("mono_conditioning", True),
            device=device)
        for k in ("vae_cfg", "clip_params", "clip_cfg"):
            p.pop(k, None)
        return eng, p
    eng = DiffusionInfillEngine(
        cfg=cfg, params=params, work_hw=p.pop("work_hw"), chunk=p["chunk"],
        overlap=p["overlap"],
        mono_conditioning=p.pop("mono_conditioning", False),
        vae_cfg=p.pop("vae_cfg", None),
        clip_params=p.pop("clip_params", None),
        clip_cfg=p.pop("clip_cfg", None), device=device)
    return eng, p


def infill_sbs_video_external(sbs_video, infill_mask_video, command,
                              output=None, color_video=None):
    """The external infill engine hook: run ``command`` (an argv list) with
    ``--sbs_color_video``, ``--sbs_mask_video``, ``--output`` (and
    ``--color_video``) appended; it must write the infilled video to
    ``--output``. Raises RuntimeError with the end of its stderr if it
    fails. Returns the output path."""
    output = output or (sbs_video + "_infilled.mkv")
    argv = list(command) + ["--sbs_color_video", sbs_video,
                            "--sbs_mask_video", infill_mask_video,
                            "--output", output]
    if color_video:
        argv += ["--color_video", color_video]
    res = subprocess.run(argv, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"external infill engine failed ({res.returncode}):\n"
            f"{res.stderr[-2000:]}")
    return output
