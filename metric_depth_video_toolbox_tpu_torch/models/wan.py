"""Wan-class causal video DiT and its causal 3D VAE (PyTorch port of
``models/wan.py``): the InSpatio-World infill engine's model family.

Module and parameter names follow the Flax tree of the JAX package
(``block{i}.self_attn.q``, ``res0.norm1.gn``, ``modulation``, ...), so
``models.from_jax`` carries weights across by name. Videos and latents are
channels-last (B, T, H, W, C) at the public functions, as in the JAX
package; the VAE works channels-first (B, C, T, H, W) inside, where
``Conv3d`` wants it.

- The VAE's temporal convolutions are causal (front pad 2 frames). Every
  VAE forward is the streaming form: a 2-frame cache per causal
  convolution, zeros for the first segment, which is the full video's
  front pad. So a full-video call and any segmentation (x4 segment lengths
  in the encoder, any in the decoder) give the same result.
- The DiT's self-attention is block-causal (frame block i sees blocks <=
  i) and runs through ``ops.blockcausal.block_causal_attention`` for every
  sequence length: the kernel B3 on the card, its plain version on the
  CPU. The JAX package's 16,384-token gate exists for TPU memory; the
  function is the same below it.
- The sampler is a host loop of (block, step) updates of the full latent
  sequence with per-frame flow times (finished blocks at t = 0), the JAX
  package's static-shape form of KV caching. Its initial noise is a tensor
  the caller draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.vit import Dense
from metric_depth_video_toolbox_tpu_torch.ops import blockcausal as bc

GN_EPS = 1e-6     # flax.linen.GroupNorm's default
RMS_EPS = 1e-5
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class WanVAEConfig:
    ch: int = 96
    z_ch: int = 16
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class WanConfig:
    dim: int = 1536
    ffn_dim: int = 8960
    layers: int = 30
    heads: int = 12
    z_ch: int = 16
    cond_ch: int = 16 + 16 + 4  # render + ref + mask latents
    text_dim: int = 4096
    n_prompt_tokens: int = 16
    patch_hw: int = 2  # 3D patch (1, 2, 2)
    block_frames: int = 3  # frames per causal block
    # distilled few-step schedule (flow-matching times, 1 = pure noise)
    denoise_steps: Sequence[float] = (1.0, 0.75, 0.5, 0.25)
    freq_dim: int = 256  # sinusoidal timestep embedding width
    dtype: str = "bfloat16"
    vae: WanVAEConfig = WanVAEConfig()

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


WAN_1_3B = WanConfig()
WAN_TINY = WanConfig(dim=48, ffn_dim=96, layers=2, heads=4, text_dim=32,
                     n_prompt_tokens=4, freq_dim=32, dtype="float32",
                     vae=WanVAEConfig(ch=8, dtype="float32"))


def init_weights(module, generator):
    """Draw a Wan module's weights from ``generator`` with the JAX
    package's initializers: LeCun-normal matrices and kernels, zero biases,
    unit norm scales, N(0, 0.02) modulations and prompt tokens."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("modulation", "head_modulation", "prompt_tokens"):
                p.normal_(0.0, 0.02, generator=generator)
            elif leaf == "weight" and p.ndim >= 2:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()),
                          generator=generator)
            elif leaf == "weight":
                p.fill_(1.0)
            else:
                p.zero_()
    return module


# --------------------------------------------------------------------------
# causal 3D VAE (temporal /4 causal, spatial /8), channels-first inside
# --------------------------------------------------------------------------


def to_cf(x):
    """(B, T, H, W, C) -> (B, C, T, H, W)."""
    return x.permute(0, 4, 1, 2, 3)


def to_cl(x):
    """(B, C, T, H, W) -> (B, T, H, W, C)."""
    return x.permute(0, 2, 3, 4, 1)


class FrameGroupNorm(nn.Module):
    """GroupNorm with per-frame statistics over (B, C, T, H, W), in float32
    with flax's statistics (var = E[x^2] - E[x]^2) and eps 1e-6; returns
    the input's dtype. The parameters live in ``gn`` (the Flax path)."""

    def __init__(self, groups, ch):
        super().__init__()
        self.gn = nn.GroupNorm(groups, ch, eps=GN_EPS)

    def forward(self, x):
        b, c, t, h, w = x.shape
        g = self.gn.num_groups
        xf = x.float().reshape(b, g, c // g, t, h, w)
        mu = xf.mean(dim=(2, 4, 5), keepdim=True)
        mu2 = (xf * xf).mean(dim=(2, 4, 5), keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        y = ((xf - mu) * torch.rsqrt(var + GN_EPS)).reshape(b, c, t, h, w)
        y = (y * self.gn.weight.float()[None, :, None, None, None]
             + self.gn.bias.float()[None, :, None, None, None])
        return y.to(x.dtype)


class CausalConv3d(nn.Conv3d):
    """Conv3d over (B, C, T, H, W) computing in a given dtype (flax
    ``nn.Conv(dtype=)``), 'SAME' spatial padding. A kernel of 3 frames is
    causal and streamed: :meth:`stream` prepends the 2-frame cache of the
    previous segment (zeros for the first, which is the full video's front
    pad), so output frame t sees input frames <= t."""

    def __init__(self, in_ch, out_ch, kernel, dtype, stride_t=1, stride_hw=1):
        super().__init__(in_ch, out_ch, kernel,
                         stride=(stride_t, stride_hw, stride_hw))
        self.compute_dtype = dtype

    def _conv(self, x):
        dt = self.compute_dtype
        ph = self.kernel_size[1] // 2
        return F.conv3d(F.pad(x.to(dt), (ph, ph, ph, ph)), self.weight.to(dt),
                        self.bias.to(dt), stride=self.stride)

    def forward(self, x):
        """A kernel of 1 frame: no cache."""
        if self.kernel_size[0] != 1:
            raise ValueError("a causal 3-frame conv runs through stream()")
        return self._conv(x)

    def stream(self, x, cache):
        """-> (output, cache for the next segment). A stride-2 conv needs
        segments of even length (all but the last)."""
        if cache is None:
            b, c, _, h, w = x.shape
            cache = torch.zeros((b, c, 2, h, w), dtype=x.dtype,
                                device=x.device)
        xin = torch.cat([cache, x.to(cache.dtype)], dim=2)
        return self._conv(xin), xin[:, :, -2:]


class VAEResBlock3D(nn.Module):
    def __init__(self, ch, dtype, in_ch=None):
        super().__init__()
        in_ch = in_ch or ch
        # the JAX block takes its group count from its output width
        self.norm1 = FrameGroupNorm(min(8, ch), in_ch)
        self.conv1 = CausalConv3d(in_ch, ch, 3, dtype)
        self.norm2 = FrameGroupNorm(min(8, ch), ch)
        self.conv2 = CausalConv3d(ch, ch, 3, dtype)
        self.skip = (CausalConv3d(in_ch, ch, 1, dtype) if in_ch != ch
                     else None)

    def stream(self, x, cache):
        c1, c2 = (None, None) if cache is None else cache
        y, c1 = self.conv1.stream(F.silu(self.norm1(x)), c1)
        y, c2 = self.conv2.stream(F.silu(self.norm2(y)), c2)
        skip = self.skip(x) if self.skip is not None else x
        return skip + y, (c1, c2)

    def forward(self, x):
        return self.stream(x, None)[0]


class WanVAEEncoder(nn.Module):
    """(B, T, H, W, 3) in [-1, 1], T = 4k-3 -> (B, k, H/8, W/8, z_ch).

    :meth:`stream` encodes a segment with the per-conv frame caches of the
    previous one (None starts the video); every segment but the last must
    have a length divisible by 4."""

    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.ch, cfg.compute_dtype
        self.stem = CausalConv3d(3, c, 3, dt)
        self.res0 = VAEResBlock3D(c, dt)
        self.down0 = CausalConv3d(c, c * 2, 3, dt, 1, 2)
        self.res1 = VAEResBlock3D(c * 2, dt)
        self.down1 = CausalConv3d(c * 2, c * 4, 3, dt, 2, 2)
        self.res2 = VAEResBlock3D(c * 4, dt)
        self.down2 = CausalConv3d(c * 4, c * 4, 3, dt, 2, 2)
        self.res3 = VAEResBlock3D(c * 4, dt)
        self.norm_out = FrameGroupNorm(8, c * 4)
        self.head = CausalConv3d(c * 4, cfg.z_ch, 1, torch.float32)

    def stream(self, x, cache):
        cc = [None] * 8 if cache is None else cache
        x = to_cf(x).to(self.cfg.compute_dtype)
        x, c0 = self.stem.stream(x, cc[0])
        x, c1 = self.res0.stream(x, cc[1])
        x, c2 = self.down0.stream(x, cc[2])
        x, c3 = self.res1.stream(x, cc[3])
        x, c4 = self.down1.stream(x, cc[4])
        x, c5 = self.res2.stream(x, cc[5])
        x, c6 = self.down2.stream(x, cc[6])
        x, c7 = self.res3.stream(x, cc[7])
        z = self.head(F.silu(self.norm_out(x)))
        return to_cl(z), [c0, c1, c2, c3, c4, c5, c6, c7]

    def forward(self, x):
        return self.stream(x, None)[0]


def _up(x, t, hw):
    """Nearest upsampling of (B, C, T, H, W): each frame t times, each pixel
    hw x hw (jax.image.resize 'nearest' at an integer factor)."""
    if t > 1:
        x = x.repeat_interleave(t, dim=2)
    return x.repeat_interleave(hw, dim=3).repeat_interleave(hw, dim=4)


class WanVAEDecoder(nn.Module):
    """(B, k, h, w, z_ch) -> (B, 4k-3, 8h, 8w, 3) in [-1, 1].

    :meth:`stream` decodes a segment of any length with the caches of the
    previous one; the first segment drops the 3 lead-in frames, as the
    full-video call does."""

    def __init__(self, cfg: WanVAEConfig):
        super().__init__()
        self.cfg = cfg
        c, dt = cfg.ch, cfg.compute_dtype
        self.stem = CausalConv3d(cfg.z_ch, c * 4, 1, dt)
        self.res0 = VAEResBlock3D(c * 4, dt)
        self.upconv0 = CausalConv3d(c * 4, c * 4, 3, dt)
        self.res1 = VAEResBlock3D(c * 2, dt, in_ch=c * 4)
        self.upconv1 = CausalConv3d(c * 2, c * 2, 3, dt)
        self.res2 = VAEResBlock3D(c, dt, in_ch=c * 2)
        self.upconv2 = CausalConv3d(c, c, 3, dt)
        self.res3 = VAEResBlock3D(c, dt)
        self.norm_out = FrameGroupNorm(min(8, c), c)
        self.head = CausalConv3d(c, 3, 1, torch.float32)

    def stream(self, z, cache):
        cc = [None] * 7 if cache is None else cache
        x = self.stem(to_cf(z).to(self.cfg.compute_dtype))
        x, c0 = self.res0.stream(x, cc[0])
        x, c1 = self.upconv0.stream(_up(x, 2, 2), cc[1])
        x, c2 = self.res1.stream(x, cc[2])
        x, c3 = self.upconv1.stream(_up(x, 2, 2), cc[3])
        x, c4 = self.res2.stream(x, cc[4])
        x, c5 = self.upconv2.stream(_up(x, 1, 2), cc[5])
        x, c6 = self.res3.stream(x, cc[6])
        x = torch.tanh(self.head(F.silu(self.norm_out(x))))
        if cache is None:
            # the first latent frame stands for ONE pixel frame (causal 4x)
            x = x[:, :, 3:]
        return to_cl(x), [c0, c1, c2, c3, c4, c5, c6]

    def forward(self, z):
        return self.stream(z, None)[0]


def latent_frames(t):
    """Pixel frames -> Wan-VAE latent frames."""
    return (t + 3) // 4


def pad_to_valid_t(t, block_frames=3):
    """Smallest T' >= t with latent_frames(T') divisible by the causal
    block size and T' = 4k-3 (lossless decode)."""
    cand = -(-latent_frames(t) // block_frames) * block_frames
    while cand * 4 - 3 < t:
        cand += block_frames
    return cand * 4 - 3


# --------------------------------------------------------------------------
# causal DiT
# --------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        y = x.float()
        y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True)
                            + RMS_EPS)
        return (y * self.weight.float()).to(x.dtype)


def _rope_freqs(dim, pos, theta=10000.0):
    """(len(pos), dim/2) cos and sin of the RoPE angles (float64 on the
    host, returned as float32 numpy)."""
    half = dim // 2
    freqs = 1.0 / theta ** (np.arange(half, dtype=np.float64) / half)
    ang = np.asarray(pos, np.float64)[:, None] * freqs[None]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rope_3d(hd, t, h, w, device=None):
    """Per-token (T*H*W, hd/2) float32 cos and sin of Wan's 3D RoPE: the
    head dim splits into temporal / height / width sections (t takes the
    remainder, hd/2 - 2*(hd/6) complex pairs)."""
    half = hd // 2
    c_h = half // 3
    c_w = half // 3
    c_t = half - c_h - c_w
    ct, st = _rope_freqs(2 * c_t, np.arange(t))
    ch_, sh = _rope_freqs(2 * c_h, np.arange(h))
    cw, sw = _rope_freqs(2 * c_w, np.arange(w))
    cos = np.concatenate([
        np.broadcast_to(ct[:, None, None], (t, h, w, c_t)),
        np.broadcast_to(ch_[None, :, None], (t, h, w, c_h)),
        np.broadcast_to(cw[None, None, :], (t, h, w, c_w))], axis=-1)
    sin = np.concatenate([
        np.broadcast_to(st[:, None, None], (t, h, w, c_t)),
        np.broadcast_to(sh[None, :, None], (t, h, w, c_h)),
        np.broadcast_to(sw[None, None, :], (t, h, w, c_w))], axis=-1)
    return (torch.from_numpy(cos.reshape(t * h * w, half)).to(device),
            torch.from_numpy(sin.reshape(t * h * w, half)).to(device))


def _apply_rope(x, cos, sin):
    """x (B, N, H, hd): rotate interleaved pairs (the view_as_complex
    convention: a pair is the last axis of a (..., hd/2, 2) view). Returns
    float32 (bf16 x float32 promotes, as in JAX)."""
    xr = x.reshape(x.shape[:-1] + (-1, 2))
    x0, x1 = xr[..., 0], xr[..., 1]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.stack([x0 * c - x1 * s, x0 * s + x1 * c],
                       dim=-1).reshape(x.shape)


class WanSelfAttention(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.dim, cfg.compute_dtype
        hd = d // cfg.heads
        self.q = Dense(d, d, dt)
        self.k = Dense(d, d, dt)
        self.v = Dense(d, d, dt)
        self.o = Dense(d, d, dt)
        self.norm_q = RMSNorm(hd)
        self.norm_k = RMSNorm(hd)

    def forward(self, x, rope, block_ids):
        """x (B, N, D); block_ids (N,) int32 nondecreasing frame-block
        index per token; query i sees key j iff block_ids[j] <=
        block_ids[i]."""
        c = self.cfg
        b, n, _ = x.shape
        hd = c.dim // c.heads
        dt = c.compute_dtype

        def heads(t):
            return t.reshape(b, n, c.heads, hd)
        q = _apply_rope(self.norm_q(heads(self.q(x))), *rope)
        k = _apply_rope(self.norm_k(heads(self.k(x))), *rope)
        v = heads(self.v(x))
        # (B, H, N, hd) views of the (B, N, H, hd) projections: the kernel
        # reads them at their strides and its output comes back the same
        # way, so neither side is copied. A head dim the wrapper does not
        # take is zero-padded to the next multiple of 16, which changes no
        # dot product.
        qh, kh, vh = (t.to(dt).transpose(1, 2) for t in (q, k, v))
        pad = (-hd) % 16
        if pad:
            qh, kh, vh = (F.pad(t, (0, pad)) for t in (qh, kh, vh))
        out = bc.block_causal_attention(qh, kh, vh, block_ids,
                                        1.0 / float(hd) ** 0.5)
        out = out[..., :hd].transpose(1, 2).reshape(b, n, c.dim)
        return self.o(out)


class WanCrossAttention(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.dim, cfg.compute_dtype
        hd = d // cfg.heads
        self.q = Dense(d, d, dt)
        self.k = Dense(d, d, dt)
        self.v = Dense(d, d, dt)
        self.o = Dense(d, d, dt)
        self.norm_q = RMSNorm(hd)
        self.norm_k = RMSNorm(hd)

    def forward(self, x, ctx):
        c = self.cfg
        hd = c.dim // c.heads
        dt = c.compute_dtype

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], c.heads, hd)
        q = self.norm_q(heads(self.q(x)))
        k = self.norm_k(heads(self.k(ctx)))
        v = heads(self.v(ctx))
        out = F.scaled_dot_product_attention(
            *(t.to(dt).transpose(1, 2) for t in (q, k, v)))
        out = out.transpose(1, 2).reshape(x.shape[0], x.shape[1], c.dim)
        return self.o(out)


def _ln_noaffine(x):
    y = x.float()
    mu = y.mean(dim=-1, keepdim=True)
    var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((y - mu) * torch.rsqrt(var + LN_EPS)).to(x.dtype)


class WanBlock(nn.Module):
    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.dim, cfg.compute_dtype
        self.modulation = nn.Parameter(torch.zeros(1, 6, d))
        self.self_attn = WanSelfAttention(cfg)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn = WanCrossAttention(cfg)
        self.ffn1 = Dense(d, cfg.ffn_dim, dt)
        self.ffn2 = Dense(cfg.ffn_dim, d, dt)

    def forward(self, x, e, ctx, rope, block_ids):
        """x (B, N, D) frame-major tokens; e (B, T, 6, D) per-frame
        modulation; ctx (B, n_ctx, D). The modulation broadcasts over each
        frame's spatial tokens through a (B, T, S, D) view."""
        c = self.cfg
        b, t = e.shape[0], e.shape[1]
        n_sp = x.shape[1] // t
        dm = c.dim
        dt = c.compute_dtype
        m = self.modulation[:, None].float() + e.float()
        sh1, sc1, g1, sh2, sc2, g2 = [m[:, :, i][:, :, None]
                                      for i in range(6)]

        def modulated(v_f32, sc, sh):
            vr = v_f32.reshape(b, t, n_sp, dm)
            return ((1 + sc) * vr + sh).reshape(b, t * n_sp, dm)

        def gated(v, g):
            vr = v.float().reshape(b, t, n_sp, dm)
            return (g * vr).reshape(b, t * n_sp, dm)

        y = modulated(_ln_noaffine(x).float(), sc1, sh1)
        y = self.self_attn(y.to(dt), rope, block_ids)
        x = x + gated(y, g1).to(x.dtype)
        n3 = self.norm3
        y = F.layer_norm(x.float(), n3.normalized_shape, n3.weight.float(),
                         n3.bias.float(), LN_EPS)
        x = x + self.cross_attn(y.to(dt), ctx)
        y = modulated(_ln_noaffine(x).float(), sc2, sh2)
        y = self.ffn2(F.gelu(self.ffn1(y.to(dt)), approximate="tanh"))
        return x + gated(y, g2).to(x.dtype)


def timestep_embedding(t, dim, max_period=10000.0):
    """(B, T) flow times in [0, 1] (scaled x1000 like Wan's discrete range)
    -> (B, T, dim) float32 sinusoidal."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t[..., None].float() * 1000.0 * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class WanDiT(nn.Module):
    """Block-causal conditional video DiT.

    forward(x, t_frames, cond, context=None):
      x:        (B, T, h, w, z_ch) noisy latents
      t_frames: (B, T) per-frame flow times (0 = clean)
      cond:     (B, T, h, w, cond_ch) [render | ref | mask] latents
      context:  optional (B, n, text_dim) prompt encoding; defaults to the
                learned prompt-token bank
    Returns the float32 velocity prediction (B, T, h, w, z_ch).
    """

    def __init__(self, cfg: WanConfig):
        super().__init__()
        self.cfg = cfg
        d, dt, p = cfg.dim, cfg.compute_dtype, cfg.patch_hw
        f32 = torch.float32
        self.patch_embedding = nn.Conv3d(cfg.z_ch + cfg.cond_ch, d,
                                         (1, p, p), stride=(1, p, p))
        self.prompt_tokens = nn.Parameter(
            torch.zeros(cfg.n_prompt_tokens, cfg.text_dim))
        self.text_embedding1 = Dense(cfg.text_dim, d, dt)
        self.text_embedding2 = Dense(d, d, dt)
        self.time_embedding1 = Dense(cfg.freq_dim, d, f32)
        self.time_embedding2 = Dense(d, d, f32)
        self.time_projection = Dense(d, 6 * d, f32)
        for i in range(cfg.layers):
            self.add_module(f"block{i}", WanBlock(cfg))
        self.head_modulation = nn.Parameter(torch.zeros(1, 2, d))
        self.head = Dense(d, p * p * cfg.z_ch, f32)
        self._rope = {}

    def rope(self, t, h, w, device):
        key = (t, h, w, str(device))
        if key not in self._rope:
            self._rope[key] = rope_3d(self.cfg.dim // self.cfg.heads, t, h,
                                      w, device)
        return self._rope[key]

    def forward(self, x, t_frames, cond, context=None):
        c = self.cfg
        dt = c.compute_dtype
        b, t, h, w, _ = x.shape
        p = c.patch_hw
        hp, wp = h // p, w // p
        pe = self.patch_embedding
        inp = to_cf(torch.cat([x, cond], dim=-1).to(dt))
        tok = F.conv3d(inp, pe.weight.to(dt), pe.bias.to(dt), stride=pe.stride)
        tok = to_cl(tok).reshape(b, t * hp * wp, c.dim)   # frame-major

        if context is None:
            context = self.prompt_tokens[None].expand(
                (b,) + tuple(self.prompt_tokens.shape))
        ctx = self.text_embedding1(context.to(dt))
        ctx = self.text_embedding2(F.gelu(ctx, approximate="tanh"))

        te = timestep_embedding(t_frames, c.freq_dim)
        te = self.time_embedding1(te)
        te = self.time_embedding2(F.silu(te))
        e6 = self.time_projection(F.silu(te)).reshape(b, t, 6, c.dim)

        rope = self.rope(t, hp, wp, x.device)
        fb = (torch.arange(t, device=x.device, dtype=torch.int32)
              // c.block_frames).repeat_interleave(hp * wp)
        for i in range(c.layers):
            tok = getattr(self, f"block{i}")(tok, e6, ctx, rope, fb)

        m = self.head_modulation[:, None].float() + te[:, :, None, :]
        sh, sc = m[:, :, 0][:, :, None], m[:, :, 1][:, :, None]
        yr = _ln_noaffine(tok).float().reshape(b, t, hp * wp, c.dim)
        y = ((1 + sc) * yr + sh).reshape(b, t * hp * wp, c.dim)
        y = self.head(y.to(dt))
        y = y.reshape(b, t, hp, wp, p, p, c.z_ch)
        y = y.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, h, w, c.z_ch)
        return y.float()


def mask_to_latent(mask_thw, t_lat, lat_h, lat_w):
    """(T, H, W) float hole mask, T = 4 t_lat - 3 -> (t_lat, lat_h, lat_w,
    4): channel i carries pixel frame 4l - 3 + i of latent frame l
    (latent 0 covers frame 0 only), max-pooled over its spatial
    footprint."""
    t, h, w = mask_thw.shape
    m = mask_thw.reshape(t, lat_h, h // lat_h, lat_w, w // lat_w)
    m = m.amax(dim=(2, 4))
    m4 = torch.cat([m[:1].expand(3, lat_h, lat_w), m], dim=0)
    return m4.reshape(t_lat, 4, lat_h, lat_w).permute(0, 2, 3, 1)


def make_sample_step(model, cfg: WanConfig, b, t_lat):
    """One (block, step) update of the block-causal sampler:
    step(x, cond, context, si) -> x'. Frames of finished blocks ride at
    t = 0, the active block at the step's t, future blocks at t = 1; only
    the active block's frames are updated."""
    n_steps = len(cfg.denoise_steps)
    steps = [np.float32(s) for s in cfg.denoise_steps] + [np.float32(0.0)]
    frame_block = torch.arange(t_lat) // cfg.block_frames

    def step(x, cond, context, si):
        bi, k = divmod(si, n_steps)
        ti, tn = steps[k], steps[k + 1]
        fblk = frame_block.to(x.device)
        tf = torch.where(fblk < bi, 0.0,
                         torch.where(fblk == bi, float(ti), 1.0))
        tf = tf.to(torch.float32)[None].expand(b, t_lat)
        v = model(x, tf, cond, context)
        x_new = x + float(tn - ti) * v
        upd = (fblk == bi)[None, :, None, None, None]
        return torch.where(upd, x_new, x)
    return step


@torch.no_grad()
def sample_causal(model, cond, cfg: WanConfig, noise, context=None):
    """Block-causal few-step flow sampling: a host loop over n_blocks x
    n_steps model calls from ``noise`` (B, T_lat, h, w, z_ch), which the
    caller draws. cond (B, T_lat, h, w, cond_ch). Returns the clean
    latents."""
    b, t_lat = cond.shape[:2]
    n_blocks = t_lat // cfg.block_frames
    if n_blocks * cfg.block_frames != t_lat:
        raise ValueError(f"T_lat {t_lat} not divisible by block size "
                         f"{cfg.block_frames}")
    step = make_sample_step(model, cfg, b, t_lat)
    x = noise.float()
    for si in range(n_blocks * len(cfg.denoise_steps)):
        x = step(x, cond, context, si)
    return x
