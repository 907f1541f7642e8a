"""Latent video diffusion, SVD-class (PyTorch port of ``models/diffusion.py``):
the StereoCrafter / M2SVid infill engines' model family.

- :class:`VAE`: a convolutional 8x autoencoder with 4-channel latents.
- :class:`UNet3D`: residual blocks, spatial self-attention from
  ``cfg.spatial_attn_min_level`` down, temporal attention at every level,
  a sinusoidal timestep embedding and EDM preconditioning; conditioned by
  channel concatenation (cond latent + mask [+ mono latent]).
- :func:`sample`: Euler steps over the Karras schedule, from noise the
  caller draws.

Module and parameter names follow the Flax tree of the JAX package
(``unet.down1_sattn.attn.query``, ``vae.d3``, ...), so ``models.from_jax``
carries weights across by name. Frames are channels-last (T, H, W, C) at the
public methods, as in the JAX package; inside, the frames are the batch of
(T, C, H, W) convolutions, and only the temporal attention mixes frames.
Convolutions and matmuls run in ``cfg.compute_dtype``, the GroupNorms
(8 groups, eps 1e-6, flax's default) in float32. Attention is
``F.scaled_dot_product_attention``: the JAX package's is
``nn.MultiHeadDotProductAttention``, plain XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.vit import Dense

GN_EPS = 1e-6     # flax.linen.GroupNorm's default


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    latent_channels: int = 4
    cond_channels: int = 5      # cond latent (4) + mask (1)
    base_width: int = 128
    width_mults: Sequence[int] = (1, 2, 4)
    temporal: bool = True
    # first down level with SPATIAL attention (temporal attention runs at
    # every level): at the StereoCrafter working point the full-resolution
    # latent is 96x128 = 12k tokens
    spatial_attn_min_level: int = 0
    num_steps: int = 5
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


DIFFUSION_TINY = DiffusionConfig(base_width=16, width_mults=(1, 2),
                                 num_steps=2, dtype="float32")

# The StereoCrafter working point (25 x 768 x 1024 chunks, ~5 denoise
# steps, 4-channel 8x VAE latents): SVD-class widths 320/640/1280/1280,
# spatial attention from level 1 (48x64 tokens) down, temporal attention
# at every level.
DIFFUSION_SVD = DiffusionConfig(base_width=320, width_mults=(1, 2, 4, 4),
                                spatial_attn_min_level=1, num_steps=5)


def init_weights(module, generator):
    """Draw the weights of a diffusion, SVD or CLIP module from
    ``generator``, with the JAX package's initializers: LeCun-normal
    matrices and kernels (fan-in H*W*I for a ConvTranspose kernel), zero
    biases, unit norm scales, 0.5 for AlphaBlender's ``mix_factor`` and
    N(0, 0.02) for CLIP's class and position embeddings."""
    with torch.no_grad():
        for mod in module.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                if leaf == "mix_factor":
                    p.fill_(0.5)
                elif leaf in ("class_embedding", "position_embedding"):
                    p.normal_(0.0, 0.02, generator=generator)
                elif leaf == "weight" and p.ndim >= 2:
                    fan_in = p[0].numel()
                    if isinstance(mod, nn.ConvTranspose2d):
                        fan_in = p.shape[0] * p[0, 0].numel()
                    p.normal_(0.0, 1.0 / math.sqrt(fan_in),
                              generator=generator)
                elif leaf == "weight":
                    p.fill_(1.0)
                else:
                    p.zero_()
    return module


def store_in_compute_dtype(module):
    """Store the weights of every layer that computes in bfloat16 in
    bfloat16 (each casts its weights before the product anyway), so the
    forward makes no casting copies and the weights take half the memory."""
    for m in module.modules():
        if getattr(m, "compute_dtype", None) == torch.bfloat16:
            m.to(torch.bfloat16)
    return module


def same_padding(size, k, s):
    """flax/lax 'SAME' padding of one side: (lo, hi). A stride-2 3x3 conv
    pads (0, 1) on an even side and (1, 1) on an odd one."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """(N, C, H, W) convolution computing in a given dtype (flax
    ``nn.Conv(dtype=)``), with flax's 'SAME' padding at any stride, or an
    explicit ``padding`` ((top, bottom), (left, right))."""

    def __init__(self, in_ch, out_ch, kernel, dtype, stride=1,
                 padding="SAME", bias=True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.compute_dtype = dtype
        self.pad_spec = padding

    def forward(self, x):
        dt = self.compute_dtype
        if self.pad_spec == "SAME":
            (t, b), (l, r) = (same_padding(n, k, s) for n, k, s in zip(
                x.shape[-2:], self.kernel_size, self.stride))
        else:
            (t, b), (l, r) = self.pad_spec
        x = x.to(dt)
        w = self.weight.to(dt)
        bias = self.bias.to(dt) if self.bias is not None else None
        if t == b and l == r:
            return F.conv2d(x, w, bias, stride=self.stride, padding=(t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), w, bias, stride=self.stride)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose`` (4 x 4, stride 2, 'SAME') on (N, C, H, W):
    ``ConvTranspose2d(k=4, s=2, padding=1)`` with the flax kernel flipped
    (``models.from_jax`` flips it), computing in a given dtype."""

    def __init__(self, in_ch, out_ch, dtype):
        super().__init__(in_ch, out_ch, 4, stride=2, padding=1)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=2, padding=1)


def group_norm(x, groups, weight, bias, eps):
    """``F.group_norm`` of (N, C, ...) in float32. One sample (the SVD
    graph's temporal blocks take a whole chunk as one video) goes through
    ``torch.var_mean`` instead: ``F.group_norm`` gives each (sample, group)
    row one thread block, so a sample of 32 groups would use 32 of the
    card's 132 SMs for the largest activations."""
    if x.shape[0] > 1:
        return F.group_norm(x.float(), groups, weight, bias, eps)
    xg = x.float().reshape(groups, -1)
    var, mean = torch.var_mean(xg, dim=1, correction=0, keepdim=True)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((xg - mean).mul_(torch.rsqrt(var + eps)).reshape(x.shape)
            .mul_(weight.view(shape)).add_(bias.view(shape)))


class GroupNorm(nn.GroupNorm):
    """GroupNorm over (N, C, ...) in float32, returning float32 (flax
    ``nn.GroupNorm(dtype=float32)``)."""

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps)


# elements of a float32 temporary of norm_silu / the SVD graph's blends
# (1 GiB): above it they work in slices
SLICE_ELEMS = 1 << 28


def norm_silu(norm, x, dtype):
    """``F.silu(norm(x)).to(dtype)`` for a float32 GroupNorm: the
    activation before each convolution. A tensor of more than
    ``SLICE_ELEMS`` elements is done in slices of whole GroupNorm samples
    (axis 0) or, for one sample, of whole channel groups, so that the
    float32 temporaries of a chunk's full-resolution activations (10 GB
    and more in the SVD decoder) never exist at once; each group's values
    are the unsliced ones."""
    if x.numel() <= SLICE_ELEMS:
        return F.silu(norm(x)).to(dtype)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.shape[0] > 1:
        step = max(1, SLICE_ELEMS // x[0].numel())
        for s in range(0, x.shape[0], step):
            out[s:s + step] = F.silu(norm(x[s:s + step])).to(dtype)
        return out
    cg = x.shape[1] // norm.num_groups
    step = cg * max(1, SLICE_ELEMS // (cg * x[0, 0].numel()))
    for c in range(0, x.shape[1], step):
        sl = slice(c, c + step)
        y = group_norm(x[:, sl], (min(c + step, x.shape[1]) - c) // cg,
                       norm.weight[sl], norm.bias[sl], norm.eps)
        out[:, sl] = F.silu(y).to(dtype)
    return out


class LayerNorm(nn.LayerNorm):
    """LayerNorm (torch's eps 1e-5 unless given) in float32, returning
    float32 (flax ``nn.LayerNorm(epsilon=1e-5, dtype=float32)``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def to_cf(x):
    """(T, H, W, C) -> (T, C, H, W)."""
    return x.permute(0, 3, 1, 2)


def to_cl(x):
    """(T, C, H, W) -> (T, H, W, C)."""
    return x.permute(0, 2, 3, 1)


def resize_nearest(x, hw):
    """(N, C, H, W) -> (N, C, h, w) by nearest neighbour with half-pixel
    centres (``jax.image.resize(..., "nearest")``)."""
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class VAE(nn.Module):
    """8x conv autoencoder. encode: (T, H, W, 3) in [0, 1] -> (T, H/8, W/8,
    latent); decode back to [0, 1]."""

    def __init__(self, latent_channels=4, width=64, dtype=torch.bfloat16):
        super().__init__()
        dt, w = dtype, width
        self.dtype = dt
        self.e1 = Conv(3, w, 3, dt, stride=2)
        self.e2 = Conv(w, w * 2, 3, dt, stride=2)
        self.e3 = Conv(w * 2, w * 4, 3, dt, stride=2)
        self.to_latent = Conv(w * 4, latent_channels, 1, torch.float32)
        self.from_latent = Conv(latent_channels, w * 4, 1, dt)
        self.d1 = ConvTranspose(w * 4, w * 2, dt)
        self.d2 = ConvTranspose(w * 2, w, dt)
        self.d3 = ConvTranspose(w, w, dt)
        self.to_rgb = Conv(w, 3, 3, torch.float32)

    def encode(self, x):
        h = to_cf(x).to(self.dtype) * 2.0 - 1.0
        for layer in (self.e1, self.e2, self.e3):
            h = F.silu(layer(h))
        return to_cl(self.to_latent(h))

    def decode(self, z):
        h = F.silu(self.from_latent(to_cf(z).to(self.dtype)))
        for layer in (self.d1, self.d2, self.d3):
            h = F.silu(layer(h))
        return to_cl(torch.sigmoid(self.to_rgb(h)))


def timestep_embedding(t, dim):
    """Sinusoidal embedding of (N,) -> (N, dim), cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResBlock(nn.Module):
    def __init__(self, in_ch, width, emb_dim, dtype):
        super().__init__()
        self.n1 = GroupNorm(8, in_ch, eps=GN_EPS)
        self.c1 = Conv(in_ch, width, 3, dtype)
        self.emb = Dense(emb_dim, width, dtype)
        self.n2 = GroupNorm(8, width, eps=GN_EPS)
        self.c2 = Conv(width, width, 3, dtype)
        self.skip = Conv(in_ch, width, 1, dtype) if in_ch != width else None

    def forward(self, x, emb):
        dt = self.c1.compute_dtype
        h = self.c1(norm_silu(self.n1, x, dt))
        h = h + self.emb(F.silu(emb))[:, :, None, None]
        h = self.c2(norm_silu(self.n2, h, dt))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` self-attention over
    (B, L, C): biased q, k, v and out projections (the parameters of
    ``query``, ``key``, ``value`` and ``out``), softmax(q k^T / sqrt(hd))
    v by SDPA."""

    def __init__(self, width, heads, dtype):
        super().__init__()
        self.heads = heads
        self.query = Dense(width, width, dtype)
        self.key = Dense(width, width, dtype)
        self.value = Dense(width, width, dtype)
        self.out = Dense(width, width, dtype)

    def forward(self, x):
        b, n, c = x.shape

        def heads(t):
            return t.reshape(b, n, self.heads, -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(
            heads(self.query(x)), heads(self.key(x)), heads(self.value(x)))
        return self.out(o.transpose(1, 2).reshape(b, n, c))


class SpatialAttention(nn.Module):
    """Self-attention over the H*W tokens of each frame."""

    def __init__(self, width, dtype):
        super().__init__()
        self.norm = GroupNorm(8, width, eps=GN_EPS)
        self.attn = MultiHeadAttention(width, max(1, width // 32), dtype)

    def forward(self, x):
        t, c, h, w = x.shape
        y = self.norm(x).reshape(t, c, h * w).transpose(1, 2)
        y = self.attn(y)
        return x + y.transpose(1, 2).reshape(t, c, h, w)


class TemporalAttention(nn.Module):
    """Self-attention over the T frames of each pixel: the only op that
    mixes frames."""

    def __init__(self, width, dtype):
        super().__init__()
        self.norm = GroupNorm(8, width, eps=GN_EPS)
        self.attn = MultiHeadAttention(width, max(1, width // 32), dtype)

    def forward(self, x):
        t, c, h, w = x.shape
        y = self.norm(x).reshape(t, c, h * w).permute(2, 0, 1)  # (HW, T, C)
        y = self.attn(y)
        return x + y.permute(1, 2, 0).reshape(t, c, h, w)


class UNet3D(nn.Module):
    """The conditional video denoiser with EDM preconditioning.
    ``cond_channels``: channels of the concatenated conditioning
    (default ``cfg.cond_channels``; + ``latent_channels`` with a mono
    latent)."""

    def __init__(self, cfg: DiffusionConfig, cond_channels=None):
        super().__init__()
        self.cfg = c = cfg
        dt = c.compute_dtype
        cond = c.cond_channels if cond_channels is None else cond_channels
        bw, ed = c.base_width, c.base_width * 4
        self.emb1 = Dense(bw, ed, dt)
        self.emb2 = Dense(ed, ed, dt)
        self.in_conv = Conv(c.latent_channels + cond, bw, 3, dt)
        widths = [bw * m for m in c.width_mults]
        n = len(widths)
        prev = bw
        for i, wdt in enumerate(widths):
            setattr(self, f"down{i}_res", ResBlock(prev, wdt, ed, dt))
            self._attn(f"down{i}", i, wdt, dt)
            if i < n - 1:
                setattr(self, f"down{i}_pool", Conv(wdt, wdt, 3, dt,
                                                    stride=2))
            prev = wdt
        wmid = widths[-1]
        self.mid_res1 = ResBlock(wmid, wmid, ed, dt)
        self.mid_attn = SpatialAttention(wmid, dt)
        if c.temporal:
            self.mid_tattn = TemporalAttention(wmid, dt)
        self.mid_res2 = ResBlock(wmid, wmid, ed, dt)
        x_ch = wmid
        for i in reversed(range(n)):
            setattr(self, f"up{i}_res", ResBlock(x_ch + widths[i], widths[i],
                                                 ed, dt))
            self._attn(f"up{i}", i, widths[i], dt)
            x_ch = widths[i]
        self.out_norm = GroupNorm(8, x_ch, eps=GN_EPS)
        self.out_conv = Conv(x_ch, c.latent_channels, 3, torch.float32)

    def _attn(self, prefix, level, width, dt):
        if level >= self.cfg.spatial_attn_min_level:
            setattr(self, f"{prefix}_sattn", SpatialAttention(width, dt))
        if self.cfg.temporal:
            setattr(self, f"{prefix}_tattn", TemporalAttention(width, dt))

    def _attend(self, prefix, x):
        for kind in ("sattn", "tattn"):
            mod = getattr(self, f"{prefix}_{kind}", None)
            if mod is not None:
                x = mod(x)
        return x

    def forward(self, z, sigma, cond=None):
        """z: (T, h, w, latent) float32; sigma: the noise level (a float
        or a 0-d tensor); cond: (T, h, w, cond_channels) or None -> the
        denoised latent (T, h, w, latent), float32."""
        c = self.cfg
        dt = c.compute_dtype
        n = len(c.width_mults)
        sig = torch.as_tensor(sigma, dtype=torch.float32, device=z.device)
        c_in = 1.0 / torch.sqrt(sig ** 2 + 1.0)
        c_skip = 1.0 / (sig ** 2 + 1.0)
        c_out = sig / torch.sqrt(sig ** 2 + 1.0)
        x = z * c_in
        if cond is not None:
            x = torch.cat([x, cond.to(x.dtype)], dim=-1)
        x = to_cf(x).to(dt)
        emb = timestep_embedding(
            torch.log(sig).expand(z.shape[0]) / 4.0, c.base_width)
        emb = self.emb2(F.silu(self.emb1(emb)))

        x = self.in_conv(x)
        skips = []
        for i in range(n):
            x = getattr(self, f"down{i}_res")(x, emb)
            x = self._attend(f"down{i}", x)
            skips.append(x)
            if i < n - 1:
                x = getattr(self, f"down{i}_pool")(x)
        x = self.mid_res1(x, emb)
        x = self.mid_attn(x)
        if c.temporal:
            x = self.mid_tattn(x)
        x = self.mid_res2(x, emb)
        for i in reversed(range(n)):
            skip = skips[i]
            if x.shape[2] != skip.shape[2]:
                x = resize_nearest(x, skip.shape[2:]).to(dt)
            x = torch.cat([x, skip], dim=1)
            x = getattr(self, f"up{i}_res")(x, emb)
            x = self._attend(f"up{i}", x)
        f = to_cl(self.out_conv(norm_silu(self.out_norm, x,
                                          torch.float32)))
        return c_skip * z + c_out * f


def edm_sigmas(cfg, device=None):
    """The Karras schedule of ``cfg.num_steps`` sigmas and a final 0,
    float32."""
    rho = 7.0
    steps = torch.arange(cfg.num_steps, dtype=torch.float32,
                         device=device) / max(cfg.num_steps - 1, 1)
    s = (cfg.sigma_max ** (1 / rho)
         + steps * (cfg.sigma_min ** (1 / rho)
                    - cfg.sigma_max ** (1 / rho))) ** rho
    return torch.cat([s, torch.zeros(1, device=device)])


def sample(denoise, noise, cfg, cond=None, init=None):
    """Euler steps over :func:`edm_sigmas`. ``denoise(z, sigma, cond)`` ->
    denoised z; ``noise``: the caller's standard normal draw of the latent
    shape (T, h, w, latent). ``init``: an optional latent prompt; the
    trajectory then starts at init + sigma_max * noise (SDEdit-style)."""
    sigmas = edm_sigmas(cfg, noise.device)
    z = noise.float() * sigmas[0]
    if init is not None:
        z = z + init
    for i in range(cfg.num_steps):
        sig, sig_next = sigmas[i], sigmas[i + 1]
        denoised = denoise(z, sig, cond)
        d = (z - denoised) / torch.clamp(sig, min=1e-8)
        z = z + d * (sig_next - sig)
    return z


class VideoInpainter(nn.Module):
    """StereoCrafter-class wrapper: VAE + conditional UNet for masked video
    inpainting. ``mono``: the conditioning also carries a mono latent
    (M2SVid)."""

    def __init__(self, cfg: DiffusionConfig = DIFFUSION_TINY, vae_width=32,
                 mono=False):
        super().__init__()
        self.cfg = cfg
        self.vae = VAE(cfg.latent_channels, vae_width, cfg.compute_dtype)
        self.unet = UNet3D(cfg, cfg.cond_channels
                           + (cfg.latent_channels if mono else 0))

    def encode(self, frames):
        """(T, H, W, 3) in [0, 1] -> latents (T, H/8, W/8, latent)."""
        return self.vae.encode(frames)

    def decode(self, z):
        return self.vae.decode(z)

    def denoise(self, z, sigma, cond, context=None):
        del context   # the SVD graph's cross-attention input
        return self.unet(z, sigma, cond)
