"""SVD-class spatio-temporal UNet and temporal-decoder VAE, the
StereoCrafter graph (PyTorch port of ``models/svd.py``, which mirrors
diffusers' UNetSpatioTemporalConditionModel and
AutoencoderKLTemporalDecoder).

Module and parameter names follow the Flax tree of the JAX package
(``unet.down0_res0.spatial_res_block.conv1``, ``unet.down0_attn0.tblock0
.ff_in.proj``, ``vae_decoder.time_conv_out``, ...), so ``models.from_jax``
carries weights across by name. Frames are channels-last (F, H, W, C) at
the public methods; inside, spatial ops take the frames as the batch of
(F, C, H, W) tensors. Three kinds of op mix frames: the temporal attention
(over (H*W, F, C)), the temporal resnet blocks' (3, 1, 1) convolutions and
their GroupNorms, whose statistics span the whole chunk. So the decoder,
which has temporal blocks, runs on a whole chunk; the encoder has none.

Epsilons (diffusers' unet_3d_blocks.py): the cross-attention blocks build
their resnets with 1e-6, the plain down / up / mid blocks with 1e-5; the
VAE uses 1e-6, its decoder's temporal blocks 1e-5; LayerNorms 1e-5.
Convolutions and matmuls run in ``cfg.compute_dtype``; norms, softmax and
the blends in float32. Attention is ``F.scaled_dot_product_attention``: the
JAX package's is an einsum softmax, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.diffusion import (
    SLICE_ELEMS, Conv, GroupNorm, LayerNorm, norm_silu, resize_nearest,
    to_cf, to_cl)
from metric_depth_video_toolbox_tpu_torch.models.vit import Dense


def _dtype(name):
    return torch.bfloat16 if name == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class SVDConfig:
    in_channels: int = 9           # StereoCrafter inpainting: 4 noisy
    out_channels: int = 4          # + 4 cond-latent + 1 mask
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    num_attention_heads: Sequence[int] = (5, 10, 20, 20)
    transformer_layers_per_block: int = 1
    # sampling (EulerDiscrete/EDM; SVD ships sigma_max=700)
    num_steps: int = 5
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return _dtype(self.dtype)

    @property
    def time_embed_dim(self):
        return self.block_out_channels[0] * 4


SVD_TINY = SVDConfig(block_out_channels=(32, 64), layers_per_block=1,
                     cross_attention_dim=16, addition_time_embed_dim=4,
                     num_attention_heads=(1, 2), dtype="float32")


def timesteps_embed(t, dim, flip_sin_to_cos=True, max_period=10000.0):
    """diffusers' get_timestep_embedding (freq_shift 0) of (N,) -> (N,
    dim)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        out = F.pad(out, (0, 1))
    return out


class TimestepMLP(nn.Module):
    """diffusers TimestepEmbedding: linear_1 -> silu -> linear_2."""

    def __init__(self, in_dim, out_dim, dtype, inner_dim=None):
        super().__init__()
        self.linear_1 = Dense(in_dim, inner_dim or out_dim, dtype)
        self.linear_2 = Dense(inner_dim or out_dim, out_dim, dtype)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class AlphaBlender(nn.Module):
    """The learned spatial / temporal mix: sigmoid(mix_factor) of the
    spatial input (1 - it with ``switch``), in float32."""

    def __init__(self, switch=False):
        super().__init__()
        self.switch = switch
        self.mix_factor = nn.Parameter(torch.tensor(0.5))

    def forward(self, x_spatial, x_temporal):
        alpha = torch.sigmoid(self.mix_factor.float())
        if self.switch:
            alpha = 1.0 - alpha
        # in float32, in slices along axis 0 past SLICE_ELEMS elements (the
        # decoder's full-resolution activations of a chunk are 10 GB and
        # more in float32)
        out = torch.empty_like(x_spatial)
        step = max(1, SLICE_ELEMS // max(x_spatial[0].numel(), 1))
        for s in range(0, x_spatial.shape[0], step):
            sl = slice(s, s + step)
            out[sl] = (alpha * x_spatial[sl].float()
                       + (1.0 - alpha) * x_temporal[sl].float())
        return out


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D (silu, GroupNorm 32) on (F, C, H, W); ``temb``
    (F, temb_dim) or None."""

    def __init__(self, in_ch, out_ch, eps, dtype, temb_dim=None):
        super().__init__()
        self.norm1 = GroupNorm(32, in_ch, eps=eps)
        self.conv1 = Conv(in_ch, out_ch, 3, dtype)
        if temb_dim is not None:
            self.time_emb_proj = Dense(temb_dim, out_ch, dtype)
        self.norm2 = GroupNorm(32, out_ch, eps=eps)
        self.conv2 = Conv(out_ch, out_ch, 3, dtype)
        if in_ch != out_ch:
            self.conv_shortcut = Conv(in_ch, out_ch, 1, dtype)

    def forward(self, x, temb=None):
        dt = self.conv1.compute_dtype
        h = self.conv1(norm_silu(self.norm1, x, dt))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(norm_silu(self.norm2, h, dt))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class TimeConv(nn.Conv3d):
    """A (3, 1, 1) convolution over the frames of (1, C, F, H, W), zero
    padded by one frame at each end ('SAME'), computing in a given dtype;
    or (1, 1, 1)."""

    def __init__(self, in_ch, out_ch, dtype, k=3):
        super().__init__(in_ch, out_ch, (k, 1, 1))
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv3d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=(self.kernel_size[0] // 2, 0, 0))


class TemporalResnetBlock(nn.Module):
    """diffusers TemporalResnetBlock: (3, 1, 1) convolutions over the chunk
    as one video, GroupNorm statistics over all its frames. x: (F, C, H,
    W)."""

    def __init__(self, in_ch, out_ch, eps, dtype, temb_dim=None):
        super().__init__()
        self.norm1 = GroupNorm(32, in_ch, eps=eps)
        self.conv1 = TimeConv(in_ch, out_ch, dtype)
        if temb_dim is not None:
            self.time_emb_proj = Dense(temb_dim, out_ch, dtype)
        self.norm2 = GroupNorm(32, out_ch, eps=eps)
        self.conv2 = TimeConv(out_ch, out_ch, dtype)
        if in_ch != out_ch:
            self.conv_shortcut = TimeConv(in_ch, out_ch, dtype, k=1)

    def forward(self, x, temb=None):
        dt = self.conv1.compute_dtype
        v = x.transpose(0, 1)[None]          # (1, C, F, H, W)
        h = self.conv1(norm_silu(self.norm1, v, dt))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb)).t()[None, :, :, None,
                                                          None]
        h = self.conv2(norm_silu(self.norm2, h, dt))
        if hasattr(self, "conv_shortcut"):
            v = self.conv_shortcut(v)
        return (v + h)[0].transpose(0, 1)


class SpatioTemporalResBlock(nn.Module):
    """A spatial ResnetBlock2D, a TemporalResnetBlock on its output, and
    their AlphaBlender (``switch`` True in the UNet, False in the VAE
    decoder)."""

    def __init__(self, in_ch, out_ch, eps, dtype, temporal_eps=None,
                 temb_dim=None, switch=True):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(in_ch, out_ch, eps, dtype,
                                               temb_dim)
        self.temporal_res_block = TemporalResnetBlock(
            out_ch, out_ch, temporal_eps or eps, dtype, temb_dim)
        self.time_mixer = AlphaBlender(switch)

    def forward(self, x, temb=None):
        h = self.spatial_res_block(x, temb)
        return self.time_mixer(h, self.temporal_res_block(h, temb))


class Attention(nn.Module):
    """diffusers Attention: to_q / to_k / to_v (biased with ``qkv_bias``)
    and to_out.0 (biased) over (B, S, C); keys and values from ``context``
    (B, S_ctx, context_dim) when given."""

    def __init__(self, dim, heads, dtype, qkv_bias=False, context_dim=None):
        super().__init__()
        self.heads = heads
        kv = context_dim or dim
        self.to_q = Dense(dim, dim, dtype, bias=qkv_bias)
        self.to_k = Dense(kv, dim, dtype, bias=qkv_bias)
        self.to_v = Dense(kv, dim, dtype, bias=qkv_bias)
        self.to_out = Dense(dim, dim, dtype)

    def forward(self, x, context=None):
        context = x if context is None else context
        b, s, c = x.shape

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads,
                             -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(
            heads(self.to_q(x)), heads(self.to_k(context)),
            heads(self.to_v(context)))
        return self.to_out(o.transpose(1, 2).reshape(b, s, c))


class FeedForward(nn.Module):
    """diffusers FeedForward with GEGLU (exact gelu in float32)."""

    def __init__(self, dim, dtype):
        super().__init__()
        self.proj = Dense(dim, dim * 8, dtype)
        self.out = Dense(dim * 4, dim, dtype)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(a * F.gelu(gate.float()).to(a.dtype))


class BasicTransformerBlock(nn.Module):
    """self-attention -> cross-attention -> GEGLU feed-forward, each after
    a LayerNorm (eps 1e-5)."""

    def __init__(self, dim, heads, context_dim, dtype):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dtype, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x, context):
        dt = self.dtype
        x = x + self.attn1(self.norm1(x).to(dt))
        x = x + self.attn2(self.norm2(x).to(dt), context)
        return x + self.ff(self.norm3(x).to(dt))


class TemporalBasicTransformerBlock(nn.Module):
    """diffusers TemporalBasicTransformerBlock over (F, S, C): the frames
    become the sequence of each token; an ff_in residual, then temporal
    self-attention, cross-attention and feed-forward."""

    def __init__(self, dim, heads, context_dim, dtype):
        super().__init__()
        self.dtype = dtype
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim, dtype)
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, dtype, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim, dtype)

    def forward(self, x, time_context):
        dt = self.dtype
        h = x.transpose(0, 1)                      # (S, F, C)
        h = self.ff_in(self.norm_in(h).to(dt)) + h
        h = h + self.attn1(self.norm1(h).to(dt))
        h = h + self.attn2(self.norm2(h).to(dt), time_context)
        h = h + self.ff(self.norm3(h).to(dt))
        return h.transpose(0, 1)


class TransformerST(nn.Module):
    """diffusers TransformerSpatioTemporalModel (one video). x: (F, C, H,
    W); context: (F, S_ctx, context_dim)."""

    def __init__(self, ch, heads, context_dim, dtype, n_layers=1):
        super().__init__()
        self.dtype = dtype
        self.n_layers = n_layers
        self.norm = GroupNorm(32, ch, eps=1e-6)
        self.proj_in = Dense(ch, ch, dtype)
        self.time_pos_embed = TimestepMLP(ch, ch, dtype, inner_dim=ch * 4)
        for i in range(n_layers):
            setattr(self, f"block{i}", BasicTransformerBlock(
                ch, heads, context_dim, dtype))
            setattr(self, f"tblock{i}", TemporalBasicTransformerBlock(
                ch, heads, context_dim, dtype))
        self.time_mixer = AlphaBlender(False)    # shared by the layers
        self.proj_out = Dense(ch, ch, dtype)

    def forward(self, x, context):
        f, c, hh, ww = x.shape
        h = self.norm(x).reshape(f, c, hh * ww).transpose(1, 2).to(
            self.dtype)
        h = self.proj_in(h)
        # frame-index positional embedding (sinusoidal over 0..F-1)
        emb = self.time_pos_embed(timesteps_embed(
            torch.arange(f, dtype=torch.float32, device=x.device), c))[:,
                                                                      None]
        # temporal cross-attention context: the first frame's, per pixel
        time_context = context[:1].expand((hh * ww,) + context.shape[1:])
        for i in range(self.n_layers):
            h_sp = getattr(self, f"block{i}")(h, context)
            h_mix = getattr(self, f"tblock{i}")(h_sp + emb, time_context)
            h = self.time_mixer(h_sp, h_mix)
        h = self.proj_out(h)
        return h.transpose(1, 2).reshape(f, c, hh, ww) + x


class SVDUNet(nn.Module):
    """UNetSpatioTemporalConditionModel. ``forward(x, c_noise, context,
    added_time_ids)`` -> the raw model output; the EDM pre- and
    post-conditioning is :func:`svd_denoise`. ``in_channels`` defaults to
    ``cfg.in_channels``."""

    def __init__(self, cfg: SVDConfig = SVDConfig(), in_channels=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        ted, boc = cfg.time_embed_dim, cfg.block_out_channels
        ctx = cfg.cross_attention_dim
        self.time_embedding = TimestepMLP(boc[0], ted, dt)
        self.add_embedding = TimestepMLP(3 * cfg.addition_time_embed_dim,
                                         ted, dt)
        self.conv_in = Conv(in_channels or cfg.in_channels, boc[0], 3, dt)
        n = len(boc)
        ch_in, skips = boc[0], [boc[0]]
        for i, ch in enumerate(boc):
            cross = i < n - 1   # the last down block has no attention
            eps = 1e-6 if cross else 1e-5
            for j in range(cfg.layers_per_block):
                setattr(self, f"down{i}_res{j}", SpatioTemporalResBlock(
                    ch_in, ch, eps, dt, temb_dim=ted))
                if cross:
                    setattr(self, f"down{i}_attn{j}", TransformerST(
                        ch, cfg.num_attention_heads[i], ctx, dt,
                        cfg.transformer_layers_per_block))
                ch_in = ch
                skips.append(ch)
            if i < n - 1:
                setattr(self, f"down{i}_pool", Conv(ch, ch, 3, dt, stride=2,
                                                    padding=((1, 1), (1, 1))))
                skips.append(ch)
        mid = boc[-1]
        self.mid_res0 = SpatioTemporalResBlock(mid, mid, 1e-5, dt,
                                               temb_dim=ted)
        self.mid_attn = TransformerST(mid, cfg.num_attention_heads[-1], ctx,
                                      dt, cfg.transformer_layers_per_block)
        self.mid_res1 = SpatioTemporalResBlock(mid, mid, 1e-5, dt,
                                               temb_dim=ted)
        for i in reversed(range(n)):
            ch = boc[i]
            cross = i < n - 1
            eps = 1e-6 if cross else 1e-5
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up{i}_res{j}", SpatioTemporalResBlock(
                    ch_in + skips.pop(), ch, eps, dt, temb_dim=ted))
                if cross:
                    setattr(self, f"up{i}_attn{j}", TransformerST(
                        ch, cfg.num_attention_heads[i], ctx, dt,
                        cfg.transformer_layers_per_block))
                ch_in = ch
            if i > 0:
                setattr(self, f"up{i}_upconv", Conv(ch, ch, 3, dt))
        self.conv_norm_out = GroupNorm(32, ch_in, eps=1e-5)
        self.conv_out = Conv(ch_in, cfg.out_channels, 3, torch.float32)

    def forward(self, x, c_noise, context, added_time_ids):
        """x: (F, H, W, in_channels), already input-scaled; c_noise: a 0-d
        tensor; context: (1 or F, S, cross_dim); added_time_ids: (3,) ->
        (F, H, W, out_channels) float32."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        f = x.shape[0]
        ted = cfg.time_embed_dim
        n = len(cfg.block_out_channels)
        emb = self.time_embedding(timesteps_embed(
            c_noise.reshape(1), cfg.block_out_channels[0]))
        aug = self.add_embedding(timesteps_embed(
            added_time_ids, cfg.addition_time_embed_dim).reshape(1, -1))
        emb = (emb + aug).expand(f, ted).to(dt)
        if context.shape[0] == 1:
            context = context.expand((f,) + context.shape[1:])
        context = context.to(dt)

        h = self.conv_in(to_cf(x).to(dt))
        skips = [h]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down{i}_res{j}")(h, emb)
                if i < n - 1:
                    h = getattr(self, f"down{i}_attn{j}")(h, context)
                skips.append(h)
            if i < n - 1:
                h = getattr(self, f"down{i}_pool")(h)
                skips.append(h)
        h = self.mid_res0(h, emb)
        h = self.mid_attn(h, context)
        h = self.mid_res1(h, emb)
        for i in reversed(range(n)):
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up{i}_res{j}")(h, emb)
                if i < n - 1:
                    h = getattr(self, f"up{i}_attn{j}")(h, context)
            if i > 0:
                h = resize_nearest(h, (h.shape[2] * 2, h.shape[3] * 2))
                h = getattr(self, f"up{i}_upconv")(h)
        h = self.conv_out(norm_silu(self.conv_norm_out, h, torch.float32))
        return to_cl(h)


def svd_denoise(unet, z, sigma, context, added_time_ids, cond_concat=None):
    """EDM pre- and post-conditioning around the raw UNet (the SVD recipe,
    v-prediction): in = z / sqrt(sigma^2 + 1) [++ conditioning channels];
    out = z / (sigma^2 + 1) - sigma / sqrt(sigma^2 + 1) * F(in,
    ln(sigma) / 4)."""
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=z.device)
    x = z * (1.0 / torch.sqrt(sig ** 2 + 1.0))
    if cond_concat is not None:
        x = torch.cat([x, cond_concat.to(x.dtype)], dim=-1)
    raw = unet(x, 0.25 * torch.log(sig), context, added_time_ids)
    return z / (sig ** 2 + 1.0) - raw * sig / torch.sqrt(sig ** 2 + 1.0)


# --------------------------------------------------------------------------
# VAE: the SD KL encoder + the temporal decoder


@dataclasses.dataclass(frozen=True)
class SVDVAEConfig:
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    out_channels: int = 3
    scaling_factor: float = 0.18215
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return _dtype(self.dtype)


SVD_VAE_TINY = SVDVAEConfig(block_out_channels=(32, 64),
                            layers_per_block=1, dtype="float32")


class VAEAttention(nn.Module):
    """The SD VAE's mid attention: GroupNorm 32 -> one-head attention with
    biased q, k, v, in float32 -> residual."""

    def __init__(self, ch):
        super().__init__()
        self.group_norm = GroupNorm(32, ch, eps=1e-6)
        self.attn = Attention(ch, 1, torch.float32, qkv_bias=True)

    def forward(self, x):
        f, c, hh, ww = x.shape
        h = self.group_norm(x).reshape(f, c, hh * ww).transpose(1, 2)
        h = self.attn(h)
        return x + h.transpose(1, 2).reshape(f, c, hh, ww).to(x.dtype)


class SVDVAEEncoder(nn.Module):
    """The SD KL encoder and quant_conv: (F, H, W, 3) in [-1, 1] -> the
    scaled latent mode (F, H/8, W/8, latent). No op mixes frames, so any
    frame segmentation gives the same latents."""

    def __init__(self, cfg: SVDVAEConfig = SVDVAEConfig()):
        super().__init__()
        self.cfg = cfg
        dt, boc = cfg.compute_dtype, cfg.block_out_channels
        self.conv_in = Conv(3, boc[0], 3, dt)
        ch_in = boc[0]
        for i, ch in enumerate(boc):
            for j in range(cfg.layers_per_block):
                setattr(self, f"down{i}_res{j}",
                        ResnetBlock2D(ch_in, ch, 1e-6, dt))
                ch_in = ch
            if i < len(boc) - 1:
                # torch pads (0, 1, 0, 1), then a stride-2 conv without pad
                setattr(self, f"down{i}_pool", Conv(
                    ch, ch, 3, dt, stride=2, padding=((0, 1), (0, 1))))
        self.mid_res0 = ResnetBlock2D(ch_in, ch_in, 1e-6, dt)
        self.mid_attn = VAEAttention(ch_in)
        self.mid_res1 = ResnetBlock2D(ch_in, ch_in, 1e-6, dt)
        self.conv_norm_out = GroupNorm(32, ch_in, eps=1e-6)
        lat2 = 2 * cfg.latent_channels
        self.conv_out = Conv(ch_in, lat2, 3, torch.float32)
        self.quant_conv = Conv(lat2, lat2, 1, torch.float32)

    def forward(self, x):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.conv_in(to_cf(x).to(cfg.compute_dtype))
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down{i}_res{j}")(h)
            if i < n - 1:
                h = getattr(self, f"down{i}_pool")(h)
        h = self.mid_res1(self.mid_attn(self.mid_res0(h)))
        h = self.conv_out(norm_silu(self.conv_norm_out, h, torch.float32))
        h = self.quant_conv(h)
        return to_cl(h[:, :cfg.latent_channels]) * cfg.scaling_factor


class SVDVAEDecoder(nn.Module):
    """The temporal decoder: SpatioTemporalResBlocks (``switch`` False, no
    time embedding) and a trailing (3, 1, 1) ``time_conv_out``. (F, h, w,
    latent) -> (F, 8h, 8w, out_channels) in about [-1, 1]."""

    def __init__(self, cfg: SVDVAEConfig = SVDVAEConfig()):
        super().__init__()
        self.cfg = cfg
        dt, boc = cfg.compute_dtype, cfg.block_out_channels
        ch = boc[-1]

        def st(cin, cout):
            return SpatioTemporalResBlock(cin, cout, 1e-6, dt,
                                          temporal_eps=1e-5, switch=False)
        self.conv_in = Conv(cfg.latent_channels, ch, 3, dt)
        self.mid_res0 = st(ch, ch)
        self.mid_attn = VAEAttention(ch)
        for j in range(1, cfg.layers_per_block):
            setattr(self, f"mid_res{j}", st(ch, ch))
        ch_in = ch
        for oi, i in enumerate(reversed(range(len(boc)))):
            for j in range(cfg.layers_per_block + 1):
                setattr(self, f"up{oi}_res{j}", st(ch_in, boc[i]))
                ch_in = boc[i]
            if i > 0:
                setattr(self, f"up{oi}_upconv", Conv(ch_in, ch_in, 3, dt))
        self.conv_norm_out = GroupNorm(32, ch_in, eps=1e-6)
        self.conv_out = Conv(ch_in, cfg.out_channels, 3, torch.float32)
        self.time_conv_out = TimeConv(cfg.out_channels, cfg.out_channels,
                                      torch.float32)

    def forward(self, z):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.conv_in(to_cf(z / cfg.scaling_factor).to(cfg.compute_dtype))
        h = self.mid_attn(self.mid_res0(h))
        for j in range(1, cfg.layers_per_block):
            h = getattr(self, f"mid_res{j}")(h)
        for oi, i in enumerate(reversed(range(n))):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up{oi}_res{j}")(h)
            if i > 0:
                h = resize_nearest(h, (h.shape[2] * 2, h.shape[3] * 2))
                h = getattr(self, f"up{oi}_upconv")(h)
        h = self.conv_out(norm_silu(self.conv_norm_out, h, torch.float32))
        h = self.time_conv_out(h.transpose(0, 1)[None])[0].transpose(0, 1)
        return to_cl(h)


class SVDInpainter(nn.Module):
    """StereoCrafter-shaped inpainter: the SVD VAE and a channel-concat
    conditioned SVD UNet, with the encode / denoise / decode methods of
    ``models.diffusion.VideoInpainter``, so ``DiffusionInfillEngine``
    drives either. ``mono``: the conditioning also carries a mono latent
    (``cfg.in_channels`` + latent channels in)."""

    def __init__(self, cfg: SVDConfig = SVDConfig(),
                 vae_cfg: SVDVAEConfig = SVDVAEConfig(), fps=6.0,
                 motion_bucket_id=127.0, noise_aug_strength=0.02,
                 mono=False):
        super().__init__()
        self.cfg = cfg
        self.vae_encoder = SVDVAEEncoder(vae_cfg)
        self.vae_decoder = SVDVAEDecoder(vae_cfg)
        self.unet = SVDUNet(cfg, cfg.in_channels
                            + (vae_cfg.latent_channels if mono else 0))
        self.register_buffer(
            "added_time_ids", torch.tensor([fps, motion_bucket_id,
                                            noise_aug_strength]),
            persistent=False)

    def encode(self, frames):
        """(F, H, W, 3) in [0, 1] -> the scaled latent mode."""
        return self.vae_encoder(frames * 2.0 - 1.0)

    def decode(self, z):
        return torch.clamp((self.vae_decoder(z) + 1.0) / 2.0, 0.0, 1.0)

    def denoise(self, z, sigma, cond, context=None):
        """The EDM denoiser; ``context``: the CLIP image embedding (1, 1,
        cross_dim), zeros when None."""
        if context is None:
            context = torch.zeros((1, 1, self.cfg.cross_attention_dim),
                                  device=z.device)
        return svd_denoise(self.unet, z, sigma, context,
                           self.added_time_ids, cond)
