"""Temporally consistent video depth, Video-Depth-Anything (PyTorch port
of ``models/video_depth.py``).

The DINOv2 backbone runs per frame; the DPT head carries four temporal
("motion") modules, each GroupNorm -> proj_in -> a transformer block of
two temporal self-attentions (sinusoidal position encoding over the frame
axis) and a GEGLU feed-forward -> proj_out -> residual. Long clips run in
overlapping windows, each scale/shift-aligned to the previous one on the
overlap. Names follow the Flax tree of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.models.vit import (Conv, Dense,
                                                             layer_norm)
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device
from metric_depth_video_toolbox_tpu_torch.utils.timer import add, span

GN_EPS = 1e-6   # flax.linen.GroupNorm's default


@dataclasses.dataclass(frozen=True)
class VideoDepthConfig:
    vit: vit_mod.ViTConfig = vit_mod.VIT_L
    dpt: dpt_mod.DPTConfig = dpt_mod.DPTConfig()
    temporal_heads: int = 8
    temporal_layers: int = 1
    norm_groups: int = 32
    pe_max_len: int = 4096
    window: int = 32
    overlap: int = 8


def _sinusoidal_pe(t, d):
    """AnimateDiff positional encoding (t, d): interleaved sin/cos of
    pos / 10000^(2i/d)."""
    pos = np.arange(t, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * (-np.log(10000.0) / d))
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: (d + 1) // 2])
    return pe


class TemporalAttention(nn.Module):
    """Per spatial token, attention across the frame axis."""

    def __init__(self, dim, heads, dtype):
        super().__init__()
        self.heads = heads
        self.to_q = Dense(dim, dim, dtype, bias=False)
        self.to_k = Dense(dim, dim, dtype, bias=False)
        self.to_v = Dense(dim, dim, dtype, bias=False)
        self.to_out = Dense(dim, dim, dtype)

    def forward(self, x):
        """x: (N, T, C) -- N spatial tokens, T frames."""
        n, t, c = x.shape
        pe = torch.from_numpy(_sinusoidal_pe(t, c)).to(x.device, x.dtype)
        x = x + pe

        def heads(y):
            return y.reshape(n, t, self.heads, c // self.heads).transpose(1, 2)

        out = F.scaled_dot_product_attention(
            heads(self.to_q(x)), heads(self.to_k(x)), heads(self.to_v(x)))
        return self.to_out(out.transpose(1, 2).reshape(n, t, c))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim, heads, dtype, n_attn=2):
        super().__init__()
        self.n_attn = n_attn
        for i in range(n_attn):
            self.add_module(f"norm{i}", nn.LayerNorm(dim, eps=vit_mod.LN_EPS))
            self.add_module(f"attn{i}", TemporalAttention(dim, heads, dtype))
        self.ff_norm = nn.LayerNorm(dim, eps=vit_mod.LN_EPS)
        self.geglu = Dense(dim, dim * 8, dtype)
        self.ff_out = Dense(dim * 4, dim, dtype)

    def forward(self, x):
        for i in range(self.n_attn):
            y = layer_norm(getattr(self, f"norm{i}"), x)
            x = x + getattr(self, f"attn{i}")(y)
        h, gate = self.geglu(layer_norm(self.ff_norm, x)).chunk(2, dim=-1)
        return x + self.ff_out(h * F.gelu(gate))


class TemporalModule(nn.Module):
    """GroupNorm -> proj_in -> blocks -> proj_out -> residual over a frame
    stack (T, H, W, C)."""

    def __init__(self, dim, heads, layers, groups, dtype):
        super().__init__()
        self.norm = nn.GroupNorm(min(groups, dim), dim, eps=GN_EPS)
        self.proj_in = Dense(dim, dim, dtype)
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block{i}",
                            TemporalTransformerBlock(dim, heads, dtype))
        self.proj_out = Dense(dim, dim, dtype)

    def forward(self, x):
        t, h, w, c = x.shape
        y = F.group_norm(x.to(torch.float32).permute(0, 3, 1, 2),
                         self.norm.num_groups, self.norm.weight,
                         self.norm.bias, GN_EPS).permute(0, 2, 3, 1)
        y = self.proj_in(y.reshape(t, h * w, c)).transpose(0, 1)
        for i in range(self.layers):
            y = getattr(self, f"block{i}")(y)
        y = self.proj_out(y.transpose(0, 1))
        return y.reshape(t, h, w, c) + x


class DPTHeadTemporal(nn.Module):
    """DPT head with motion modules 0/1 on the two coarsest reassembled
    levels and 2/3 on the outputs of the two coarsest fusions."""

    def __init__(self, cfg: VideoDepthConfig):
        super().__init__()
        d = cfg.dpt
        self.cfg = cfg
        dt, f = d.compute_dtype, d.features
        for i, ch in enumerate(d.out_channels):
            self.add_module(f"project{i}", Conv(cfg.vit.embed_dim, ch, 1, dt))
            self.add_module(f"scratch{i}", Conv(ch, f, 3, dt, bias=False))
        dpt_mod.add_resize_layers(self, d)
        dims = (d.out_channels[2], d.out_channels[3], f, f)
        for i, dim in enumerate(dims):
            self.add_module(f"motion{i}", TemporalModule(
                dim, cfg.temporal_heads, cfg.temporal_layers,
                cfg.norm_groups, dt))
        for i in range(4):
            self.add_module(f"fusion{i}", dpt_mod.FeatureFusion(d, i != 3))
        self.head_conv1 = Conv(f, f // 2, 3, dt)
        self.head_conv2 = Conv(f // 2, 32, 3, dt)
        self.head_conv3 = Conv(32, 1, 1, torch.float32)

    def forward(self, feats):
        c = self.cfg
        d = c.dpt
        _, gh, gw, _ = feats[0].shape
        pyr = []
        for i, f in enumerate(feats):
            y = dpt_mod.reassemble(self, d, i,
                                   getattr(self, f"project{i}")(f), (gh, gw))
            if i >= 2:      # motion0 / motion1 on the two coarsest levels
                y = getattr(self, f"motion{i - 2}")(y)
            pyr.append(getattr(self, f"scratch{i}")(y))
        x = dpt_mod.fuse(self, d, pyr, lambda i, x: getattr(
            self, f"motion{i + 2}")(x))
        x = self.head_conv1(x)
        full_hw = (gh * c.vit.patch_size, gw * c.vit.patch_size)
        up = dpt_mod.upsample(d)
        if d.fast_head:
            x = up(torch.relu(self.head_conv2(x)), full_hw)
        else:
            x = torch.relu(self.head_conv2(up(x, full_hw)))
        return dpt_mod.head_activation(d, self.head_conv3(x))


class VideoDepthAnything(nn.Module):
    """frames (T, H, W, 3) in [0, 1] at ``work_hw`` -> (T, H, W) relative
    disparity (float32)."""

    def __init__(self, cfg: VideoDepthConfig, work_hw):
        super().__init__()
        self.cfg = cfg
        p = cfg.vit.patch_size
        self.backbone = vit_mod.ViT(cfg.vit,
                                    (work_hw[0] // p) * (work_hw[1] // p))
        self.head = DPTHeadTemporal(cfg)

    def forward(self, frames):
        n, dev = frames.shape[0], frames.device
        with span("depth.encoder", device=dev, frames=n):
            feats, _ = self.backbone(frames)
        with span("depth.head", device=dev, frames=n):
            return self.head(feats)[..., 0].to(torch.float32)


def stitch_windows(window_disps, overlap, total):
    """Scale/shift-align each window's disparity (W_i, H, W) to the
    previous one on the overlap, then concatenate to ``total`` frames."""
    out = [window_disps[0]]
    for disp in window_disps[1:]:
        s, t = solvers.scale_and_shift(disp[:overlap], out[-1][-overlap:])
        out.append((disp * s + t)[overlap:])
    return torch.cat(out, dim=0)[:total]


@torch.no_grad()
def infer_video_depth(model, frames_u8, work_hw, out_hw, window=32,
                      overlap=8, device=None, mesh=None):
    """Sliding-window video depth over a clip of any length.

    frames_u8: (T, H, W, 3) uint8 numpy or tensor. Returns (T, out_h,
    out_w) float32 relative disparity on ``device`` (resolved as
    :func:`~metric_depth_video_toolbox_tpu_torch.utils.device.resolve_device`
    does: CUDA unless the CPU is asked for), stitched.

    ``mesh``: None, or ``model``'s ``parallel.sharding.FrameReplicas``
    (with its motion modules marked temporal): each window's time axis
    splits over the replicas."""
    device = resolve_device(device)
    t_total = frames_u8.shape[0]
    overlap = min(overlap, window - 1)
    step = max(window - overlap, 1)
    frames = torch.as_tensor(frames_u8)
    starts = [0]
    while starts[-1] + window < t_total:
        starts.append(starts[-1] + step)
    disps = []
    for s0 in starts:
        end = min(s0 + window, t_total)
        with span("depth.window", views=window,
                  new=end - (s0 + overlap if s0 else 0),
                  padded=s0 + window - end):
            idx = torch.clamp(torch.arange(s0, s0 + window), max=t_total - 1)
            with span("depth.to_device"):
                x = frames[idx]
                add("bytes", x.nbytes)
                x = x.to(device)
            x = x.to(torch.float32).permute(0, 3, 1, 2)
            x = resize_nchw(x / 255.0, work_hw).permute(0, 2, 3, 1)
            d = model(x) if mesh is None else mesh(lambda m, xs: m(xs), x)
            d = resize_nchw(d[:, None], out_hw)[:, 0]
            disps.append(d[: end - s0])
    if len(disps) == 1:
        return disps[0][:t_total]
    with span("depth.align"):
        return stitch_windows(disps, overlap, t_total)
