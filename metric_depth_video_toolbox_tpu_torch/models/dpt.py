"""DPT decoder head (PyTorch port of ``models/dpt.py``).

Reassemble 4 ViT feature levels into a pyramid (x4, x2, x1, x0.5 of the
token grid), fuse coarse-to-fine with residual conv units, and regress
per-pixel depth. NHWC throughout; names follow the Flax tree.

Two decodes, as in the JAX package. The default (``torch_resize=False``)
moves the levels with half-pixel bilinear resizes. ``torch_resize=True``
is the weight-exact decode of converted upstream checkpoints: the learned
resize layers ``resize0`` (ConvTranspose 4x4, stride 4), ``resize1``
(2x2, stride 2) and ``resize3`` (Conv 3x3, stride 2, padding 1), bilinear
``align_corners=True`` resizes in the fusions and the head, and a x2
upsample in ``fusion0``; with ``fast_head=False`` the head's 3x3 conv
runs after the full-resolution upsample, in the upstream order.
PromptDA's head adds a prompt branch to every fusion (``prompt=True``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.vit import Conv
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw

SCALES = (4, 2, 1, 0.5)


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    features: int = 128
    out_channels: Sequence[int] = (96, 192, 384, 768)
    dtype: str = "bfloat16"
    # run the head's 3x3 convs before the final full-resolution upsample
    fast_head: bool = True
    # the weight-exact torch decode (learned resize layers,
    # align_corners=True upsampling, fusion0's x2 upsample)
    torch_resize: bool = False
    head_act: str = "relu"
    n_out: int = 1

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


DPT_TINY = DPTConfig(features=32, out_channels=(16, 32, 48, 64))


def _resize(x, hw):
    """Bilinear NHWC resize, half-pixel centers, antialiased when shrinking
    (``jax.image.resize(..., "bilinear")``)."""
    return resize_nchw(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


def _interp_mat_ac(n_in, n_out):
    """(n_out, n_in) bilinear interpolation matrix, ``align_corners=True``:
    src = i * (n_in - 1) / (n_out - 1)."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    w = src - lo
    m[np.arange(n_out), lo] = 1.0 - w
    m[np.arange(n_out), lo + 1] = w
    return m


def resize_align_corners(x, hw):
    """NHWC bilinear resize of ``F.interpolate(align_corners=True)``, as
    the JAX package computes it: two products with the interpolation
    matrices, in the input's dtype."""
    _, h, w, _ = x.shape
    oh, ow = hw
    if oh != h:
        mh = torch.from_numpy(_interp_mat_ac(h, oh)).to(x.device, x.dtype)
        x = torch.einsum("oh,bhwc->bowc", mh, x)
    if ow != w:
        mw = torch.from_numpy(_interp_mat_ac(w, ow)).to(x.device, x.dtype)
        x = torch.einsum("ow,bhwc->bhoc", mw, x)
    return x


def upsample(cfg: DPTConfig):
    """The decode's bilinear resize: align_corners in the weight-exact
    decode, else half-pixel."""
    return resize_align_corners if cfg.torch_resize else _resize


class ConvTranspose(nn.ConvTranspose2d):
    """NHWC flax ``nn.ConvTranspose`` with kernel = stride ('SAME' adds no
    overlap then): ``ConvTranspose2d(k, stride=k)`` with the flax kernel
    flipped (``models.from_jax`` flips it), ``ch`` -> ``out_ch`` (default
    ``ch``) channels, computing in a given dtype."""

    def __init__(self, ch, k, dtype, out_ch=None, bias=True):
        super().__init__(ch, out_ch or ch, k, stride=k, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose2d(
            x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
            self.bias.to(dt) if self.bias is not None else None,
            stride=self.stride)
        return y.permute(0, 2, 3, 1)


def add_resize_layers(module, cfg: DPTConfig):
    """The weight-exact decode's learned resize layers, on ``module``."""
    if cfg.torch_resize:
        ch, dt = cfg.out_channels, cfg.compute_dtype
        module.resize0 = ConvTranspose(ch[0], 4, dt)
        module.resize1 = ConvTranspose(ch[1], 2, dt)
        # torch Conv2d(k3, s2, p1); flax 'SAME' at stride 2 would pad (0, 1)
        module.resize3 = Conv(ch[3], ch[3], 3, dt, stride=2, padding=1)


def reassemble(module, cfg: DPTConfig, i, y, grid_hw):
    """Move projected level ``i`` to its pyramid scale (x4, x2, x1, x0.5
    of the token grid ``grid_hw``)."""
    if cfg.torch_resize:
        return y if i == 2 else getattr(module, f"resize{i}")(y)
    gh, gw = grid_hw
    return _resize(y, (int(gh * SCALES[i]), int(gw * SCALES[i])))


def fuse(module, cfg: DPTConfig, pyr, between=None, prompt=None):
    """The four fusions, coarse to fine; ``between(i, x)`` (if given) runs
    on the output of ``fusion3`` (i = 0) and ``fusion2`` (i = 1).
    ``prompt``: PromptDA's normalized prompt depth (B, h, w, 1), which
    every fusion's prompt branch adds in."""
    def hook(i, x):
        return between(i, x) if between is not None else x

    x = hook(0, module.fusion3(pyr[3], out_hw=pyr[2].shape[1:3],
                               prompt=prompt))
    x = hook(1, module.fusion2(x, skip=pyr[2], out_hw=pyr[1].shape[1:3],
                               prompt=prompt))
    x = module.fusion1(x, skip=pyr[1], out_hw=pyr[0].shape[1:3],
                       prompt=prompt)
    last_hw = ((pyr[0].shape[1] * 2, pyr[0].shape[2] * 2)
               if cfg.torch_resize else None)
    return module.fusion0(x, skip=pyr[0], out_hw=last_hw, prompt=prompt)


class ResidualConvUnit(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f, dt = cfg.features, cfg.compute_dtype
        self.conv1 = Conv(f, f, 3, dt)
        self.conv2 = Conv(f, f, 3, dt)

    def forward(self, x):
        y = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        return x + y


class PromptLayer(nn.Module):
    """PromptDA's depth-prompt branch of a fusion level: conv-relu-conv-
    relu-conv over the normalized prompt depth at the level's size."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f, dt = cfg.features, cfg.compute_dtype
        self.conv1 = Conv(1, f, 3, dt)
        self.conv2 = Conv(f, f, 3, dt)
        self.conv3 = Conv(f, f, 3, dt)

    def forward(self, p):
        return self.conv3(torch.relu(self.conv2(torch.relu(self.conv1(p)))))


class FeatureFusion(nn.Module):
    def __init__(self, cfg: DPTConfig, has_skip: bool, prompt=False):
        super().__init__()
        self.up = upsample(cfg)
        if has_skip:
            self.rcu1 = ResidualConvUnit(cfg)
        self.rcu2 = ResidualConvUnit(cfg)
        if prompt:
            self.prompt = PromptLayer(cfg)
        self.project = Conv(cfg.features, cfg.features, 1, cfg.compute_dtype)

    def forward(self, x, skip=None, out_hw=None, prompt=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        if prompt is not None:
            # to the level's size: half-pixel bilinear, no antialias
            p = F.interpolate(prompt.permute(0, 3, 1, 2).to(torch.float32),
                              size=tuple(x.shape[1:3]), mode="bilinear",
                              align_corners=False)
            x = x + self.prompt(p.permute(0, 2, 3, 1).to(x.dtype))
        if out_hw is not None:
            x = self.up(x, out_hw)
        return self.project(x)


class DPTHead(nn.Module):
    """4 ViT feature maps (B, gh, gw, D) -> (B, gh*patch, gw*patch, n_out).
    ``prompt``: every fusion has PromptDA's prompt branch, and ``forward``
    takes the normalized prompt depth."""

    def __init__(self, cfg: DPTConfig, embed_dim: int, patch_size: int = 14,
                 prompt=False):
        super().__init__()
        self.cfg = cfg
        self.patch_size = patch_size
        dt, f = cfg.compute_dtype, cfg.features
        for i, ch in enumerate(cfg.out_channels):
            self.add_module(f"project{i}", Conv(embed_dim, ch, 1, dt))
            self.add_module(f"scratch{i}", Conv(ch, f, 3, dt, bias=False))
        add_resize_layers(self, cfg)
        for i in range(4):
            self.add_module(f"fusion{i}", FeatureFusion(cfg, i != 3, prompt))
        self.head_conv1 = Conv(f, f // 2, 3, dt)
        self.head_conv2 = Conv(f // 2, 32, 3, dt)
        self.head_conv3 = Conv(32, cfg.n_out, 1, torch.float32)

    def forward(self, feats, prompt=None):
        c = self.cfg
        _, gh, gw, _ = feats[0].shape
        pyr = []
        for i, f in enumerate(feats):
            y = reassemble(self, c, i, getattr(self, f"project{i}")(f),
                           (gh, gw))
            pyr.append(getattr(self, f"scratch{i}")(y))
        x = self.head_conv1(fuse(self, c, pyr, prompt=prompt))
        full_hw = (gh * self.patch_size, gw * self.patch_size)
        up = upsample(c)
        if c.fast_head:
            # the 1x1 conv commutes with the bilinear upsample
            x = self.head_conv3(torch.relu(self.head_conv2(x)))
            x = up(x, full_hw)
        else:
            x = torch.relu(self.head_conv2(up(x, full_hw)))
            x = self.head_conv3(x)
        return head_activation(c, x)


def head_activation(cfg: DPTConfig, x):
    if cfg.head_act == "sigmoid":
        return torch.sigmoid(x)
    if cfg.head_act == "none":
        return x
    return torch.relu(x)
