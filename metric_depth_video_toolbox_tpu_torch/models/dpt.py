"""DPT decoder head (PyTorch port of ``models/dpt.py``, default
configuration ``fast_head=True, torch_resize=False``).

Reassemble 4 ViT feature levels into a pyramid (x4, x2, x1, x0.5 of the
token grid, bilinear), fuse coarse-to-fine with residual conv units, and
regress per-pixel depth. NHWC throughout; names follow the Flax tree.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
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
    # align_corners=True upsampling) is not ported yet (ROADMAP A5)
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


def check_config(cfg: DPTConfig):
    if cfg.torch_resize:
        raise NotImplementedError("not ported yet: DPTConfig(torch_resize="
                                  "True) (ROADMAP A5)")


class ResidualConvUnit(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f, dt = cfg.features, cfg.compute_dtype
        self.conv1 = Conv(f, f, 3, dt)
        self.conv2 = Conv(f, f, 3, dt)

    def forward(self, x):
        y = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        return x + y


class FeatureFusion(nn.Module):
    def __init__(self, cfg: DPTConfig, has_skip: bool):
        super().__init__()
        if has_skip:
            self.rcu1 = ResidualConvUnit(cfg)
        self.rcu2 = ResidualConvUnit(cfg)
        self.project = Conv(cfg.features, cfg.features, 1, cfg.compute_dtype)

    def forward(self, x, skip=None, out_hw=None):
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        if out_hw is not None:
            x = _resize(x, out_hw)
        return self.project(x)


class DPTHead(nn.Module):
    """4 ViT feature maps (B, gh, gw, D) -> (B, gh*patch, gw*patch, n_out)."""

    def __init__(self, cfg: DPTConfig, embed_dim: int, patch_size: int = 14):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.patch_size = patch_size
        dt, f = cfg.compute_dtype, cfg.features
        for i, ch in enumerate(cfg.out_channels):
            self.add_module(f"project{i}", Conv(embed_dim, ch, 1, dt))
            self.add_module(f"scratch{i}", Conv(ch, f, 3, dt, bias=False))
        for i in range(4):
            self.add_module(f"fusion{i}", FeatureFusion(cfg, i != 3))
        self.head_conv1 = Conv(f, f // 2, 3, dt)
        self.head_conv2 = Conv(f // 2, 32, 3, dt)
        self.head_conv3 = Conv(32, cfg.n_out, 1, torch.float32)

    def forward(self, feats):
        c = self.cfg
        _, gh, gw, _ = feats[0].shape
        pyr = []
        for i, f in enumerate(feats):
            y = getattr(self, f"project{i}")(f)
            y = _resize(y, (int(gh * SCALES[i]), int(gw * SCALES[i])))
            pyr.append(getattr(self, f"scratch{i}")(y))
        x = self.fusion3(pyr[3], out_hw=pyr[2].shape[1:3])
        x = self.fusion2(x, skip=pyr[2], out_hw=pyr[1].shape[1:3])
        x = self.fusion1(x, skip=pyr[1], out_hw=pyr[0].shape[1:3])
        x = self.fusion0(x, skip=pyr[0])
        x = self.head_conv1(x)
        full_hw = (gh * self.patch_size, gw * self.patch_size)
        if c.fast_head:
            # the 1x1 conv commutes with the bilinear upsample
            x = self.head_conv3(torch.relu(self.head_conv2(x)))
            x = _resize(x, full_hw)
        else:
            x = torch.relu(self.head_conv2(_resize(x, full_hw)))
            x = self.head_conv3(x)
        return head_activation(c, x)


def head_activation(cfg: DPTConfig, x):
    if cfg.head_act == "sigmoid":
        return torch.sigmoid(x)
    if cfg.head_act == "none":
        return x
    return torch.relu(x)
