"""MoGe point-map model (PyTorch port of ``models/moge.py``).

A DINOv2 ViT backbone feeding a convolutional point-map head: the four
tapped token levels are projected (1x1) and summed, then upsampled x2 per
stage by a ConvTranspose over the feature map with a normalized-UV
coordinate map concatenated, a 3x3 conv and residual conv blocks
(GroupNorm-ReLU-Conv twice, plus the skip); the output block is a 3x3 conv
over the map + UV, ReLU, a 1x1 conv to 4 channels (affine xyz and a mask
logit), resized bilinearly to the working resolution. The focal and
z-shift solve on top is ``ops.geometry.recover_focal_shift``, shared with
the stand-in engine. NHWC at the public functions; module names follow
the Flax tree (``converted by models.convert.convert_moge``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.models.diffusion import GroupNorm
from metric_depth_video_toolbox_tpu_torch.models.dpt import ConvTranspose
from metric_depth_video_toolbox_tpu_torch.models.vit import Conv
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw


@dataclasses.dataclass(frozen=True)
class MoGeConfig:
    vit: vit_mod.ViTConfig = vit_mod.VIT_L
    dim_proj: int = 512
    dim_upsample: Sequence[int] = (256, 128, 64)
    num_res_blocks: int = 2
    norm_groups: int = 16
    last_conv_channels: int = 32
    n_out: int = 4  # xyz + mask logit


MOGE_L = MoGeConfig()
MOGE_TINY = MoGeConfig(
    vit=vit_mod.VIT_TINY, dim_proj=16, dim_upsample=(12, 8),
    num_res_blocks=1, norm_groups=4, last_conv_channels=8)


def _uv_map(h, w, dtype, device=None):
    """(h, w, 2) normalized pixel-center coordinates, the longer side
    spanning [-1, 1]."""
    span = max(h, w)
    u = (2.0 * (torch.arange(w, dtype=torch.float32, device=device) + 0.5)
         - w) / span
    v = (2.0 * (torch.arange(h, dtype=torch.float32, device=device) + 0.5)
         - h) / span
    return torch.stack([u[None, :].expand(h, w), v[:, None].expand(h, w)],
                       dim=-1).to(dtype)


def _cat_uv(x):
    b, h, w, _ = x.shape
    uv = _uv_map(h, w, x.dtype, x.device)[None].expand(b, h, w, 2)
    return torch.cat([x, uv], dim=-1)


def _gn(norm, x):
    """Float32 GroupNorm of an NHWC map (flax ``nn.GroupNorm``)."""
    return norm(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ResidualConvBlock(nn.Module):
    def __init__(self, ch, groups, dtype):
        super().__init__()
        self.norm1 = GroupNorm(groups, ch, eps=1e-5)
        self.conv1 = Conv(ch, ch, 3, dtype)
        self.norm2 = GroupNorm(groups, ch, eps=1e-5)
        self.conv2 = Conv(ch, ch, 3, dtype)

    def forward(self, x):
        y = self.conv1(torch.relu(_gn(self.norm1, x)))
        y = self.conv2(torch.relu(_gn(self.norm2, y)))
        return x + y


class MoGeHead(nn.Module):
    """4 token grids (B, gh, gw, D) -> (B, gh 2^n, gw 2^n, n_out)."""

    def __init__(self, cfg: MoGeConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.vit.compute_dtype
        for i in range(4):
            self.add_module(f"project{i}",
                            Conv(cfg.vit.embed_dim, cfg.dim_proj, 1, dt))
        ch_in = cfg.dim_proj
        for i, ch in enumerate(cfg.dim_upsample):
            self.add_module(f"upsample{i}",
                            ConvTranspose(ch_in + 2, 2, dt, out_ch=ch))
            self.add_module(f"upconv{i}", Conv(ch, ch, 3, dt))
            for j in range(cfg.num_res_blocks):
                self.add_module(f"res{i}_{j}",
                                ResidualConvBlock(ch, cfg.norm_groups, dt))
            ch_in = ch
        self.out_conv1 = Conv(ch_in + 2, cfg.last_conv_channels, 3, dt)
        self.out_conv2 = Conv(cfg.last_conv_channels, cfg.n_out, 1,
                              torch.float32)

    def forward(self, feats):
        c = self.cfg
        x = sum(getattr(self, f"project{i}")(f) for i, f in enumerate(feats))
        for i in range(len(c.dim_upsample)):
            y = getattr(self, f"upsample{i}")(_cat_uv(x))
            y = getattr(self, f"upconv{i}")(y)
            for j in range(c.num_res_blocks):
                y = getattr(self, f"res{i}_{j}")(y)
            x = y
        x = torch.relu(self.out_conv1(_cat_uv(x)))
        return self.out_conv2(x)


class MoGeNet(nn.Module):
    """(B, H, W, 3) in [0, 1] at ``work_hw`` -> (points (B, H, W, 3),
    mask logit (B, H, W)), float32: the engine's point-head contract."""

    def __init__(self, cfg: MoGeConfig, work_hw):
        super().__init__()
        self.cfg = cfg
        p = cfg.vit.patch_size
        self.backbone = vit_mod.ViT(cfg.vit,
                                    (work_hw[0] // p) * (work_hw[1] // p))
        self.head = MoGeHead(cfg)

    def forward(self, images):
        b, h, w, _ = images.shape
        feats, _ = self.backbone(images)
        out = self.head(feats).to(torch.float32)
        out = resize_nchw(out.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
        return out[..., :3], out[..., 3]
