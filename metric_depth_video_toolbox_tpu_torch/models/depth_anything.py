"""Depth-Anything-class monocular depth (PyTorch port of
``models/depth_anything.py``): ViT + DPT head, used as the VDA engine's
per-frame metric anchor."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    vit: vit_mod.ViTConfig = vit_mod.VIT_L
    dpt: dpt_mod.DPTConfig = dpt_mod.DPTConfig()
    metric: bool = True
    max_depth: float = 20.0


def preset(name, metric=True, max_depth=20.0):
    dpt_cfg = dpt_mod.DPT_TINY if name == "vitt" else dpt_mod.DPTConfig()
    return DepthAnythingConfig(vit=vit_mod.PRESETS[name], dpt=dpt_cfg,
                               metric=metric, max_depth=max_depth)


class DepthAnything(nn.Module):
    """images (B, H, W, 3) in [0, 1] at ``work_hw`` -> (B, H, W) float32
    depth (metric: sigmoid head x max_depth, or the relu head clipped to
    [0, max_depth]; else the raw relative output)."""

    def __init__(self, cfg: DepthAnythingConfig, work_hw):
        super().__init__()
        self.cfg = cfg
        p = cfg.vit.patch_size
        n = (work_hw[0] // p) * (work_hw[1] // p)
        self.backbone = vit_mod.ViT(cfg.vit, n)
        self.head = dpt_mod.DPTHead(cfg.dpt, cfg.vit.embed_dim, p)

    def forward(self, images):
        c = self.cfg
        feats, _ = self.backbone(images)
        out = self.head(feats)[..., 0].to(torch.float32)
        if c.metric:
            if c.dpt.head_act == "sigmoid":
                out = out * c.max_depth
            else:
                out = torch.clamp(out, 0.0, c.max_depth)
        return out


def patch_center_rays(xfov_deg, gh, gw, yfov_deg=None):
    """Unit camera-ray directions at patch centers for known-intrinsics
    conditioning: (gh, gw, 3) float32 numpy."""
    xf = np.tan(np.radians(xfov_deg) / 2.0)
    yf = np.tan(np.radians(yfov_deg) / 2.0) if yfov_deg else xf * gh / gw
    u = (np.arange(gw) + 0.5) / gw * 2.0 - 1.0
    v = (np.arange(gh) + 0.5) / gh * 2.0 - 1.0
    xx, yy = np.meshgrid(u * xf, v * yf)
    rays = np.stack([xx, yy, np.ones_like(xx)], axis=-1)
    return (rays / np.linalg.norm(rays, axis=-1, keepdims=True)
            ).astype(np.float32)


def working_resolution(h, w, input_size, patch):
    """Aspect-preserving working resolution snapped to patch multiples."""
    scale = input_size / min(h, w)
    nh = max(patch, int(round(h * scale / patch)) * patch)
    nw = max(patch, int(round(w * scale / patch)) * patch)
    return nh, nw


@torch.no_grad()
def infer_depth(model, images_u8, out_hw, work_hw):
    """uint8 (B, H, W, 3) -> float32 depth (B, out_h, out_w): resize to the
    working resolution, run the model, resize back."""
    x = images_u8.to(torch.float32).permute(0, 3, 1, 2) / 255.0
    x = resize_nchw(x, work_hw).permute(0, 2, 3, 1)
    d = model(x)
    return resize_nchw(d[:, None], out_hw)[:, 0]
