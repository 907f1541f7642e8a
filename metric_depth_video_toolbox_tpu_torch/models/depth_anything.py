"""Depth-Anything-class monocular depth (PyTorch port of
``models/depth_anything.py``): ViT + DPT head, used as the VDA engine's
per-frame metric anchor and as the stand-in graph of the single-frame
engines, with their three optional heads: known-camera ray conditioning
(``k_condition``), a FOV head (``fov_head``) and a raw point-map head
(``point_head``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    vit: vit_mod.ViTConfig = vit_mod.VIT_L
    dpt: dpt_mod.DPTConfig = dpt_mod.DPTConfig()
    metric: bool = True
    max_depth: float = 20.0
    # per-patch camera-ray directions, embedded by ``ray_embed`` and added
    # to the patch tokens through the ViT's ``cond``
    k_condition: bool = False
    # a horizontal FOV (25..115 deg) regressed from the cls token
    fov_head: bool = False
    # the DPT head's raw 4-channel map: an affine point map (xyz) and a
    # mask logit (needs dpt n_out=4, head_act="none")
    point_head: bool = False


def preset(name, metric=True, max_depth=20.0):
    dpt_cfg = dpt_mod.DPT_TINY if name == "vitt" else dpt_mod.DPTConfig()
    return DepthAnythingConfig(vit=vit_mod.PRESETS[name], dpt=dpt_cfg,
                               metric=metric, max_depth=max_depth)


class DepthAnything(nn.Module):
    """images (B, H, W, 3) in [0, 1] at ``work_hw`` -> (B, H, W) float32
    depth (metric: sigmoid head x max_depth, or the relu head clipped to
    [0, max_depth]; else the raw relative output); (depth, xfov (B,)) with
    ``fov_head``; (points (B, H, W, 3), mask logit (B, H, W)) with
    ``point_head``. ``rays``: (B, gh, gw, 3) unit rays at the patch
    centers, used with ``k_condition``."""

    def __init__(self, cfg: DepthAnythingConfig, work_hw):
        super().__init__()
        self.cfg = cfg
        p = cfg.vit.patch_size
        d, dt = cfg.vit.embed_dim, cfg.vit.compute_dtype
        n = (work_hw[0] // p) * (work_hw[1] // p)
        if cfg.k_condition:
            self.ray_embed = vit_mod.Dense(3, d, dt)
        self.backbone = vit_mod.ViT(cfg.vit, n)
        self.head = dpt_mod.DPTHead(cfg.dpt, d, p)
        if cfg.fov_head and not cfg.point_head:
            self.fov_fc = vit_mod.Dense(d, 64, dt)
            self.fov_out = vit_mod.Dense(64, 1, torch.float32)

    def forward(self, images, rays=None):
        c = self.cfg
        cond = None
        if c.k_condition and rays is not None:
            cond = self.ray_embed(rays)
        feats, cls = self.backbone(images, cond)
        out = self.head(feats)
        if c.point_head:
            out = out.to(torch.float32)
            return out[..., :3], out[..., 3]
        out = out[..., 0].to(torch.float32)
        if c.metric:
            if c.dpt.head_act == "sigmoid":
                out = out * c.max_depth
            else:
                out = torch.clamp(out, 0.0, c.max_depth)
        if c.fov_head:
            # flax nn.gelu: the tanh form
            h = F.gelu(self.fov_fc(cls), approximate="tanh")
            f = self.fov_out(h)
            return out, 25.0 + 90.0 * torch.sigmoid(f[..., 0])
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


def scale_shift_align_to_metric(relative_disparity, metric_depth,
                                weights=None, min_depth=1e-3):
    """Fit (s, t) so that s * relative_disparity + t ~ 1 / metric_depth
    (weighted least squares on inverse depths) -> (the aligned depth,
    1 / max(s * rel + t, 1e-6); (s, t))."""
    inv_metric = 1.0 / torch.clamp(metric_depth, min=min_depth)
    s, t = solvers.scale_and_shift(relative_disparity, inv_metric, weights)
    inv = relative_disparity * s + t
    return 1.0 / torch.clamp(inv, min=1e-6), (s, t)
