"""MVSAnywhere-class pose-conditioned multi-view-stereo depth (PyTorch port
of ``models/mvs.py``).

For one reference frame and a window of V source views with their relative
poses: matching features at 1/4 resolution, a plane sweep over D hypotheses
uniformly spaced in inverse depth, a group-correlation cost volume averaged
over the valid views, a 2D conv U-Net over the (D * G)-channel cost, a
soft-argmin over inverse depth (the cost-volume depth) and an image-guided
refinement of it (the refined depth).

The JAX package builds the warped source features of all views at once,
(V, D, h, w, C); here the cost volume sums view by view, which holds a
V-th of that: at the production size (1/4-resolution features 256 x 144,
D = 64, C = 32) one view's warp is 0.3 GB in float32.

Names follow the Flax tree (``features.conv1``, ``cost_unet.enc0``,
``refine.head``, ...). Images are channels-last at the public functions;
the convolutions run on (N, C, H, W).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.diffusion import (
    Conv, to_cf, to_cl)
from metric_depth_video_toolbox_tpu_torch.ops import image as im_ops


@dataclasses.dataclass(frozen=True)
class MVSConfig:
    feat_dim: int = 32          # matching-feature channels (at 1/4 res)
    num_depths: int = 64        # plane-sweep hypotheses
    num_groups: int = 4         # group-correlation groups
    min_depth: float = 0.25
    max_depth: float = 100.0
    unet_channels: Sequence[int] = (64, 96, 128)
    refine_channels: int = 32
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


MVS_TINY = MVSConfig(feat_dim=8, num_depths=8, num_groups=2,
                     unet_channels=(8, 12, 16), refine_channels=8)


def preset(size="base", max_depth=100.0):
    if size in ("vitt", "tiny"):
        return dataclasses.replace(MVS_TINY, max_depth=max_depth)
    return dataclasses.replace(MVSConfig(), max_depth=max_depth)


class FeatureNet(nn.Module):
    """The shared conv encoder: (N, 3, H, W) -> (N, feat_dim, H/4, W/4)."""

    def __init__(self, cfg: MVSConfig):
        super().__init__()
        f, dt = cfg.feat_dim, cfg.compute_dtype
        self.conv1 = Conv(3, f, 5, dt, stride=2)
        self.conv2 = Conv(f, 2 * f, 3, dt, stride=2)
        self.conv3 = Conv(2 * f, 2 * f, 3, dt)
        self.proj = Conv(2 * f, f, 1, dt)

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = torch.relu(self.conv3(x))
        return self.proj(x)


def inverse_depth_hypotheses(cfg: MVSConfig, device=None):
    """(D,) float32 hypotheses uniformly spaced in inverse depth."""
    inv = np.linspace(1.0 / cfg.max_depth, 1.0 / cfg.min_depth,
                      cfg.num_depths)
    return torch.tensor(inv, dtype=torch.float32, device=device)


def sweep_coords(k_feat, inv_k_feat, rel_poses, inv_depths, h, w):
    """Source-view pixel coordinates of every (view, hypothesis, pixel).

    k_feat, inv_k_feat: (3, 3) intrinsics at the feature resolution;
    rel_poses: (V, 4, 4) reference camera -> source camera. -> xy (V, D, h,
    w, 2) and the in-front mask (V, D, h, w)."""
    dev = k_feat.device
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)], -1)       # (h, w, 3)
    rays = torch.einsum("ij,hwj->hwi", inv_k_feat, pix)
    pts = rays[None] * (1.0 / inv_depths)[:, None, None, None]  # (D, h, w, 3)
    rot, trn = rel_poses[:, :3, :3], rel_poses[:, :3, 3]
    cam = (torch.einsum("vij,dhwj->vdhwi", rot, pts)
           + trn[:, None, None, None, :])
    z = cam[..., 2]
    in_front = z > 1e-4
    zs = torch.where(in_front, z, torch.ones_like(z))
    proj = torch.einsum("ij,vdhwj->vdhwi", k_feat, cam / zs[..., None])
    return proj[..., :2] - 0.5, in_front


def build_cost_volume(ref_feat, src_feats, xy, in_front, view_valid,
                      num_groups):
    """Group-correlation cost volume, summed view by view.

    ref_feat: (h, w, C); src_feats: (V, h, w, C); xy: (V, D, h, w, 2);
    view_valid: (V,) 0 / 1. -> (h, w, D * G) float32."""
    v, d, h, w, _ = xy.shape
    c = ref_feat.shape[-1]
    g = num_groups
    rf = ref_feat.to(torch.float32).reshape(h, w, g, c // g)
    wgt = view_valid.to(torch.float32)
    corr = torch.zeros((d, h, w, g), dtype=torch.float32, device=xy.device)
    for i in range(v):
        warped = im_ops.bilinear_sample(src_feats[i].to(torch.float32),
                                        xy[i], fill=0.0)   # (D, h, w, C)
        warped = torch.where(in_front[i][..., None], warped,
                             torch.zeros_like(warped))
        ci = torch.einsum("hwgk,dhwgk->dhwg", rf,
                          warped.reshape(d, h, w, g, c // g)) / (c // g)
        corr = corr + ci * wgt[i]
    corr = corr / torch.clamp(wgt.sum(), min=1.0)
    return corr.permute(1, 2, 0, 3).reshape(h, w, d * g)


class CostUNet(nn.Module):
    """2D conv U-Net over the (N, D * G + C, h, w) cost and features ->
    (N, D, h, w) float32 logits."""

    def __init__(self, cfg: MVSConfig):
        super().__init__()
        dt, uc = cfg.compute_dtype, tuple(cfg.unet_channels)
        cin = cfg.num_depths * cfg.num_groups + cfg.feat_dim
        for i, ch in enumerate(uc):
            setattr(self, f"enc{i}", Conv(cin, ch, 3, dt))
            if i < len(uc) - 1:
                setattr(self, f"down{i}", Conv(ch, ch, 3, dt, stride=2))
            cin = ch
        for i in range(len(uc) - 1):
            ch = uc[len(uc) - 2 - i]
            setattr(self, f"dec{i}", Conv(cin + ch, ch, 3, dt))
            cin = ch
        self.head = Conv(cin, cfg.num_depths, 3, torch.float32)
        self.n_levels = len(uc)
        self.compute_dtype = dt

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        skips = []
        for i in range(self.n_levels):
            x = torch.relu(getattr(self, f"enc{i}")(x))
            if i < self.n_levels - 1:
                skips.append(x)
                x = torch.relu(getattr(self, f"down{i}")(x))
        for i, skip in enumerate(reversed(skips)):
            x = im_ops.resize_nchw(x, skip.shape[-2:]).to(dt)
            x = torch.relu(getattr(self, f"dec{i}")(
                torch.cat([x, skip], dim=1)))
        return self.head(x)


class RefineNet(nn.Module):
    """Image-guided residual of the normalized cost-volume inverse depth:
    (N, C + 2, h, w) -> (N, h, w)."""

    def __init__(self, cfg: MVSConfig):
        super().__init__()
        dt, r = cfg.compute_dtype, cfg.refine_channels
        self.conv1 = Conv(cfg.feat_dim + 2, r, 3, dt)
        self.conv2 = Conv(r, r, 3, dt)
        self.head = Conv(r, 1, 3, torch.float32)

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        return self.head(x)[:, 0]


class MVSNet(nn.Module):
    """Per-frame MVS over a batch of reference frames: features -> sweep ->
    cost U-Net -> soft-argmin -> refinement."""

    def __init__(self, cfg: MVSConfig):
        super().__init__()
        self.cfg = cfg
        self.features = FeatureNet(cfg)
        self.cost_unet = CostUNet(cfg)
        self.refine = RefineNet(cfg)

    def forward(self, ref_imgs, src_imgs, k_feat, rel_poses, view_valid):
        """ref_imgs (B, H, W, 3) in [0, 1]; src_imgs (B, V, H, W, 3);
        k_feat (3, 3) intrinsics at 1/4 resolution; rel_poses (B, V, 4, 4)
        reference camera -> source camera; view_valid (B, V). -> dict of
        (B, H, W): depth (refined), depth_cv, confidence, mask (bool)."""
        c = self.cfg
        b, v = src_imgs.shape[:2]
        out_hw = tuple(ref_imgs.shape[1:3])
        ref_feat = to_cl(self.features(to_cf(ref_imgs)))      # (B, h, w, C)
        src_feat = to_cl(self.features(to_cf(src_imgs.reshape(
            (b * v,) + tuple(src_imgs.shape[2:])))))
        h, w = ref_feat.shape[1:3]
        src_feat = src_feat.reshape(b, v, h, w, -1)
        inv_depths = inverse_depth_hypotheses(c, ref_imgs.device)
        k_feat = k_feat.to(torch.float32)
        inv_k = torch.linalg.inv(k_feat)
        cost = torch.stack([build_cost_volume(
            ref_feat[i], src_feat[i], *sweep_coords(
                k_feat, inv_k, rel_poses[i].to(torch.float32), inv_depths,
                h, w), view_valid[i], c.num_groups) for i in range(b)])
        logits = self.cost_unet(torch.cat(
            [to_cf(cost).to(c.compute_dtype),
             to_cf(ref_feat).to(c.compute_dtype)], dim=1))
        prob = torch.softmax(logits, dim=1)                    # (B, D, h, w)
        inv_cv = torch.einsum("bdhw,d->bhw", prob, inv_depths)
        confidence = prob.amax(dim=1)
        inv_range = inv_depths[-1] - inv_depths[0]
        inv_norm = (inv_cv - inv_depths[0]) / inv_range
        dt = c.compute_dtype
        res = self.refine(torch.cat([to_cf(ref_feat).to(dt),
                                     inv_norm[:, None].to(dt),
                                     confidence[:, None].to(dt)], dim=1))
        inv_ref = (torch.clamp(inv_norm + res, 0.0, 1.0) * inv_range
                   + inv_depths[0])
        depth_cv = 1.0 / torch.clamp(inv_cv, min=1.0 / c.max_depth)
        depth_ref = 1.0 / torch.clamp(inv_ref, min=1.0 / c.max_depth)

        def up(x):
            return im_ops.resize_nchw(x[:, None], out_hw)[:, 0]
        return {"depth": up(depth_ref), "depth_cv": up(depth_cv),
                "confidence": up(confidence),
                "mask": up((confidence > 1.5 / c.num_depths)
                           .to(torch.float32)) > 0.5}


def infer_batch(model, ref_imgs, src_imgs, k_feat, rel_poses, view_valid):
    """:class:`MVSNet` on uint8 frames: ref_imgs (B, H, W, 3), src_imgs (B,
    V, H, W, 3), rel_poses (B, V, 4, 4), view_valid (B, V)."""
    return model(ref_imgs.to(torch.float32) / 255.0,
                 src_imgs.to(torch.float32) / 255.0, k_feat, rel_poses,
                 view_valid)
