"""UniDepth-V2 and UniK3D class models (PyTorch port of
``models/unidepth.py``).

Both run a DINOv2 ViT backbone and a ray-conditioned token decoder:

- UniDepthNet: an attention-pooled pinhole camera head (learned queries
  cross-attend to the last level's tokens; an MLP gives [log fx, log fy,
  atanh cx', atanh cy'] in normalized units), its rays (or the caller's
  given-camera rays) embedded with real spherical harmonics and added to
  the summed level projections, transformer blocks, an upsampling pixel
  head; log-depth and a confidence out.
- UniK3DNet: a dense angular field (its own token decoder, per-patch ray
  directions) conditions the radial decoder; points = rays x exp(log
  radius), the engine's point-head contract.

The decoder blocks are the ViT's blocks at the decoder's width, with
``F.scaled_dot_product_attention`` (the JAX package forces XLA attention
there). NHWC at the public functions; module names follow the Flax tree
(``models.convert.convert_unidepth`` / ``convert_unik3d``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.models.dpt import ConvTranspose
from metric_depth_video_toolbox_tpu_torch.models.vit import Conv, Dense
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw


@dataclasses.dataclass(frozen=True)
class UniDepthConfig:
    vit: vit_mod.ViTConfig = vit_mod.VIT_L
    dim: int = 512
    num_heads: int = 8
    num_blocks: int = 4
    num_angular_blocks: int = 2
    num_cam_queries: int = 4
    camera_hidden: int = 256
    sh_degree: int = 8          # upstream rsh_cart_8 -> 81 features
    dim_upsample: Sequence[int] = (256, 128)
    last_conv_channels: int = 32

    @property
    def block_cfg(self):
        """The decoder blocks: the ViT's, at the decoder's width, with
        SDPA attention."""
        return dataclasses.replace(
            self.vit, embed_dim=self.dim, num_heads=self.num_heads,
            attention_impl="xla")


UNIDEPTH_L = UniDepthConfig()
UNIDEPTH_TINY = UniDepthConfig(
    vit=vit_mod.VIT_TINY, dim=32, num_heads=4, num_blocks=2,
    num_angular_blocks=1, num_cam_queries=2, camera_hidden=16,
    sh_degree=2, dim_upsample=(12, 8), last_conv_channels=8)


def rsh_cart(xyz, degree):
    """Real spherical harmonics of unit vectors (..., 3) -> (...,
    (degree + 1)^2) float32, ordered (l, m), m = -l..l, with the
    Condon-Shortley phase (upstream ``rsh_cart_8``'s convention). By
    recurrence: the associated Legendre functions over sin^m, polynomial
    in z, times Re / Im of (x + i y)^m."""
    xyz = xyz.to(torch.float32)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    one = torch.ones_like(z)
    inv4pi = 1.0 / (4.0 * math.pi)
    legendre = {(0, 0): one}
    for m in range(0, degree + 1):
        if m > 0:
            legendre[(m, m)] = legendre[(m - 1, m - 1)] * (-(2.0 * m - 1.0))
        if m + 1 <= degree:
            legendre[(m + 1, m)] = z * (2.0 * m + 1.0) * legendre[(m, m)]
        for l in range(m + 2, degree + 1):
            legendre[(l, m)] = ((2.0 * l - 1.0) * z * legendre[(l - 1, m)]
                                - (l - 1.0 + m) * legendre[(l - 2, m)]
                                ) / (l - m)
    cos_m = {0: one}
    sin_m = {0: torch.zeros_like(z)}
    for m in range(1, degree + 1):
        cos_m[m] = cos_m[m - 1] * x - sin_m[m - 1] * y
        sin_m[m] = sin_m[m - 1] * x + cos_m[m - 1] * y
    feats = []
    for l in range(degree + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            n = math.sqrt((2.0 * l + 1.0) * inv4pi * math.factorial(l - am)
                          / math.factorial(l + am))
            if m != 0:
                n *= math.sqrt(2.0)
            base = legendre[(l, am)] * n
            feats.append(base * (sin_m[am] if m < 0 else cos_m[am]))
    return torch.stack(feats, dim=-1)


def patch_uv(gh, gw, device=None):
    """(gh, gw, 2) float32 patch-center coordinates, the longer side
    spanning [-1, 1]."""
    span = float(max(gh, gw))
    u = (2.0 * (torch.arange(gw, dtype=torch.float32, device=device) + 0.5)
         - gw) / span
    v = (2.0 * (torch.arange(gh, dtype=torch.float32, device=device) + 0.5)
         - gh) / span
    return torch.stack([u[None, :].expand(gh, gw),
                        v[:, None].expand(gh, gw)], dim=-1)


def rays_from_pinhole(cam4, gh, gw):
    """(B, 4) normalized pinhole [fx, fy, cx, cy] -> (B, gh, gw, 3) unit
    rays at the patch centers."""
    uv = patch_uv(gh, gw, cam4.device)[None]
    fx, fy, cx, cy = (cam4[:, i][:, None, None] for i in range(4))
    dx = (uv[..., 0] - cx) / fx
    dy = (uv[..., 1] - cy) / fy
    d = torch.stack([dx, dy, torch.ones_like(dx)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _resize_nhwc(x, hw):
    return resize_nchw(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


class CameraHead(nn.Module):
    """Attention-pooled pinhole head: (B, N, D) last-level tokens -> (B, 4)
    [fx, fy, cx, cy] (fx, fy = exp of a clipped log; cx, cy in the
    central half)."""

    def __init__(self, cfg: UniDepthConfig):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.dim, cfg.vit.compute_dtype
        self.in_proj = Dense(cfg.vit.embed_dim, d, dt)
        self.queries = nn.Parameter(torch.zeros(cfg.num_cam_queries, d))
        self.q_proj = Dense(d, d, dt)
        self.k_proj = Dense(d, d, dt)
        self.v_proj = Dense(d, d, dt)
        self.out_proj = Dense(d, d, dt)
        self.mlp1 = Dense(cfg.num_cam_queries * d, cfg.camera_hidden, dt)
        self.mlp2 = Dense(cfg.camera_hidden, 4, torch.float32)

    def forward(self, tokens):
        c = self.cfg
        dt = c.vit.compute_dtype
        b = tokens.shape[0]
        x = self.in_proj(tokens)
        q = self.q_proj(self.queries.to(dt).expand(b, -1, -1))
        k = self.k_proj(x)
        v = self.v_proj(x)
        a = torch.softmax((q @ k.transpose(1, 2)).to(torch.float32)
                          / math.sqrt(c.dim), dim=-1)
        h = self.out_proj(a.to(dt) @ v)
        h = self.mlp1(h.reshape(b, c.num_cam_queries * c.dim))
        p = self.mlp2(F.gelu(h))
        f = torch.exp(torch.clamp(p[:, :2], -3.0, 3.0))
        return torch.cat([f, torch.tanh(p[:, 2:]) * 0.5], dim=-1)


class TokenDecoder(nn.Module):
    """Summed level projections (+ the SH embedding of ``rays``) ->
    transformer blocks over the patch tokens -> (B, gh, gw, dim) float32."""

    def __init__(self, cfg: UniDepthConfig, num_blocks, with_rays):
        super().__init__()
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.with_rays = with_rays
        d, dt = cfg.dim, cfg.vit.compute_dtype
        for i in range(4):
            self.add_module(f"project{i}", Dense(cfg.vit.embed_dim, d, dt))
        if with_rays:
            self.ray_mlp1 = Dense((cfg.sh_degree + 1) ** 2, d, dt)
            self.ray_mlp2 = Dense(d, d, dt)
        for i in range(num_blocks):
            self.add_module(f"block{i}", vit_mod.Block(cfg.block_cfg))

    def forward(self, feats, rays=None):
        c = self.cfg
        b, gh, gw, _ = feats[0].shape
        x = sum(getattr(self, f"project{i}")(f) for i, f in enumerate(feats))
        if self.with_rays:
            r = self.ray_mlp1(rsh_cart(rays, c.sh_degree))
            x = x + self.ray_mlp2(F.gelu(r))
        x = x.reshape(b, gh * gw, c.dim)
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x.reshape(b, gh, gw, c.dim).to(torch.float32)


class PixelHead(nn.Module):
    """x2-upsampling conv stack -> (B, gh 2^n, gw 2^n, n_out) float32."""

    def __init__(self, cfg: UniDepthConfig, n_out=2):
        super().__init__()
        self.cfg = cfg
        dt = cfg.vit.compute_dtype
        ch_in = cfg.dim
        for i, ch in enumerate(cfg.dim_upsample):
            self.add_module(f"upsample{i}",
                            ConvTranspose(ch_in, 2, dt, out_ch=ch))
            self.add_module(f"upconv{i}", Conv(ch, ch, 3, dt))
            ch_in = ch
        self.out_conv1 = Conv(ch_in, cfg.last_conv_channels, 3, dt)
        self.out_conv2 = Conv(cfg.last_conv_channels, n_out, 1,
                              torch.float32)

    def forward(self, x):
        for i in range(len(self.cfg.dim_upsample)):
            x = getattr(self, f"upsample{i}")(x)
            x = F.gelu(getattr(self, f"upconv{i}")(x))
        return self.out_conv2(torch.relu(self.out_conv1(x)))


class DepthModule(nn.Module):
    def __init__(self, cfg: UniDepthConfig):
        super().__init__()
        self.tokens = TokenDecoder(cfg, cfg.num_blocks, True)
        self.pixel = PixelHead(cfg, 2)

    def forward(self, feats, rays):
        return self.pixel(self.tokens(feats, rays))


def _grid(cfg, work_hw):
    p = cfg.vit.patch_size
    return work_hw[0] // p, work_hw[1] // p


class UniDepthNet(nn.Module):
    """(B, H, W, 3) in [0, 1] at ``work_hw`` -> (metric depth (B, H, W),
    confidence (B, H, W), cam4 (B, 4)). ``rays``: optional (B, gh, gw, 3)
    given-camera rays, which condition the depth module in place of the
    camera head's (whose prediction is still returned)."""

    def __init__(self, cfg: UniDepthConfig, work_hw):
        super().__init__()
        self.cfg = cfg
        gh, gw = _grid(cfg, work_hw)
        self.backbone = vit_mod.ViT(cfg.vit, gh * gw)
        self.camera = CameraHead(cfg)
        self.depth = DepthModule(cfg)

    def forward(self, images, rays=None):
        c = self.cfg
        b, h, w, _ = images.shape
        gh, gw = h // c.vit.patch_size, w // c.vit.patch_size
        feats, _ = self.backbone(images)
        cam4 = self.camera(feats[-1].reshape(b, gh * gw, c.vit.embed_dim))
        use = rays if rays is not None else rays_from_pinhole(cam4, gh, gw)
        out = _resize_nhwc(self.depth(feats, use), (h, w))
        depth = torch.exp(torch.clamp(out[..., 0], -8.0, 8.0))
        return depth, out[..., 1], cam4


class UniK3DNet(nn.Module):
    """(B, H, W, 3) in [0, 1] at ``work_hw`` -> (metric points (B, H, W,
    3), confidence logit (B, H, W)): a dense angular field times a radial
    distance."""

    def __init__(self, cfg: UniDepthConfig, work_hw):
        super().__init__()
        self.cfg = cfg
        gh, gw = _grid(cfg, work_hw)
        self.backbone = vit_mod.ViT(cfg.vit, gh * gw)
        self.angular = TokenDecoder(cfg, cfg.num_angular_blocks, False)
        self.angular_out = Dense(cfg.dim, 3, torch.float32)
        self.radius_tokens = TokenDecoder(cfg, cfg.num_blocks, True)
        self.radius_pixel = PixelHead(cfg, 2)

    def forward(self, images):
        b, h, w, _ = images.shape
        feats, _ = self.backbone(images)
        dirs = self.angular_out(self.angular(feats))
        patch_rays = dirs / torch.linalg.vector_norm(dirs, dim=-1,
                                                     keepdim=True)
        out = self.radius_pixel(self.radius_tokens(feats, patch_rays))
        out = _resize_nhwc(out, (h, w))
        radius = torch.exp(torch.clamp(out[..., 0], -8.0, 8.0))
        rays = _resize_nhwc(patch_rays, (h, w))
        rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
        return rays * radius[..., None], out[..., 1]
