"""RAFT recurrent optical flow, torchvision ``raft_large`` layout (PyTorch
port of ``models/raft.py``).

Residual feature (InstanceNorm) and context (BatchNorm) encoders at 1/8
resolution, a 4-level all-pairs correlation pyramid with radius-4
lookups, the separable (1x5)+(5x1) conv-GRU update block and the convex
upsampling mask head. Modules are named after the Flax tree
(``fnet.stem.conv``, ``cnet.layer1_0.convnormrelu1.norm``, ``motion
.convcorr1.conv``, ``gru1.convz``, ``flow_head1``, ``mask_conv2``), so a
Flax ``init`` or a torchvision checkpoint converted by
``convert.convert_raft`` loads with ``models.from_jax``.

Dtypes follow the Flax model: the encoders, the motion encoder, the GRU
gates, ``flow_head1`` and ``mask_conv1`` compute in the config's dtype
(bfloat16 for RAFT_LARGE; the batch norms and instance norms take their
statistics in float32), the features, the correlation volume, its lookups,
the hidden state, ``flow_head2``, ``mask_conv2`` and the upsampling in
float32. The correlation volume is one batched float32 matmul, divided by
sqrt(C) in place: at 1080p (a 135 x 240 grid) one pair's level 0 holds
32,400^2 floats, 4.2 GB.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.norm import (
    EvalBatchNorm, InstanceNorm)


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    # encoder widths, torchvision raft_large: stem 64, layers (64, 96,
    # 128), final projection 256 (feature) / hidden+context (context)
    stem: int = 64
    layers: tuple = (64, 96, 128)
    feat_dim: int = 256
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    # motion encoder widths (torchvision MotionEncoder)
    motion_corr: tuple = (256, 192)
    motion_flow: tuple = (128, 64)
    motion_out: int = 128  # includes the 2 appended raw-flow channels
    flow_head_hidden: int = 256
    iters: int = 12
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


RAFT_LARGE = RAFTConfig()
RAFT_TINY = RAFTConfig(stem=8, layers=(8, 12, 16), feat_dim=32,
                       hidden_dim=16, context_dim=16, corr_levels=2,
                       corr_radius=2, motion_corr=(32, 24),
                       motion_flow=(16, 8), motion_out=16,
                       flow_head_hidden=32, iters=4, dtype="float32")


class Conv(nn.Conv2d):
    """A 2D convolution computed in ``dtype`` (input, weight and bias
    cast, as Flax ``nn.Conv(dtype=...)``); parameters stay float32.
    Padding k // 2 on each side."""

    def __init__(self, cin, cout, k, stride=1, bias=True,
                 dtype=torch.float32):
        k = (k, k) if isinstance(k, int) else tuple(k)
        super().__init__(cin, cout, k, stride, (k[0] // 2, k[1] // 2),
                         bias=bias)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding)


def _norm(kind, dim):
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return EvalBatchNorm(dim)
    return None


class ConvNormRelu(nn.Module):
    """torchvision Conv2dNormActivation: conv (bias only without a norm)
    -> norm -> relu."""

    def __init__(self, cin, out, k, norm, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, out, k, stride, bias=norm == "none",
                         dtype=dtype)
        norm = _norm(norm, out)
        if norm is not None:
            self.norm = norm

    def forward(self, x):
        x = self.conv(x)
        if hasattr(self, "norm"):
            x = self.norm(x)
        return F.relu(x)


class ResidualBlock(nn.Module):
    """torchvision RAFT ResidualBlock: two conv-norm-relu, a 1x1 (+ norm)
    skip when strided or widened, relu after the sum."""

    def __init__(self, cin, out, norm, stride=1, dtype=torch.float32):
        super().__init__()
        self.convnormrelu1 = ConvNormRelu(cin, out, 3, norm, stride, dtype)
        self.convnormrelu2 = ConvNormRelu(out, out, 3, norm, 1, dtype)
        if stride != 1 or cin != out:
            self.down_conv = Conv(cin, out, 1, stride, bias=False,
                                  dtype=dtype)
            norm = _norm(norm, out)
            if norm is not None:
                self.down_norm = norm

    def forward(self, x):
        y = self.convnormrelu2(self.convnormrelu1(x))
        if hasattr(self, "down_conv"):
            x = self.down_conv(x)
            if hasattr(self, "down_norm"):
                x = self.down_norm(x)
        return F.relu(x + y)


class RAFTEncoder(nn.Module):
    """7x7/2 stem, three 2-block layers (s1, s2, s2: 1/8 resolution), a
    1x1 projection. (B, 3, H, W) -> (B, out_dim, H/8, W/8)."""

    def __init__(self, cfg, out_dim, norm, dtype=torch.float32):
        super().__init__()
        self.stem = ConvNormRelu(3, cfg.stem, 7, norm, 2, dtype)
        cin = cfg.stem
        for li, (width, stride) in enumerate(zip(cfg.layers, (1, 2, 2))):
            self.add_module(f"layer{li + 1}_0",
                            ResidualBlock(cin, width, norm, stride, dtype))
            self.add_module(f"layer{li + 1}_1",
                            ResidualBlock(width, width, norm, 1, dtype))
            cin = width
        self.proj = Conv(cin, out_dim, 1, dtype=dtype)

    def forward(self, x):
        x = self.stem(x)
        for li in range(3):
            x = getattr(self, f"layer{li + 1}_0")(x)
            x = getattr(self, f"layer{li + 1}_1")(x)
        return self.proj(x)


def _avg_pool2(x):
    """(N, h, w) -> (N, h // 2, w // 2) means of 2x2 blocks (an odd last
    row or column dropped; a level of 0 rows or columns below a 1-wide
    one, as the reshape-mean of the JAX package gives)."""
    n, h, w = x.shape
    if h < 2 or w < 2:
        return x.new_zeros((n, h // 2, w // 2))
    return F.avg_pool2d(x[:, None], 2)[:, 0]


def _grid_sample_zeros(img, xs, ys):
    """Bilinear samples of img (N, h, w) at float pixel coordinates xs, ys
    (N, K), each row sampling its own image; taps outside contribute 0
    (grid_sample with align_corners=True and zero padding)."""
    n, h, w = img.shape
    if h == 0 or w == 0:             # every tap outside an empty level
        return xs.new_zeros(xs.shape)
    flat = img.reshape(n, h * w)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = xs - x0
    wy = ys - y0

    def tap(yi, xi, wgt):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).to(torch.int64)
        return torch.gather(flat, 1, idx) * wgt * ok.to(img.dtype)

    return (tap(y0, x0, (1 - wy) * (1 - wx))
            + tap(y0, x0 + 1, (1 - wy) * wx)
            + tap(y0 + 1, x0, wy * (1 - wx))
            + tap(y0 + 1, x0 + 1, wy * wx))


def _corr_pyramid(f1, f2, levels):
    """All-pairs correlation of (B, H, W, C) float32 features: the product,
    then the division by sqrt(C) in place -> [(B*H*W, h_l, w_l)]."""
    b, h, w, c = f1.shape
    corr = torch.bmm(f1.reshape(b, h * w, c), f2.reshape(b, h * w, c)
                     .transpose(1, 2))
    corr.div_(math.sqrt(c))
    pyr = [corr.reshape(b * h * w, h, w)]
    for _ in range(levels - 1):
        pyr.append(_avg_pool2(pyr[-1]))
    return pyr


def _lookup(pyr, coords, radius):
    """Correlation features around ``coords`` (B, H, W, 2 as x, y) ->
    (B, H, W, levels * (2r+1)^2); the x offset outer, the y offset inner
    (torchvision's neighbour order)."""
    b, h, w = coords.shape[:3]
    n = b * h * w
    r = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=coords.device)
    k = r.shape[0]
    dx = r.repeat_interleave(k)
    dy = r.repeat(k)
    cx = coords[..., 0].reshape(n, 1)
    cy = coords[..., 1].reshape(n, 1)
    outs = [_grid_sample_zeros(corr, cx / 2.0 ** lvl + dx,
                               cy / 2.0 ** lvl + dy)
            for lvl, corr in enumerate(pyr)]
    return torch.cat(outs, -1).reshape(b, h, w, -1)


class ConvGRU(nn.Module):
    def __init__(self, hidden, cin, kernel, dtype):
        super().__init__()
        self.convz = Conv(hidden + cin, hidden, kernel, dtype=dtype)
        self.convr = Conv(hidden + cin, hidden, kernel, dtype=dtype)
        self.convq = Conv(hidden + cin, hidden, kernel, dtype=dtype)

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1 - z) * h + z * q


class MotionEncoder(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        c = cfg
        cor = c.corr_levels * (2 * c.corr_radius + 1) ** 2
        self.convcorr1 = ConvNormRelu(cor, c.motion_corr[0], 1, "none",
                                      dtype=dtype)
        self.convcorr2 = ConvNormRelu(c.motion_corr[0], c.motion_corr[1], 3,
                                      "none", dtype=dtype)
        self.convflow1 = ConvNormRelu(2, c.motion_flow[0], 7, "none",
                                      dtype=dtype)
        self.convflow2 = ConvNormRelu(c.motion_flow[0], c.motion_flow[1], 3,
                                      "none", dtype=dtype)
        self.conv = ConvNormRelu(c.motion_corr[1] + c.motion_flow[1],
                                 c.motion_out - 2, 3, "none", dtype=dtype)

    def forward(self, flow, corr_features):
        cr = self.convcorr2(self.convcorr1(corr_features))
        fl = self.convflow2(self.convflow1(flow))
        cf = self.conv(torch.cat([cr, fl], 1))
        return torch.cat([cf, flow.to(cf.dtype)], 1)


def _convex_upsample(flow, mask, factor=8):
    """Convex-combination upsampling of flow (B, H, W, 2) with mask (B, H,
    W, 9*f*f), softmaxed over its 9 taps of the zero-padded 3x3
    neighbourhood of f * flow (rows outer, columns inner) -> (B, H*f, W*f,
    2)."""
    b, h, w, _ = flow.shape
    pad = F.pad(flow * factor, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([pad[:, dy:dy + h, dx:dx + w] for dy in range(3)
                        for dx in range(3)], 3)              # (B,H,W,9,2)
    m = torch.softmax(mask.reshape(b, h, w, 9, factor, factor), 3)
    up = torch.einsum("bhwkyx,bhwkc->bhwyxc", m, taps)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, h * factor, w * factor,
                                                2)


class RAFT(nn.Module):
    def __init__(self, cfg=RAFT_LARGE):
        super().__init__()
        c = self.cfg = cfg
        dt = c.compute_dtype
        self.fnet = RAFTEncoder(c, c.feat_dim, "instance", dt)
        self.cnet = RAFTEncoder(c, c.hidden_dim + c.context_dim, "batch", dt)
        self.motion = MotionEncoder(c, dt)
        gru_in = c.context_dim + c.motion_out
        self.gru1 = ConvGRU(c.hidden_dim, gru_in, (1, 5), dt)
        self.gru2 = ConvGRU(c.hidden_dim, gru_in, (5, 1), dt)
        self.flow_head1 = Conv(c.hidden_dim, c.flow_head_hidden, 3, dtype=dt)
        self.flow_head2 = Conv(c.flow_head_hidden, 2, 3)
        self.mask_conv1 = ConvNormRelu(c.hidden_dim, c.flow_head_hidden, 3,
                                       "none", dtype=dt)
        self.mask_conv2 = Conv(c.flow_head_hidden, 8 * 8 * 9, 1)

    def forward(self, img1, img2, iters=None):
        """(B, H, W, 3) uint8 or float [0, 255] pairs (or one (H, W, 3)
        pair) -> (B, H, W, 2) float32 flow in pixels; H and W multiples of
        8."""
        c = self.cfg
        dt = c.compute_dtype
        single = img1.ndim == 3
        if single:
            img1, img2 = img1[None], img2[None]
        b = img1.shape[0]
        x = torch.cat([img1, img2]).permute(0, 3, 1, 2).to(dt)
        x = (x / 255.0) * 2.0 - 1.0
        # instance norm is per image: both frames through fnet at once
        f1, f2 = self.fnet(x).to(torch.float32).permute(0, 2, 3, 1).split(b)
        ctx = self.cnet(x[:b])
        hidden = torch.tanh(ctx[:, :c.hidden_dim].to(torch.float32))
        context = F.relu(ctx[:, c.hidden_dim:]).to(torch.float32)
        del x, ctx

        pyr = _corr_pyramid(f1.contiguous(), f2.contiguous(), c.corr_levels)
        del f1, f2
        h, w = hidden.shape[-2:]
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=hidden.device),
            torch.arange(w, dtype=torch.float32, device=hidden.device),
            indexing="ij")
        coords0 = torch.stack([gx, gy], -1).expand(b, h, w, 2)
        coords1 = coords0
        for _ in range(iters if iters is not None else c.iters):
            corr = _lookup(pyr, coords1, c.corr_radius).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            mfeat = self.motion(flow.to(dt), corr.to(dt))
            inp = torch.cat([context, mfeat.to(torch.float32)], 1)
            hidden = self.gru1(hidden, inp)
            hidden = self.gru2(hidden, inp)
            delta = self.flow_head2(F.relu(self.flow_head1(hidden)))
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        up_mask = 0.25 * self.mask_conv2(self.mask_conv1(hidden))
        up_flow = _convex_upsample(coords1 - coords0,
                                   up_mask.permute(0, 2, 3, 1))
        return up_flow[0] if single else up_flow


def flow_to_rgb(flow, max_mag=None):
    """HSV colour coding of flow (..., H, W, 2) (hue: direction, value:
    magnitude over each image's largest, or ``max_mag``; saturation 1) ->
    uint8 RGB (..., H, W, 3)."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = torch.sqrt(fx * fx + fy * fy)
    ang = torch.atan2(fy, fx)
    hue = (ang + math.pi) / (2 * math.pi)
    mmax = (torch.clamp(torch.amax(mag, dim=(-2, -1), keepdim=True),
                        min=1e-6) if max_mag is None else max_mag)
    val = torch.clamp(mag / mmax, 0.0, 1.0)
    i = torch.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = torch.zeros_like(val)
    q = val * (1.0 - f)
    t = val * f
    i = i.to(torch.int64) % 6

    def select(*vals):
        out = vals[5]
        for s in range(4, -1, -1):
            out = torch.where(i == s, vals[s], out)
        return out
    r = select(val, q, p, p, t, val)
    g = select(t, val, val, q, p, p)
    b = select(p, p, t, val, val, q)
    return (torch.stack([r, g, b], -1) * 255).to(torch.uint8)
