"""Subject segmentation: U²-Net (PyTorch port of ``models/segmentation.py``).

The graph is the original u2net.py's: REBNCONV (3x3 conv with dilation ->
batch norm -> ReLU), RSU-7 .. RSU-4 blocks with ceil-mode max pooling and
bilinear upsampling, two dilated RSU-4F stages, and six side outputs fused
by a 1x1 conv. Modules are named after the Flax tree (``stage1
.rebnconvin.conv``, ``stage5d.rebnconv1d.bn``, ``side3``, ``outconv``), so
a Flax ``init`` or a u2net / u2netp checkpoint through the JAX package's
``convert.convert_u2net`` loads with ``models.from_jax``.

Dtypes follow the Flax model: the stages (convolutions and batch norms)
compute in the config's dtype (bfloat16 by default; each batch norm in
float32 on the way, its output cast back), the six side convolutions,
``outconv`` and the sigmoid in float32.

Input (B, H, W, 3) in [0, 1]; rembg's preprocessing (divide each image by
its own maximum, then ImageNet mean/std) is applied inside the model.
Output (B, H, W) float32 foreground probability.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.norm import EvalBatchNorm


@dataclasses.dataclass(frozen=True)
class SegConfig:
    # (height, mid, out) per encoder stage; height 0 = dilated RSU4F
    stages: tuple = ((7, 32, 64), (6, 32, 128), (5, 64, 256),
                     (4, 128, 512), (0, 256, 512), (0, 256, 512))
    # (height, mid, out) per decoder stage (stage5d .. stage1d)
    dec_stages: tuple = ((0, 256, 512), (4, 128, 256), (5, 64, 128),
                         (6, 32, 64), (7, 16, 64))
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


SEG_FULL = SegConfig()  # u2net (173.6 MB checkpoint layout)
SEG_SMALL = SegConfig(  # u2netp (4.7 MB layout)
    stages=((7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64),
            (0, 16, 64), (0, 16, 64)),
    dec_stages=((0, 16, 64), (4, 16, 64), (5, 16, 64), (6, 16, 64),
                (7, 16, 64)))
SEG_TINY = SegConfig(
    stages=((7, 4, 8), (6, 4, 8), (5, 4, 8), (4, 4, 8),
            (0, 4, 8), (0, 4, 8)),
    dec_stages=((0, 4, 8), (4, 4, 8), (5, 4, 8), (6, 4, 8), (7, 4, 8)),
    dtype="float32")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Conv(nn.Conv2d):
    """A 2D convolution whose input, weight and bias are cast to
    ``dtype`` (Flax ``nn.Conv(dtype=...)``); parameters stay float32."""

    def __init__(self, cin, cout, k, dilation=1, dtype=torch.float32):
        pad = dilation * (k // 2)
        super().__init__(cin, cout, k, padding=pad, dilation=dilation)
        self.dtype = dtype

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), padding=self.padding,
                        dilation=self.dilation)


def _ceil_pool(x):
    """MaxPool2d(2, 2, ceil_mode=True): a partial window at an odd edge
    takes the max of what it covers (the Flax model's -inf padding)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_like(x, ref):
    """Bilinear, half-pixel centres, no antialias, to ref's size; computed
    in float32 and cast back to x's dtype."""
    return F.interpolate(x.to(torch.float32), size=tuple(ref.shape[-2:]),
                         mode="bilinear", align_corners=False).to(x.dtype)


class REBNConv(nn.Module):
    """u2net REBNCONV: 3x3 conv (dilation d, pad d) -> BN -> ReLU."""

    def __init__(self, cin, out, dirate=1, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, out, 3, dirate, dtype)
        self.bn = EvalBatchNorm(out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class RSU(nn.Module):
    """Residual U-block of the given height (RSU7 .. RSU4): encoder convs
    with ceil-mode pools, a dilated bottom conv, decoder convs on the
    upsampled deeper output concatenated with the skip, and the input
    conv added back."""

    def __init__(self, height, cin, mid, out, dtype=torch.float32):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNConv(cin, out, 1, dtype)
        self.add_module("rebnconv1", REBNConv(out, mid, 1, dtype))
        for i in range(2, height):
            self.add_module(f"rebnconv{i}", REBNConv(mid, mid, 1, dtype))
        self.add_module(f"rebnconv{height}", REBNConv(mid, mid, 2, dtype))
        for i in range(height - 1, 0, -1):
            self.add_module(f"rebnconv{i}d", REBNConv(
                2 * mid, out if i == 1 else mid, 1, dtype))

    def forward(self, x):
        hl = self.height
        xin = self.rebnconvin(x)
        enc = []
        h = xin
        for i in range(1, hl):
            h = getattr(self, f"rebnconv{i}")(h)
            enc.append(h)
            if i < hl - 1:
                h = _ceil_pool(h)
        h = getattr(self, f"rebnconv{hl}")(h)
        for i in range(hl - 1, 0, -1):
            skip = enc[i - 1]
            if h.shape[-2:] != skip.shape[-2:]:
                h = _upsample_like(h, skip)
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, skip], dim=1))
        return h + xin


class RSU4F(nn.Module):
    """Dilated residual block (no pooling): dilations 1, 2, 4, 8 down and
    4, 2, 1 up."""

    def __init__(self, cin, mid, out, dtype=torch.float32):
        super().__init__()
        self.rebnconvin = REBNConv(cin, out, 1, dtype)
        self.rebnconv1 = REBNConv(out, mid, 1, dtype)
        self.rebnconv2 = REBNConv(mid, mid, 2, dtype)
        self.rebnconv3 = REBNConv(mid, mid, 4, dtype)
        self.rebnconv4 = REBNConv(mid, mid, 8, dtype)
        self.rebnconv3d = REBNConv(2 * mid, mid, 4, dtype)
        self.rebnconv2d = REBNConv(2 * mid, mid, 2, dtype)
        self.rebnconv1d = REBNConv(2 * mid, out, 1, dtype)

    def forward(self, x):
        xin = self.rebnconvin(x)
        h1 = self.rebnconv1(xin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], dim=1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], dim=1))
        return self.rebnconv1d(torch.cat([h2d, h1], dim=1)) + xin


def _stage(spec, cin, dtype):
    height, mid, out = spec
    if height == 0:
        return RSU4F(cin, mid, out, dtype)
    return RSU(height, cin, mid, out, dtype)


class U2Net(nn.Module):
    def __init__(self, cfg: SegConfig = SEG_FULL):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        cin = 3
        for i, spec in enumerate(cfg.stages):
            self.add_module(f"stage{i + 1}", _stage(spec, cin, dt))
            cin = spec[2]
        self.side6 = Conv(cin, 1, 3)
        n = len(cfg.dec_stages)
        for k, spec in enumerate(cfg.dec_stages):
            si = n - 1 - k                     # stage5d .. stage1d
            self.add_module(f"stage{si + 1}d", _stage(
                spec, cin + cfg.stages[si][2], dt))
            cin = spec[2]
            self.add_module(f"side{si + 1}", Conv(cin, 1, 3))
        self.outconv = Conv(6, 1, 1)
        self.register_buffer("pixel_mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, images):
        """(B, H, W, 3) in [0, 1] -> (B, H, W) foreground probability (the
        fused output of the six sides)."""
        c = self.cfg
        x = images.to(torch.float32)
        x = x / torch.clamp(x.amax(dim=(1, 2, 3), keepdim=True), min=1e-6)
        x = (x - self.pixel_mean) / self.pixel_std
        h = x.permute(0, 3, 1, 2).to(c.compute_dtype)

        encs = []
        for i in range(len(c.stages)):
            h = getattr(self, f"stage{i + 1}")(h)
            encs.append(h)
            if i < len(c.stages) - 1:
                h = _ceil_pool(h)

        sides = [None] * 6
        sides[5] = self.side6(encs[5])
        d = encs[5]
        n = len(c.dec_stages)
        for k in range(n):
            si = n - 1 - k
            skip = encs[si]
            d = _upsample_like(d, skip)
            d = getattr(self, f"stage{si + 1}d")(torch.cat([d, skip], dim=1))
            sides[si] = getattr(self, f"side{si + 1}")(d)
        ups = [sides[0]] + [_upsample_like(s, sides[0]) for s in sides[1:]]
        d0 = self.outconv(torch.cat(ups, dim=1))
        return torch.sigmoid(d0[:, 0].to(torch.float32))
