"""DROID-SLAM-class learned tracking front-end (PyTorch port of
``models/droid.py``): the network the ``slam --checkpoint`` path runs.

  fnet   BasicEncoder (instance norm): 7x7/2 stem, three two-block
         residual layers (64, 96/2, 128/2), 1x1 out conv -> 128-d
         features at 1/8 resolution.
  cnet   the same without norms -> hidden + context channels (tanh /
         relu).
  update the learned update operator over all edges of a frame graph:
         correlation and flow encoders, the ConvGRU with DROID's global
         context (a gated spatial mean into 1x1 ``*_glo`` gates), the flow
         revision (``delta``) and confidence (``weight``) heads, and
         GraphAgg (a mean over the edges of each source frame -> the
         damping eta and an 8x8x9 upsampling mask).

Modules are named after the Flax tree (``fnet.layer2_0.downsample``,
``update.gru.convz_glo``, ``update.agg_eta``), so a Flax ``init`` or a
DROID / Mega-SAM checkpoint converted by ``convert.convert_droid`` loads
with ``models.from_jax``. Convolutions compute in the config's dtype
(bfloat16 for DROID), the features, hidden state and the ``delta2``,
``weight2``, ``agg_eta``, ``agg_upmask`` heads in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.norm import InstanceNorm
from metric_depth_video_toolbox_tpu_torch.models.raft import (
    Conv, _corr_pyramid, _lookup)


@dataclasses.dataclass(frozen=True)
class DroidConfig:
    stem: int = 64
    layers: Sequence[int] = (64, 96, 128)
    feat_dim: int = 128
    hidden: int = 128
    context: int = 128
    corr_levels: int = 4
    corr_radius: int = 3
    upsample_factor: int = 8
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def cor_planes(self):
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2


DROID = DroidConfig()
DROID_TINY = DroidConfig(stem=8, layers=(8, 12, 16), feat_dim=16,
                         hidden=16, context=16, corr_levels=2,
                         corr_radius=1, dtype="float32")


class DroidResBlock(nn.Module):
    """The original RAFT ResidualBlock that DROID vendors: conv (bias) ->
    norm -> relu twice, a 1x1 (+ norm) skip when strided or widened, relu
    after the sum."""

    def __init__(self, cin, planes, norm, stride, dtype):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, dtype=dtype)
        self.norm = InstanceNorm() if norm == "instance" else nn.Identity()
        if stride != 1 or cin != planes:
            self.downsample = Conv(cin, planes, 1, stride, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        if hasattr(self, "downsample"):
            x = self.norm(self.downsample(x))
        return F.relu(x + y)


class DroidEncoder(nn.Module):
    """(T, 3, H, W) ImageNet-normalized -> (T, out_dim, H/8, W/8)."""

    def __init__(self, cfg, out_dim, norm):
        super().__init__()
        dt = self.dtype = cfg.compute_dtype
        self.conv1 = Conv(3, cfg.stem, 7, 2, dtype=dt)
        self.norm = InstanceNorm() if norm == "instance" else nn.Identity()
        cin = cfg.stem
        for li, width in enumerate(cfg.layers):
            self.add_module(f"layer{li + 1}_0", DroidResBlock(
                cin, width, norm, 1 if li == 0 else 2, dt))
            self.add_module(f"layer{li + 1}_1", DroidResBlock(
                width, width, norm, 1, dt))
            cin = width
        self.n_layers = len(cfg.layers)
        self.conv2 = Conv(cin, out_dim, 1, dtype=dt)

    def forward(self, x):
        x = F.relu(self.norm(self.conv1(x.to(self.dtype))))
        for li in range(self.n_layers):
            x = getattr(self, f"layer{li + 1}_0")(x)
            x = getattr(self, f"layer{li + 1}_1")(x)
        return self.conv2(x)


class DroidConvGRU(nn.Module):
    """3x3 gates over cat(net, inp) plus the global context: sigmoid(w(net))
    * net averaged over space, through 1x1 ``*_glo`` convs into each
    gate."""

    def __init__(self, hidden, cin, dtype):
        super().__init__()
        self.w = Conv(hidden, hidden, 1, dtype=dtype)
        for g in ("convz", "convr", "convq"):
            self.add_module(g, Conv(hidden + cin, hidden, 3, dtype=dtype))
            self.add_module(g + "_glo", Conv(hidden, hidden, 1, dtype=dtype))

    def forward(self, net, inp):
        glo = torch.sigmoid(self.w(net)) * net
        glo = glo.mean(dim=(2, 3), keepdim=True)
        hx = torch.cat([net, inp.to(net.dtype)], 1)
        z = torch.sigmoid(self.convz(hx) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(hx) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp.to(net.dtype)], 1))
                       + self.convq_glo(glo))
        return (1 - z) * net + z * q


class DroidUpdate(nn.Module):
    """The update operator over all graph edges at once, NCHW:

      net (E, hidden, h, w), inp (E, context, h, w), corr (E, cor_planes,
      h, w), flow (E, 4, h, w); src (E,) int64 edge source frames.

    -> (net, delta (E, 2, h, w), weight (E, 2, h, w), eta (T, h, w),
    upmask (T, 8*8*9, h, w)); eta and upmask None without ``src``."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg
        dt = self.dtype = c.compute_dtype
        width = 128 if c.feat_dim >= 128 else c.hidden * 2
        self.corr_enc1 = Conv(c.cor_planes, width, 1, dtype=dt)
        self.corr_enc2 = Conv(width, c.hidden, 3, dtype=dt)
        self.flow_enc1 = Conv(4, width, 7, dtype=dt)
        self.flow_enc2 = Conv(width, c.hidden // 2, 3, dtype=dt)
        self.gru = DroidConvGRU(c.hidden, c.context + c.hidden
                                + c.hidden // 2, dt)
        self.delta1 = Conv(c.hidden, c.hidden, 3, dtype=dt)
        self.delta2 = Conv(c.hidden, 2, 3)
        self.weight1 = Conv(c.hidden, c.hidden, 3, dtype=dt)
        self.weight2 = Conv(c.hidden, 2, 3)
        self.agg_conv1 = Conv(c.hidden, c.hidden, 3, dtype=dt)
        self.agg_conv2 = Conv(c.hidden, c.hidden, 3, dtype=dt)
        self.agg_eta = Conv(c.hidden, 1, 3)
        self.agg_upmask = Conv(c.hidden, c.upsample_factor ** 2 * 9, 1)

    def forward(self, net, inp, corr, flow, src=None, n_frames=None):
        cf = F.relu(self.corr_enc2(F.relu(self.corr_enc1(corr))))
        ff = F.relu(self.flow_enc2(F.relu(self.flow_enc1(flow))))
        net = self.gru(net, torch.cat([inp.to(self.dtype), cf, ff], 1))
        delta = self.delta2(F.relu(self.delta1(net)))
        weight = torch.sigmoid(self.weight2(F.relu(self.weight1(net))))
        eta = upmask = None
        if src is not None:
            # GraphAgg: the mean over the edges that share a source frame
            a = F.relu(self.agg_conv1(net))
            sums = torch.zeros((n_frames,) + a.shape[1:], dtype=a.dtype,
                               device=a.device).index_add_(0, src, a)
            cnt = torch.zeros(n_frames, dtype=a.dtype,
                              device=a.device).index_add_(
                0, src, torch.ones(a.shape[0], dtype=a.dtype,
                                   device=a.device))
            mean = sums / torch.clamp(cnt, min=1.0)[:, None, None, None]
            a = F.relu(self.agg_conv2(mean))
            eta = 0.01 * F.softplus(self.agg_eta(a)[:, 0])
            upmask = self.agg_upmask(a)
        return net, delta, weight, eta, upmask


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class DroidNet(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = self.cfg = cfg
        self.fnet = DroidEncoder(c, c.feat_dim, "instance")
        self.cnet = DroidEncoder(c, c.hidden + c.context, "none")
        self.update = DroidUpdate(c)

    def features(self, images):
        """images (T, H, W, 3) in [0, 1] -> (fmap, net, inp) (T, C, H/8,
        W/8) float32 (ImageNet-normalized inside)."""
        c = self.cfg
        mean = torch.tensor(_MEAN, device=images.device)
        std = torch.tensor(_STD, device=images.device)
        x = ((images - mean) / std).permute(0, 3, 1, 2)
        fmap = self.fnet(x).to(torch.float32)
        ctx = self.cnet(x)
        net = torch.tanh(ctx[:, :c.hidden]).to(torch.float32)
        inp = F.relu(ctx[:, c.hidden:]).to(torch.float32)
        return fmap, net, inp

    def forward(self, images):
        """Features and one update step on zero correlation and flow (the
        Flax model's ``init`` call, touching every parameter)."""
        c = self.cfg
        fmap, net, inp = self.features(images)
        t, _, h, w = fmap.shape
        corr = torch.zeros((t, c.cor_planes, h, w), device=fmap.device)
        flow = torch.zeros((t, 4, h, w), device=fmap.device)
        src = torch.arange(t, device=fmap.device)
        return self.update(net, inp, corr, flow, src, t)


def config_from_params(params, dtype="bfloat16"):
    """A DroidConfig from a converted Flax tree (``{"params": {"fnet",
    "cnet", "update"}}``): widths, the hidden / context split and the
    correlation pyramid's geometry all come from the leaves' shapes."""
    p = params["params"]
    fnet, cnet, upd = p["fnet"], p["cnet"], p["update"]

    def shape(leaf):
        return np.shape(leaf)

    stem = int(shape(fnet["conv1"]["kernel"])[-1])
    n_layers = sum(1 for k in fnet if k.startswith("layer")
                   and k.endswith("_0"))
    layers = tuple(int(shape(fnet[f"layer{i + 1}_0"]["conv1"]["kernel"])[-1])
                   for i in range(n_layers))
    feat_dim = int(shape(fnet["conv2"]["kernel"])[-1])
    hidden = int(shape(upd["gru"]["convz"]["kernel"])[-1])
    context = int(shape(cnet["conv2"]["kernel"])[-1]) - hidden
    cor_planes = int(shape(upd["corr_enc1"]["kernel"])[-2])
    for radius in (3, 1, 2, 4):
        if cor_planes % (2 * radius + 1) ** 2 == 0:
            levels = cor_planes // (2 * radius + 1) ** 2
            if 1 <= levels <= 6:
                break
    up = int(round((int(shape(upd["agg_upmask"]["kernel"])[-1]) // 9)
                   ** 0.5))
    return DroidConfig(stem=stem, layers=layers, feat_dim=feat_dim,
                       hidden=hidden, context=context,
                       corr_levels=levels, corr_radius=radius,
                       upsample_factor=up, dtype=dtype)


def corr_pyramid(f1, f2, levels):
    """All-pairs correlation pyramid between per-edge feature maps (E, h,
    w, C) (``models.raft``'s)."""
    return _corr_pyramid(f1, f2, levels)


def corr_lookup(pyr, coords, radius):
    """(E, h, w, levels * (2r+1)^2) correlation features around per-pixel
    target coordinates (x, y)."""
    return _lookup(pyr, coords, radius)
