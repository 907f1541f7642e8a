"""CoTracker3-offline point tracker (PyTorch port of ``models/cotracker.py``).

The graph of the JAX package's ``CoTracker3``: the PIPs-style stride-4
BasicEncoder (every layer's output resized, align-corners bilinear, to
stride 4 and merged), an L-level average-pool pyramid, per track a
(2r+1)^2 support patch at its query frame correlated with the patch at
its estimate in every frame (/ sqrt(C)) through ``corr_mlp``, and the
EfficientUpdateFormer (time blocks over each track's frames, space rounds
through the virtual tracks) predicting [dx, dy, dvis, dconf] each
iteration. Modules are named after the Flax tree (``fnet.layer1_0.conv1``,
``corr_mlp_fc1``, ``updateformer.time_blocks_0.attn.to_q``,
``updateformer.virtual_tracks``), so a Flax ``init`` or a
``cotracker3_offline`` state dict converted by
``convert.convert_cotracker3`` loads with ``models.from_jax``.

Everything computes in float32. ``CoTracker3Engine`` resizes a clip to the
model resolution (antialiased bilinear, as ``jax.image.resize``), tracks
fixed-width chunks of queries and maps the trajectories back.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models.norm import InstanceNorm
from metric_depth_video_toolbox_tpu_torch.ops import image as im
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CoTracker3Config:
    latent_dim: int = 128
    stride: int = 4
    corr_radius: int = 3
    corr_levels: int = 4
    corr_mlp_hidden: int = 384
    corr_emb_dim: int = 256
    hidden_size: int = 384
    num_heads: int = 8
    time_depth: int = 3
    space_depth: int = 3
    num_virtual_tracks: int = 64
    mlp_ratio: float = 4.0
    flow_embed_dim: int = 64  # get_2d_embedding C
    iters: int = 4
    model_resolution: tuple = (384, 512)  # (H, W), upstream offline res

    @property
    def window(self):
        return 2 * self.corr_radius + 1

    @property
    def input_dim(self):
        # [vis, conf] + L * corr_emb + (2*C + 2) flow embedding
        return 2 + self.corr_levels * self.corr_emb_dim \
            + 2 * self.flow_embed_dim + 2


COTRACKER3 = CoTracker3Config()
COTRACKER3_TINY = CoTracker3Config(
    latent_dim=8, corr_radius=1, corr_levels=2, corr_mlp_hidden=16,
    corr_emb_dim=12, hidden_size=16, num_heads=2, time_depth=2,
    space_depth=2, num_virtual_tracks=4, flow_embed_dim=8, iters=2,
    model_resolution=(48, 64))


class ResBlock(nn.Module):
    """PIPs residual block: conv-IN-relu twice, a 1x1 conv + IN on the
    skip when strided or widened, relu after the sum."""

    def __init__(self, cin, out, stride=1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, out, 3, stride, 1)
        self.conv2 = nn.Conv2d(out, out, 3, 1, 1)
        self.norm = InstanceNorm()
        if stride != 1 or cin != out:
            self.down_conv = nn.Conv2d(cin, out, 1, stride)

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        if hasattr(self, "down_conv"):
            x = self.norm(self.down_conv(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """(B, 3, H, W) in [-1, 1] -> (B, latent_dim, H/4, W/4)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        d = cfg.latent_dim
        dims = (d // 2, (d // 4) * 3, d, d)
        self.conv1 = nn.Conv2d(3, d // 2, 7, 2, 3)
        self.norm = InstanceNorm()
        cin = d // 2
        for li, (width, stride) in enumerate(zip(dims, (1, 2, 2, 2))):
            self.add_module(f"layer{li + 1}_0", ResBlock(cin, width, stride))
            self.add_module(f"layer{li + 1}_1", ResBlock(width, width, 1))
            cin = width
        self.conv2 = nn.Conv2d(sum(dims), 2 * d, 3, 1, 1)
        self.conv3 = nn.Conv2d(2 * d, d, 1)

    def forward(self, x):
        h, w = x.shape[-2:]
        x = F.relu(self.norm(self.conv1(x)))
        hw = (h // self.cfg.stride, w // self.cfg.stride)
        outs = []
        for li in range(4):
            x = getattr(self, f"layer{li + 1}_0")(x)
            x = getattr(self, f"layer{li + 1}_1")(x)
            outs.append(F.interpolate(x, size=hw, mode="bilinear",
                                      align_corners=True))
        y = F.relu(self.norm(self.conv2(torch.cat(outs, 1))))
        return self.conv3(y)


class Attention(nn.Module):
    """to_q / to_kv / to_out, scale dim_head^-0.5, over (..., S, C)."""

    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim)
        self.to_kv = nn.Linear(dim, 2 * dim)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x, context=None):
        c = x.shape[-1]
        ctx = x if context is None else context
        hd = c // self.heads
        q = self.to_q(x)
        k, v = self.to_kv(ctx).split(c, -1)

        def split(t):
            return t.reshape(t.shape[:-1] + (self.heads, hd)).transpose(-3,
                                                                       -2)
        o = F.scaled_dot_product_attention(split(q), split(k), split(v))
        return self.to_out(o.transpose(-3, -2).reshape(x.shape))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def _ln(dim):
    return nn.LayerNorm(dim, eps=1e-6)


class AttnBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio):
        super().__init__()
        self.norm1 = _ln(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio):
        super().__init__()
        self.norm1 = _ln(dim)
        self.norm_context = _ln(dim)
        self.cross_attn = Attention(dim, heads)
        self.norm2 = _ln(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, context):
        x = x + self.cross_attn(self.norm1(x),
                                context=self.norm_context(context))
        return x + self.mlp(self.norm2(x))


def sincos_1d(n, dim, device=None):
    """Parameter-free 1D sincos positional embedding (n, dim)."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / max(half, 1))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] \
        * freq[None]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    return F.pad(emb, (0, dim - emb.shape[-1]))


def get_2d_embedding(xy, c):
    """PIPs get_2d_embedding(cat_coords=True): (..., 2) -> (..., 2c+2)."""
    div = torch.arange(0, c, 2, dtype=torch.float32, device=xy.device) \
        * (1000.0 / c)
    x = xy[..., 0:1] * div
    y = xy[..., 1:2] * div
    pe_x = torch.stack([torch.sin(x), torch.cos(x)], -1).reshape(
        xy.shape[:-1] + (c,))
    pe_y = torch.stack([torch.sin(y), torch.cos(y)], -1).reshape(
        xy.shape[:-1] + (c,))
    return torch.cat([xy, pe_x, pe_y], -1)


class EfficientUpdateFormer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = self.cfg = cfg
        hs = c.hidden_size
        self.input_transform = nn.Linear(c.input_dim, hs)
        self.virtual_tracks = nn.Parameter(
            torch.zeros(c.num_virtual_tracks, 1, hs))
        for i in range(c.time_depth):
            self.add_module(f"time_blocks_{i}",
                            AttnBlock(hs, c.num_heads, c.mlp_ratio))
        for j in range(c.space_depth):
            self.add_module(f"space_virtual2point_blocks_{j}",
                            CrossAttnBlock(hs, c.num_heads, c.mlp_ratio))
            self.add_module(f"space_virtual_blocks_{j}",
                            AttnBlock(hs, c.num_heads, c.mlp_ratio))
            self.add_module(f"space_point2virtual_blocks_{j}",
                            CrossAttnBlock(hs, c.num_heads, c.mlp_ratio))
        self.flow_head = nn.Linear(hs, 2)
        self.vis_conf_head = nn.Linear(hs, 2)

    def forward(self, x):
        """x (N, T, input_dim) -> (N, T, 4) [dx, dy, dvis, dconf]."""
        c = self.cfg
        n, t, _ = x.shape
        tokens = self.input_transform(x) + sincos_1d(
            t, c.hidden_size, x.device)[None]
        tokens = torch.cat([tokens, self.virtual_tracks.expand(
            -1, t, -1)], 0)
        every = max(c.time_depth // c.space_depth, 1)
        j = 0
        for i in range(c.time_depth):
            tokens = getattr(self, f"time_blocks_{i}")(tokens)
            if j < c.space_depth and i % every == 0:
                sp = tokens.transpose(0, 1)          # (T, N+V, C)
                pts, virt = sp[:, :n], sp[:, n:]
                virt = getattr(self, f"space_virtual2point_blocks_{j}")(
                    virt, pts)
                virt = getattr(self, f"space_virtual_blocks_{j}")(virt)
                pts = getattr(self, f"space_point2virtual_blocks_{j}")(
                    pts, virt)
                tokens = torch.cat([pts, virt], 1).transpose(0, 1)
                j += 1
        pts = tokens[:n]
        return torch.cat([self.flow_head(pts), self.vis_conf_head(pts)], -1)


def _sample_frames(fmaps, tidx, xy):
    """Bilinear samples of frame ``tidx`` of (T, h, w, D) feature maps at
    float coordinates xy (..., 2), taps outside the frame reading 0
    (``ops/image.py::bilinear_sample`` without a copy of each track's
    frame). ``tidx`` broadcasts against xy[..., 0]. -> (..., D)"""
    t, h, w, d = fmaps.shape
    flat = fmaps.reshape(t * h * w, d)
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    base = tidx * (h * w)

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        i = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return flat[i] * ok[..., None].to(flat.dtype)

    return ((1 - fy) * ((1 - fx) * tap(y0, x0) + fx * tap(y0, x0 + 1))
            + fy * ((1 - fx) * tap(y0 + 1, x0) + fx * tap(y0 + 1, x0 + 1)))


def _patch_offsets(radius, device=None):
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)     # (P, 2)


class CoTracker3(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        c = self.cfg = cfg
        self.fnet = BasicEncoder(c)
        self.corr_mlp_fc1 = nn.Linear(c.window ** 4, c.corr_mlp_hidden)
        self.corr_mlp_fc2 = nn.Linear(c.corr_mlp_hidden, c.corr_emb_dim)
        self.updateformer = EfficientUpdateFormer(c)

    def corr_mlp(self, v):
        # upstream's corr_mlp is a timm Mlp with the exact GELU
        return self.corr_mlp_fc2(F.gelu(self.corr_mlp_fc1(v)))

    def forward(self, video, queries, iters=None):
        """video (T, H, W, 3) float [0, 255]; queries (N, 3) = (t, x, y)
        pixels. -> {"coords": (T, N, 2) pixels, "vis", "conf": (T, N)
        probabilities}."""
        c = self.cfg
        iters = iters or c.iters
        t = video.shape[0]
        n = queries.shape[0]
        x = 2.0 * (video.to(torch.float32) / 255.0) - 1.0
        fmap = self.fnet(x.permute(0, 3, 1, 2))
        pyramid = [fmap.permute(0, 2, 3, 1)]                 # (T, h, w, D)
        for _ in range(c.corr_levels - 1):
            pyramid.append(F.avg_pool2d(fmap, 2).permute(0, 2, 3, 1))
            fmap = pyramid[-1].permute(0, 3, 1, 2)
        offs = _patch_offsets(c.corr_radius, video.device)
        q_t = queries[:, 0].to(torch.int64)
        q_xy = queries[:, 1:] / c.stride
        # each track's support patches at its query frame, every level
        support = [_sample_frames(f, q_t[:, None],
                                  (q_xy / 2 ** li)[:, None] + offs)
                   for li, f in enumerate(pyramid)]          # (N, P, D)
        frame = torch.arange(t, device=video.device)[:, None, None]
        coords = q_xy[None].expand(t, -1, -1)
        vis = torch.zeros((t, n), device=video.device)
        conf = torch.zeros((t, n), device=video.device)
        d = c.latent_dim
        for _ in range(iters):
            embs = []
            for li, f in enumerate(pyramid):
                patches = _sample_frames(
                    f, frame, (coords / 2 ** li)[:, :, None] + offs)
                vol = torch.einsum("tnpc,nqc->tnpq", patches,
                                   support[li]) / math.sqrt(d * 1.0)
                embs.append(self.corr_mlp(vol.reshape(t, n, -1)))
            inp = torch.cat(
                [vis[..., None], conf[..., None]] + embs
                + [get_2d_embedding(coords - q_xy[None], c.flow_embed_dim)],
                -1)
            delta = self.updateformer(inp.transpose(0, 1)).transpose(0, 1)
            coords = coords + delta[..., :2]
            vis = vis + delta[..., 2]
            conf = conf + delta[..., 3]
        return {"coords": coords * c.stride, "vis": torch.sigmoid(vis),
                "conf": torch.sigmoid(conf)}


class CoTracker3Engine:
    """Clip driver: resizes a clip to the model resolution, tracks the
    queries in chunks of ``track_chunk`` (space attention spans a chunk
    and the virtual tracks) and returns pixel trajectories and validity at
    the clip's resolution (the encoder runs again for every chunk, as in
    the JAX package). ``params``: a Flax tree or a port state dict; None
    draws seeded weights (``rng_seed``)."""

    def __init__(self, cfg=None, params=None, iters=None, track_chunk=256,
                 vis_threshold=0.6, rng_seed=0, device=None):
        self.cfg = cfg or COTRACKER3
        self.device = resolve_device(device)
        self.iters = iters or self.cfg.iters
        self.track_chunk = track_chunk
        self.vis_threshold = vis_threshold
        model = CoTracker3(self.cfg)
        if params is None:
            from_jax.flax_like_init(model, torch.Generator().manual_seed(
                rng_seed), normal=("virtual_tracks",))
        else:
            from_jax.load_params(model, params)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def track_clip(self, frames_u8, pts, valid):
        """frames_u8 (T, H, W, 3) uint8, pts (N, 2) pixel queries in frame
        0, valid (N,) -> (traj (T, N, 2), vis (T, N)) float32 numpy."""
        t, h, w = frames_u8.shape[:3]
        mh, mw = self.cfg.model_resolution
        video = im.resize(torch.as_tensor(np.asarray(frames_u8)).to(
            self.device, torch.float32), (mh, mw))
        sx, sy = mw / w, mh / h
        n = pts.shape[0]
        chunk = min(self.track_chunk, n)
        pad = (-n) % chunk
        q = np.concatenate([np.asarray(pts, np.float32),
                            np.zeros((pad, 2), np.float32)])
        queries = torch.from_numpy(np.concatenate(
            [np.zeros((n + pad, 1), np.float32),
             q * np.asarray([[sx, sy]], np.float32)], axis=1)).to(
                 self.device)
        trajs, viss = [], []
        for s in range(0, n + pad, chunk):
            out = self.model(video, queries[s:s + chunk], iters=self.iters)
            trajs.append(out["coords"])
            viss.append(out["vis"] * out["conf"])
        traj = torch.cat(trajs, 1)[:, :n].cpu().numpy()
        vis = torch.cat(viss, 1)[:, :n].cpu().numpy()
        traj = traj / np.asarray([[[sx, sy]]], np.float32)
        okrow = (vis > self.vis_threshold).astype(np.float32)
        return traj, okrow * np.asarray(valid, np.float32)[None]
