"""Point tracking across video frames (PyTorch port of ``models/tracker.py``).

- ``lk_track_clip``: pyramidal Lucas-Kanade with no trained weights, every
  track advanced in parallel (fixed Gauss-Newton iterations per level),
  one frame pair after another; the default engine of ``track`` and the
  track source of ``slam``.
- ``CoTrackerLite`` with ``ConvFeatureNet``: a compact learned tracker
  (conv features, local correlation, an MLP refinement); no entry point
  uses it.

Also the grid query generator: a jittered grid over the first frame, kept
where the Shi-Tomasi corner response (the smaller eigenvalue of the
structure tensor) is strong. Its jitter comes from a numpy
``default_rng``: the same generator gives the JAX package's queries.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.ops import image as im


def _gray(img):
    return (img[..., 0] * 0.299 + img[..., 1] * 0.587
            + img[..., 2] * 0.114).to(torch.float32)


def corner_response(img_u8):
    """Shi-Tomasi min-eigenvalue of the structure tensor of an (H, W, 3)
    image -> (H, W) float32."""
    g = _gray(img_u8.to(torch.float32))
    dev = g.device
    gx = im.filter2d(g, torch.tensor([[-0.5, 0.0, 0.5]], device=dev))
    gy = im.filter2d(g, torch.tensor([[-0.5], [0.0], [0.5]], device=dev))
    ixx = im.gaussian_blur(gx * gx, 5)
    iyy = im.gaussian_blur(gy * gy, 5)
    ixy = im.gaussian_blur(gx * gy, 5)
    tr = ixx + iyy
    det = ixx * iyy - ixy * ixy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return tr / 2.0 - disc


def generate_grid_queries(frame_u8, grid=36, min_response=None, rng=None,
                          jitter=True):
    """A jittered ``grid`` x ``grid`` of query points over an (H, W, 3)
    uint8 frame (numpy or tensor; the response is computed on its
    device), valid where the corner response exceeds ``min_response``
    (default: its 70th percentile). -> ((N, 2) float32 [x, y], (N,)
    float32 validity), numpy, N = grid * grid."""
    frame = torch.as_tensor(frame_u8)
    h, w = frame.shape[:2]
    resp = corner_response(frame).cpu().numpy()
    if min_response is None:
        min_response = np.percentile(resp, 70.0)
    rng = rng or np.random.default_rng(0)
    xs = (np.arange(grid) + 0.5) * (w / grid)
    ys = (np.arange(grid) + 0.5) * (h / grid)
    gx, gy = np.meshgrid(xs, ys)
    if jitter:
        gx = gx + rng.uniform(-0.4, 0.4, gx.shape) * (w / grid)
        gy = gy + rng.uniform(-0.4, 0.4, gy.shape) * (h / grid)
    pts = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
    pts[:, 0] = np.clip(pts[:, 0], 1, w - 2)
    pts[:, 1] = np.clip(pts[:, 1], 1, h - 2)
    xi = pts[:, 0].astype(int)
    yi = pts[:, 1].astype(int)
    ok = resp[yi, xi] > min_response
    return pts.astype(np.float32), ok.astype(np.float32)


def _patch_coords(radius, device=None):
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)


def _sample(img, x, y):
    """Bilinear samples of an (H, W) image at float coordinates of any
    shape, clamped to [0, size - 1.001] (the four taps stay inside)."""
    h, w = img.shape
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    i = y0f.to(torch.int64) * w + x0f.to(torch.int64)
    flat = img.reshape(-1)
    v00 = flat[i]
    v01 = flat[i + 1]
    v10 = flat[i + w]
    v11 = flat[i + w + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _pyramid(gray, levels):
    pyr = [gray]
    for _ in range(levels - 1):
        pyr.append(im.gaussian_blur(pyr[-1], 3)[::2, ::2])
    return pyr


def _lk_pyramids(prev_gray_pyr, next_gray_pyr, pts, radius, iters):
    """Coarse to fine over the pyramids: -> (flow (N, 2), residual (N,))."""
    dx, dy = _patch_coords(radius, pts.device)
    flow = torch.zeros_like(pts)
    res = None
    for lvl in range(len(prev_gray_pyr) - 1, -1, -1):
        scale = 2.0 ** lvl
        p0 = pts / scale
        fl = flow / scale
        i0, i1 = prev_gray_pyr[lvl], next_gray_pyr[lvl]
        px = p0[:, 0, None] + dx
        py = p0[:, 1, None] + dy
        t = _sample(i0, px, py)
        gx = (_sample(i0, px + 1, py) - _sample(i0, px - 1, py)) / 2
        gy = (_sample(i0, px, py + 1) - _sample(i0, px, py - 1)) / 2
        a11 = torch.sum(gx * gx, -1) + 1e-4
        a12 = torch.sum(gx * gy, -1)
        a22 = torch.sum(gy * gy, -1) + 1e-4
        det = a11 * a22 - a12 * a12
        for _ in range(iters):
            err = _sample(i1, px + fl[:, 0, None], py + fl[:, 1, None]) - t
            b1 = torch.sum(err * gx, -1)
            b2 = torch.sum(err * gy, -1)
            du = -(a22 * b1 - a12 * b2) / det
            dv = -(-a12 * b1 + a11 * b2) / det
            fl = fl + torch.stack([du, dv], -1)
        res = torch.mean(torch.abs(
            _sample(i1, px + fl[:, 0, None], py + fl[:, 1, None]) - t), -1)
        flow = fl * scale
    return flow, res


def lk_advance(prev_u8, next_u8, pts, levels=3, radius=4, iters=6):
    """Advance (N, 2) points from one (H, W, 3) frame to the next by
    pyramidal LK (Gauss-Newton on patch brightness constancy, coarse to
    fine). -> (new points (N, 2), residual (N,)): the final mean absolute
    patch difference (high: a lost track)."""
    g0 = _pyramid(_gray(prev_u8.to(torch.float32)), levels)
    g1 = _pyramid(_gray(next_u8.to(torch.float32)), levels)
    flow, res = _lk_pyramids(g0, g1, pts, radius, iters)
    return pts + flow, res


def lk_track_clip(frames_u8, pts0, valid0, levels=3, radius=4, iters=6,
                  max_residual=12.0):
    """Track (N, 2) points through a (T, H, W, 3) clip on its device.
    A track dies when its residual reaches ``max_residual`` or it leaves
    the frame (1 px margin); a dead track keeps its last position.
    -> ((T, N, 2) positions, (T, N) validity), float32 tensors."""
    h, w = frames_u8.shape[1:3]
    pts = pts0.to(torch.float32)
    valid = valid0.to(torch.float32)
    traj, vis = [pts], [valid]
    prev = _pyramid(_gray(frames_u8[0].to(torch.float32)), levels)
    for ti in range(1, frames_u8.shape[0]):
        nxt = _pyramid(_gray(frames_u8[ti].to(torch.float32)), levels)
        flow, res = _lk_pyramids(prev, nxt, pts, radius, iters)
        new_pts = pts + flow
        inb = ((new_pts[:, 0] >= 1) & (new_pts[:, 0] < w - 1)
               & (new_pts[:, 1] >= 1) & (new_pts[:, 1] < h - 1))
        valid = valid * inb.to(torch.float32) * (res < max_residual)
        pts = torch.where(valid[:, None] > 0, new_pts, pts)
        traj.append(pts)
        vis.append(valid)
        prev = nxt
    return torch.stack(traj), torch.stack(vis)


# ---------------------------------------------------------------------------
# The compact learned tracker (not the CoTracker3 graph: upstream
# checkpoints do not map onto it).
# ---------------------------------------------------------------------------

def _conv_same(x, conv, stride):
    """``conv`` (a Conv2d without padding) with Flax's "SAME" padding at
    ``stride``: the output has ceil(size / stride) rows and columns, and
    an odd total pad puts the extra row or column at the bottom/right."""
    pads = []
    for size, k in ((x.shape[-1], conv.kernel_size[1]),
                    (x.shape[-2], conv.kernel_size[0])):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), conv.weight, conv.bias, stride)


class ConvFeatureNet(nn.Module):
    """Stride-4 conv encoder: (T, 3, H, W) in [0, 255] -> (T, dim, H/4,
    W/4)."""

    def __init__(self, dim=64):
        super().__init__()
        self.c1 = nn.Conv2d(3, dim // 2, 7)
        self.c2 = nn.Conv2d(dim // 2, dim, 5)
        self.c3 = nn.Conv2d(dim, dim, 3)

    def forward(self, frames):
        x = frames.to(torch.float32) / 255.0
        x = F.relu(_conv_same(x, self.c1, 2))
        x = F.relu(_conv_same(x, self.c2, 2))
        return _conv_same(x, self.c3, 1)


class CoTrackerLite(nn.Module):
    """Iterative refinement tracker: each track's query feature (frame 0)
    correlated against a (2r+1)^2 window around its estimate in every
    frame, a shared MLP predicting the position update, ``refine_iters``
    times. Modules named after the Flax tree (``fnet``, ``Dense_0..2``)."""

    def __init__(self, dim=64, window_radius=3, refine_iters=4):
        super().__init__()
        self.dim = dim
        self.window_radius = window_radius
        self.refine_iters = refine_iters
        self.fnet = ConvFeatureNet(dim)
        p = (2 * window_radius + 1) ** 2
        self.Dense_0 = nn.Linear(p, 128)
        self.Dense_1 = nn.Linear(128, 64)
        self.Dense_2 = nn.Linear(64, 2)

    def forward(self, frames, queries):
        """frames (T, H, W, 3) uint8; queries (N, 2) positions in frame 0.
        -> (T, N, 2) trajectories."""
        feats = self.fnet(frames.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        t, fh = feats.shape[:2]
        d = feats.shape[-1]
        scale = frames.shape[1] / fh
        qf = im.bilinear_sample(feats[0], queries / scale)       # (N, D)
        dx, dy = _patch_coords(self.window_radius, frames.device)
        traj = queries[None].expand(t, -1, -1)
        for _ in range(self.refine_iters):
            xy = torch.stack([traj[..., 0, None] / scale + dx,
                              traj[..., 1, None] / scale + dy], -1)
            patch = im.bilinear_sample(feats, xy)              # (T,N,P,D)
            corr = torch.einsum("tnpd,nd->tnp", patch, qf) / math.sqrt(
                d * 1.0)
            h1 = F.relu(self.Dense_0(corr))
            traj = traj + self.Dense_2(F.relu(self.Dense_1(h1))) * scale
        return traj
