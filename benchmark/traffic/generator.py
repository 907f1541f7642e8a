"""The one traffic generator: film shots from a mix's parameter file.

A mix (``traffic/<name>.json``) gives the shots' lengths (the quantiles of
a log-normal, clipped), their fixed order, the frame size, the size of the
pool of frames that the shots are cut from, the range of each pool
segment's pan and the range of the convergence depth. The seed draws only
the content: the pool's colour (film-like depth and colour, a frozen copy
of ``synth_scene`` of the port's ``chip_smoke.py``, with a pan per
segment), each segment's layout, and each shot's convergence depth. So
every seed does the same work.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load(name):
    return json.loads((HERE / f"{name}.json").read_text())


def shot_lengths(mix):
    """The shots' frame counts in the mix's order."""
    s = mix["shot_lengths"]
    dist = statistics.NormalDist()
    n = s["count"]
    qs = [s["median"] * math.exp(s["sigma"] * dist.inv_cdf((i + 0.5) / n))
          for i in range(n)]
    lengths = [int(min(max(math.floor(q + 0.5), s["min"]), s["max"]))
               for q in qs]
    return [lengths[i] for i in mix["order"]]


def seed_ints(seed, n=4):
    """A seed of any size as 32-bit words for numpy and torch."""
    seed = int(seed)
    words = []
    for _ in range(n):
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
    return words


def host_rng(seed, stream):
    return np.random.default_rng(seed_ints(seed) + [stream])


def film_frames(b, gen, device, h, w, pan_px, layout):
    """``b`` frames of a pan over a scene of a ground and four slabs:
    film-like colour (smooth lighting, per-slab albedo, fine texture,
    sensor grain) on the device; the whole view moves ``pan_px`` columns a
    frame. ``layout``: (4, 2) offsets of the slabs' columns as
    shares of the width. -> colour (b, h, w, 3) uint8."""
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)
    objs = [(h // 5, 3 * h // 5, 1 / 8, 1 / 3),
            (h // 3, 9 * h // 10, 1 / 2, 2 / 3),
            (h // 2, 4 * h // 5, 3 / 4, 9 / 10),
            (0, h // 4, 2 / 5, 3 / 5)]
    albedo = [[25, -30, 10], [-35, 20, 30], [15, 25, -25], [-20, -15, 35]]
    col = torch.empty((b, h, w, 3), device=device)
    tint = torch.tensor([1.0, 0.8, 0.6], device=device)
    for i in range(b):
        x = xs + i * pan_px
        xx = (x / (w - 1))[None, :, None]
        c = (90 + 70 * yy[..., None] + 40 * (xs / (w - 1))[None, :, None]
             * tint)
        c = c + 18 * torch.sin(xx * 97.0 + yy[..., None] * 31.0) \
            * torch.cos(yy[..., None] * 211.0)
        for k, (t, bt, lf, rt) in enumerate(objs):
            left = (lf + layout[k][0]) * w
            right = (rt + layout[k][1]) * w
            inside = ((x >= left) & (x < right))[None, :, None]
            rows = torch.zeros((h, 1, 1), dtype=torch.bool, device=device)
            rows[t:bt] = True
            c = c + torch.where(rows & inside, torch.tensor(
                albedo[k], device=device, dtype=torch.float32), 0.0)
        col[i] = c
    col += 3.0 * torch.randn(col.shape, generator=gen, device=device)
    return col.clamp(0, 255).to(torch.uint8)


class FilmShots:
    """The shots of a mix for one seed: ``shot(k)`` is the k-th shot handed
    over, (T, H, W, 3) uint8 host frames (a view into the pool), with its
    convergence depth."""

    def __init__(self, mix, seed, device):
        self.mix = mix
        self.lengths = shot_lengths(mix)
        h, w = mix["height"], mix["width"]
        n, seg = mix["pool_frames"], mix["segment_frames"]
        rng = host_rng(seed, 1)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % 2 ** 64)
        lo, hi = mix["pan_px_per_frame"]
        pool = []
        for _ in range(0, n, seg):
            layout = rng.uniform(-0.05, 0.05, (4, 2))
            pool.append(film_frames(seg, gen, device, h, w,
                                    float(rng.uniform(lo, hi)), layout).cpu())
        pool = torch.cat(pool).numpy()
        # a shot is a slice of consecutive frames, wrapping round the pool
        longest = max(self.lengths)
        self.pool = np.concatenate([pool, pool[:longest]])
        self.pool_frames = n
        c_lo, c_hi = mix["convergence_depth_m"]
        self.conv = rng.uniform(c_lo, c_hi, len(self.lengths))
        self._start = 0

    def shot(self, k):
        """The k-th shot handed over: (frames, convergence depth). Shots
        follow the mix's order round and round; each starts where the last
        ended in the pool."""
        t = self.lengths[k % len(self.lengths)]
        s = self._start
        self._start = (s + t) % self.pool_frames
        return self.pool[s:s + t], float(self.conv[k % len(self.lengths)])
