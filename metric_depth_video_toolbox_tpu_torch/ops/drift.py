"""Drift correction of generated video (PyTorch port of ``ops/drift.py``).

The InSpatio-class infill engine corrects low-frequency spatial drift of
generated frames against their render conditioning: a grid of
phase-correlation shifts per frame, MAD outlier rejection with median fill,
a temporal average of the grids, then a remap. Every step is batched over
frames; the remap is ``image.bilinear_sample``.
"""

from __future__ import annotations

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.ops import image as im


def _gray(x):
    return (x[..., 0] * 0.299 + x[..., 1] * 0.587
            + x[..., 2] * 0.114).float()


def phase_correlation_grid(ref_u8, gen_u8, grid=4):
    """Per-cell (grid x grid) translation of gen relative to ref.

    ref_u8, gen_u8: (..., H, W, 3). Returns shifts (..., grid, grid, 2)
    [dx, dy] and the response peak (..., grid, grid)."""
    h, w = ref_u8.shape[-3:-1]
    ch, cw = h // grid, w // grid
    lead = ref_u8.shape[:-3]

    def cells(x):
        x = _gray(x.float())[..., :grid * ch, :grid * cw]
        x = x.reshape(lead + (grid, ch, grid, cw))
        return x.transpose(-3, -2)          # (..., g, g, ch, cw)
    win = torch.from_numpy(np.outer(np.hanning(ch), np.hanning(cw))
                           .astype(np.float32)).to(ref_u8.device)
    fa = torch.fft.rfft2(cells(ref_u8) * win)
    fb = torch.fft.rfft2(cells(gen_u8) * win)
    cross = fa * torch.conj(fb)
    cross = cross / (torch.abs(cross) + 1e-9)
    corr = torch.fft.irfft2(cross, s=(ch, cw))
    flat = corr.reshape(lead + (grid, grid, ch * cw))
    peak, idx = torch.max(flat, dim=-1)
    dy = idx // cw
    dx = idx % cw
    # wrap-around to signed shifts
    dy = torch.where(dy > ch // 2, dy - ch, dy).float()
    dx = torch.where(dx > cw // 2, dx - cw, dx).float()
    return torch.stack([dx, dy], dim=-1), peak


def robust_flow_field(shifts, strength, mad_k=3.0):
    """MAD outlier rejection + median fill over the shift grid (...,
    g, g, 2) of each frame."""
    lead = shifts.shape[:-3]
    flat = shifts.reshape(lead + (-1, 2))
    med = torch.quantile(flat, 0.5, dim=-2)                 # (..., 2)
    mad = torch.quantile(torch.abs(flat - med[..., None, :]), 0.5,
                         dim=-2) + 1e-6
    med_g = med[..., None, None, :]
    ok = (torch.all(torch.abs(shifts - med_g) < mad_k * mad[..., None,
                                                             None, :],
                    dim=-1) & (strength > 0.0))
    return torch.where(ok[..., None], shifts, med_g), ok


def _remap(gen_u8, flow_grid, strength_scale=1.0):
    """Upsample (..., g, g, 2) flow grids to dense flow and sample each
    generated frame at x - shift (round, clip, uint8)."""
    h, w = gen_u8.shape[-3:-1]
    dense = im.resize(flow_grid, (h, w)) * strength_scale
    ys = torch.arange(h, dtype=torch.float32, device=gen_u8.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=gen_u8.device)[None, :]
    xy = torch.stack([xs - dense[..., 0], ys - dense[..., 1]], dim=-1)
    out = im.bilinear_sample(gen_u8.float(), xy)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def drift_correct_frame(gen_u8, ref_u8, grid=4, strength_scale=1.0):
    """Correct generated frames (..., H, W, 3) toward their references with
    each frame's own smoothed flow grid."""
    shifts, peak = phase_correlation_grid(ref_u8, gen_u8, grid=grid)
    flow_grid, _ = robust_flow_field(shifts, peak)
    return _remap(gen_u8, flow_grid, strength_scale)


def drift_correct_video(gen_frames_u8, ref_frames_u8, grid=4,
                        temporal_avg=3):
    """Drift correction over a clip: the flow grids are averaged over a
    window of ``temporal_avg`` frames before the remap. Takes and returns
    (T, H, W, 3) uint8 numpy arrays or tensors; tensors stay on their
    device."""
    as_numpy = isinstance(gen_frames_u8, np.ndarray)
    gen = torch.as_tensor(gen_frames_u8)
    ref = torch.as_tensor(ref_frames_u8, device=gen.device)
    shifts, peak = phase_correlation_grid(ref, gen, grid=grid)
    grids, _ = robust_flow_field(shifts, peak)
    t = gen.shape[0]
    half = temporal_avg // 2
    avg = torch.stack([grids[max(0, fi - half):min(t, fi + half + 1)]
                       .mean(dim=0) for fi in range(t)])
    out = _remap(gen, avg)
    return out.cpu().numpy() if as_numpy else out
