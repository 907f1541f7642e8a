"""Convergence-depth finder (PyTorch port of ``pipeline/convergence.py``):
per-frame mean depth of the subject.

Depth frames are decoded with ``average_rg=False``; with a mask video, the
pixels whose grey level (the mean of the three channels) is above 240
count, NaN where none does; a mask video shorter than the depth video is
padded with white frames (every pixel counts). Writes
``<depth_video>_convergence_depths.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.ops import codec
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def masked_mean_depth(depth, mask_weight):
    """(T, H, W) depth x (T, H, W) weights -> (T,) means; NaN where the
    weights sum to zero."""
    num = torch.sum(depth * mask_weight, dim=(-2, -1))
    den = torch.sum(mask_weight, dim=(-2, -1))
    return torch.where(den > 0, num / torch.clamp(den, min=1e-9),
                       torch.full_like(num, float("nan")))


def find_convergence_depths(depth_video, mask_video=None, max_depth=100.0,
                            batch_size=16, output=None, device=None):
    """Depth video (+ mask video) -> the JSON sidecar; returns its path."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    device = resolve_device(device)
    dv = vio.VideoReader(depth_video)
    mv = vio.VideoReader(mask_video) if mask_video else None
    out = []
    try:
        while True:
            rgb = dv.read_batch(batch_size)
            if rgb is None:
                break
            depth = codec.decode_depth_frame(
                torch.as_tensor(rgb, device=device), max_depth,
                average_rg=False)
            m = mv.read_batch(rgb.shape[0]) if mv is not None else None
            if m is None:
                weight = torch.ones_like(depth)
            else:
                gray = m.astype(np.float32).mean(-1)
                if m.shape[0] < rgb.shape[0]:
                    pad = np.full((rgb.shape[0] - m.shape[0],)
                                  + gray.shape[1:], 255.0, np.float32)
                    gray = np.concatenate([gray, pad], 0)
                weight = torch.as_tensor(gray > 240, device=device).to(
                    torch.float32)
            out.extend(masked_mean_depth(depth, weight).cpu().tolist())
    finally:
        dv.close()
        if mv is not None:
            mv.close()
    output = output or (depth_video + "_convergence_depths.json")
    sidecar.save_convergence_depths(output, np.asarray(out, np.float32))
    return output
