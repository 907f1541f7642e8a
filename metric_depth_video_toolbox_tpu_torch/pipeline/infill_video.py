"""Basic disocclusion infill over rendered SBS videos (PyTorch port of
``pipeline/infill_video.py``).

Input: the SBS video and its ``*_infillmask.mkv`` (normals encoded as RGB;
green = hole without normal data; black = keep). Output:
``<sbs>_infilled.mkv``. The ``basic`` engine is the normal-march infill
with a blur under the lower side of each disocclusion edge; the
``diffusion`` engine is the JAX package's default SVD-class
``DiffusionInfillEngine`` (``pipeline.infill_diffusion``).
"""

from __future__ import annotations

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.ops import infill as infill_ops
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def basic_infill_frame(sbs_u8, mask_rgb_u8):
    """SBS frames + infill-mask frames (B, H, W, 3) uint8 -> infilled
    frames (B, H, W, 3) uint8.

    Holes are the pixels whose mask is not black. The march runs on the
    normals ``mask * 2 - 1``, as in the JAX package: a green-coded pixel
    (0, 255, 0) arrives as (-1, 1, -1), which is not the march's green
    code (0, 1, 0), so it marches diagonally like any other. Then the halo
    blend (``ops.infill.halo_blend``): the background side of each edge is
    marked, dilated (5 x 5) and blended with its blur (7 x 7).
    """
    mask = mask_rgb_u8.to(torch.float32) / 255.0
    hole = torch.any(mask_rgb_u8 != 0, dim=-1)
    filled = infill_ops.normal_march_infill(sbs_u8, hole, mask * 2.0 - 1.0)
    return infill_ops.halo_blend(filled, mask_rgb_u8).to(torch.uint8)


def infill_sbs_video(sbs_video, infill_mask_video, output=None,
                     engine="basic", color_video=None, batch_size=4,
                     max_frames=-1, device=None):
    """Infill every frame of an SBS video on ``device`` (CUDA unless the
    caller asks for the CPU). Returns the output path. ``color_video`` is
    the diffusion engine's input; the basic engine does not read it."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    if engine == "diffusion":
        from metric_depth_video_toolbox_tpu_torch.pipeline import \
            infill_diffusion
        return infill_diffusion.infill_sbs_video_diffusion(
            sbs_video, infill_mask_video, output=output,
            color_video=color_video, max_frames=max_frames, device=device)
    if engine != "basic":
        raise ValueError(f"unknown infill engine {engine!r}")
    device = resolve_device(device)
    output = output or (sbs_video + "_infilled.mkv")
    sv = vio.PrefetchingBatchReader(sbs_video, batch_size,
                                    max_frames=max_frames)
    mv = vio.PrefetchingBatchReader(infill_mask_video, batch_size)
    writer = vio.AsyncVideoWriter(output, sv.fps, sv.width, sv.height)
    n = 0
    masks_done = False
    try:
        while True:
            frames = sv.read_batch()
            if frames is None:
                break
            # a short mask video leaves the rest unmasked
            masks = None if masks_done else mv.read_batch()
            masks_done = masks is None
            if masks is None:
                masks = np.zeros_like(frames)
            elif masks.shape[0] < frames.shape[0]:
                masks = np.pad(masks, ((0, frames.shape[0] - masks.shape[0]),
                                       (0, 0), (0, 0), (0, 0)))
            out = basic_infill_frame(
                torch.as_tensor(frames, device=device),
                torch.as_tensor(masks[:frames.shape[0]], device=device))
            for f in out.cpu().numpy():
                writer.write(f)
            n += frames.shape[0]
    finally:
        sv.close()
        mv.close()
    writer.commit(n)
    return output
