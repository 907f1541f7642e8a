"""Mask stage: color video -> subject-mask video (PyTorch port of
``pipeline/masks.py``).

U²-Net runs on batches of frames on the device: each frame is resized to
a square working size (bilinear, antialiased when shrinking, as
``jax.image.resize``), segmented, and its probability map resized back to
the frame's size and thresholded. The output ``<video>_mask.mkv`` is a
0/255 grayscale video written as three equal channels.
"""

from __future__ import annotations

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.models import segmentation as seg
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.ops import image as im
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


class MaskEngine:
    """U²-Net subject masks. ``params``: a state dict of
    :class:`~..models.segmentation.U2Net` (e.g. from ``models.from_jax``);
    None draws seeded weights from a ``torch.Generator`` (``rng_seed``)."""

    def __init__(self, cfg=None, params=None, work=320, rng_seed=0,
                 threshold=0.5, device=None):
        self.cfg = cfg or seg.SEG_FULL
        self.work = work
        self.threshold = threshold
        self.device = resolve_device(device)
        model = seg.U2Net(self.cfg)
        if params is None:
            vit_mod.seeded_init(model, torch.Generator().manual_seed(rng_seed))
        else:
            model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def probabilities(self, frames_u8):
        """(B, H, W, 3) uint8 -> (B, H, W) float32 foreground probability
        on the engine's device, at the frames' size."""
        x = torch.as_tensor(np.asarray(frames_u8)).to(self.device)
        h, w = x.shape[1:3]
        x = im.resize(x.to(torch.float32) / 255.0, (self.work, self.work))
        p = self.model(x)
        return im.resize(p[..., None], (h, w))[..., 0]

    def masks_for(self, frames_u8):
        """(B, H, W, 3) uint8 -> (B, H, W) uint8 in {0, 255} (numpy)."""
        p = self.probabilities(frames_u8)
        return ((p > self.threshold).to(torch.uint8) * 255).cpu().numpy()


def generate_video_mask(color_video, output=None, batch_size=8,
                        engine=None, max_frames=-1, device=None):
    """Color video -> ``<video>_mask.mkv``; returns the output path."""
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    eng = engine or MaskEngine(device=device)
    output = output or (color_video + "_mask.mkv")
    reader = vio.VideoReader(color_video, max_frames=max_frames)
    writer = vio.VideoWriter(output, reader.fps, reader.width, reader.height)
    n = 0
    try:
        while True:
            batch = reader.read_batch(batch_size)
            if batch is None:
                break
            for m in eng.masks_for(batch):
                writer.write(np.stack([m, m, m], axis=-1))
            n += batch.shape[0]
    finally:
        reader.close()
    writer.commit(n)
    return output
