"""Prompt-depth upscaler, PromptDA-class (PyTorch port of
``models/promptda.py``): a low-resolution metric depth and the full-resolution
colour frame -> full-resolution metric depth.

The prompt depth is min/max-normalized per item, every DPT fusion level adds
a conv branch over the normalized prompt at its own size
(``models.dpt.PromptLayer``), and the sigmoid head's output is mapped back
onto the prompt's metric range. Names follow the Flax tree (``backbone``,
``head.fusion2.prompt.conv1``, ...); converted checkpoints come from
``models.convert.convert_promptda_hf``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod


@dataclasses.dataclass(frozen=True)
class PromptDAConfig:
    vit: vit_mod.ViTConfig = vit_mod.VIT_L
    dpt: dpt_mod.DPTConfig = dataclasses.field(
        default_factory=lambda: dpt_mod.DPTConfig(head_act="sigmoid"))


PROMPT_TINY = PromptDAConfig(
    vit=vit_mod.VIT_TINY,
    dpt=dataclasses.replace(dpt_mod.DPT_TINY, head_act="sigmoid"))


class PromptDA(nn.Module):
    """images (B, H, W, 3) in [0, 1] at ``work_hw`` (multiples of the patch)
    and prompt depth (B, h, w), metric, at any size -> (B, H, W) metric
    depth in each prompt's range."""

    def __init__(self, cfg: PromptDAConfig, work_hw):
        super().__init__()
        self.cfg = cfg
        p = cfg.vit.patch_size
        self.backbone = vit_mod.ViT(cfg.vit, (work_hw[0] // p)
                                    * (work_hw[1] // p))
        self.head = dpt_mod.DPTHead(cfg.dpt, cfg.vit.embed_dim, p,
                                    prompt=True)

    def forward(self, images, prompt_depth):
        feats, _ = self.backbone(images)
        pd = prompt_depth[..., None].to(torch.float32)
        dmin = torch.amin(pd, dim=(1, 2, 3), keepdim=True)
        dmax = torch.amax(pd, dim=(1, 2, 3), keepdim=True)
        pd_norm = (pd - dmin) / torch.clamp(dmax - dmin, min=1e-6)
        out = self.head(feats, prompt=pd_norm)[..., 0].to(torch.float32)
        return out * (dmax - dmin)[..., 0] + dmin[..., 0]


def pad_to_multiple_of(x, multiple, axes=(1, 2)):
    """Pad the given axes at their end up to a multiple of ``multiple``,
    repeating the last entry (``jnp.pad(mode="edge")``)."""
    for d in axes:
        rem = (-x.shape[d]) % multiple
        if rem:
            edge = x.narrow(d, x.shape[d] - 1, 1)
            x = torch.cat([x, edge.expand(*[rem if i == d else -1
                                            for i in range(x.ndim)])], dim=d)
    return x
