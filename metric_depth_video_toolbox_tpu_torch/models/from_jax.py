"""Carry a Flax parameter tree of the JAX package into the port.

The port's modules are named after the Flax tree (``backbone.block0.attn
.qkv``, ``head.fusion2.rcu1.conv1``, ...), so the mapping is by name, with
the layout changes of each leaf:

  Dense  ``kernel`` (in, out)      -> ``weight`` (out, in)
  Conv   ``kernel`` (H, W, I, O)   -> ``weight`` (O, I, H, W)
  Conv3D ``kernel`` (T, H, W, I, O) -> ``weight`` (O, I, T, H, W)
  LayerNorm / GroupNorm / EvalBatchNorm ``scale`` -> ``weight``
  EvalBatchNorm ``mean`` / ``var`` -> the buffers of the same names
  ``bias``, LayerScale ``gamma``, ``cls_token``, ``pos_embed``, and Wan's
  ``modulation``, ``head_modulation``, ``prompt_tokens`` as they are.

Covers ViT, DPTHead, DPTHeadTemporal, VideoDepthAnything, DepthAnything,
DA3 (``backbone``, ``head.depth``, ``head.ray``, ``ray_embed``), and Wan's
WanDiT, WanVAEEncoder and WanVAEDecoder (RMSNorm ``scale`` and
FrameGroupNorm's ``gn.scale`` become ``weight`` like any norm scale), and
U2Net (``models.segmentation``; its batch norms' running statistics are
buffers, which ``load_state_dict`` covers like parameters).
The tree's leaves are taken as numpy arrays, so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_RENAME = {"kernel": "weight", "scale": "weight"}


def _leaf(name, arr):
    if name == "kernel":
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:
            return arr.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"kernel of unexpected rank {arr.ndim}")
    return arr


def flax_to_state_dict(params):
    """Flax param tree (``{"params": ...}`` or its inside; leaves array-
    like) -> ``{dotted name: float32 tensor}``."""
    tree = params["params"] if "params" in params else params
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if hasattr(val, "items"):
                walk(val, prefix + (key,))
            else:
                arr = _leaf(key, np.asarray(val, dtype=np.float32))
                name = ".".join(prefix + (_RENAME.get(key, key),))
                out[name] = torch.from_numpy(np.array(arr, copy=True,
                                                      order="C"))
    walk(tree, ())
    return out


def load_flax_params(module, params):
    """Load a Flax tree into ``module``; every parameter and buffer must
    be covered and every leaf used."""
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module
