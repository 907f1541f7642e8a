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
  MultiHeadDotProductAttention's DenseGeneral ``query`` / ``key`` /
  ``value`` ``kernel`` (C, heads, hd) -> ``weight`` (heads*hd, C), ``out``
  ``kernel`` (heads, hd, C) -> ``weight`` (C, heads*hd), their (heads, hd)
  biases flattened.
  ConvTranspose ``kernel`` (H, W, I, O) (flax's ``transpose_kernel=False``)
  -> ``ConvTranspose2d.weight`` (I, O, H, W) flipped in H and W. Its rank
  is a Conv kernel's, so this mapping needs the torch module: pass it
  (``load_flax_params`` does), or a ConvTranspose is read as a Conv.
  AlphaBlender ``mix_factor`` (a scalar), CLIP's ``class_embedding`` and
  ``position_embedding`` as they are.

Covers the SVD-class diffusion models (``models.diffusion``,
``models.svd``, ``models.clip``), ViT, DPTHead, DPTHeadTemporal,
VideoDepthAnything, DepthAnything, DA3 (``backbone``, ``head.depth``,
``head.ray``, ``ray_embed``), and Wan's WanDiT, WanVAEEncoder and
WanVAEDecoder (RMSNorm ``scale`` and
FrameGroupNorm's ``gn.scale`` become ``weight`` like any norm scale), and
U2Net (``models.segmentation``; its batch norms' running statistics are
buffers, which ``load_state_dict`` covers like parameters).
The tree's leaves are taken as numpy arrays, so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_RENAME = {"kernel": "weight", "scale": "weight"}


def _leaf(name, arr, parent, module):
    if name == "kernel":
        if isinstance(module, torch.nn.ConvTranspose2d):
            return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        if arr.ndim == 3:   # DenseGeneral of MultiHeadDotProductAttention
            if parent == "out":
                return arr.reshape(-1, arr.shape[-1]).T
            return arr.reshape(arr.shape[0], -1).T
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:
            return arr.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"kernel of unexpected rank {arr.ndim}")
    if name == "bias" and arr.ndim == 2:   # DenseGeneral (heads, hd)
        return arr.reshape(-1)
    return arr


def flax_to_state_dict(params, module=None):
    """Flax param tree (``{"params": ...}`` or its inside; leaves array-
    like) -> ``{dotted name: float32 tensor}``. ``module``: the torch module
    the tree is for, which tells a ConvTranspose from a Conv."""
    tree = params["params"] if "params" in params else params
    mods = dict(module.named_modules()) if module is not None else {}
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if hasattr(val, "items"):
                walk(val, prefix + (key,))
            else:
                arr = _leaf(key, np.asarray(val, dtype=np.float32),
                            prefix[-1] if prefix else None,
                            mods.get(".".join(prefix)))
                name = ".".join(prefix + (_RENAME.get(key, key),))
                out[name] = torch.from_numpy(np.array(arr, copy=True,
                                                      order="C"))
    walk(tree, ())
    return out


def load_flax_params(module, params):
    """Load a Flax tree into ``module``; every parameter and buffer must
    be covered and every leaf used."""
    module.load_state_dict(flax_to_state_dict(params, module), strict=True)
    return module
