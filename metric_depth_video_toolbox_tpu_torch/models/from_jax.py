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
``models.svd``, ``models.clip``; GeometryCrafter's point-map VAE is
``SVDVAEEncoder`` / ``SVDVAEDecoder``), ViT (its int8 ``QDense`` layers
hold a Dense's leaves), DPTHead (with PromptDA's ``prompt`` branches),
PromptDA, MVSNet, DPTHeadTemporal,
VideoDepthAnything, DepthAnything (with its ``ray_embed``, ``fov_fc``,
``fov_out``), DA3 (``backbone``, ``head.depth``, ``head.ray``,
``ray_embed``), MoGeNet, UniDepthNet and UniK3DNet (UniDepth's learned
camera ``queries`` as they are), DepthProNet, and Wan's WanDiT,
WanVAEEncoder and
WanVAEDecoder (RMSNorm ``scale`` and
FrameGroupNorm's ``gn.scale`` become ``weight`` like any norm scale),
U2Net (``models.segmentation``; its batch norms' running statistics are
buffers, which ``load_state_dict`` covers like parameters), and the
tracking, pose and flow models: CoTracker3 (its ``virtual_tracks`` as
they are), CoTrackerLite, RAFT (the context encoder's batch norms) and
DroidNet.
The tree's leaves are taken as numpy arrays (or tensors: a ``bfloat16``
leaf of ``io.checkpoint.load_checkpoint`` is one), so this module needs no
JAX.

A load is strict: every parameter and buffer of the module covered, every
leaf used. ``ignore_unused=True`` ignores the leaves the module has no
place for, as Flax ``apply`` does (a converted tree holds leaves that a
configuration does not use, e.g. the learned DPT resize layers without
``torch_resize``); a missing leaf or a wrong shape still raises.
"""

from __future__ import annotations

import math

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
                if torch.is_tensor(val):
                    val = val.to(torch.float32).numpy()
                arr = _leaf(key, np.asarray(val, dtype=np.float32),
                            prefix[-1] if prefix else None,
                            mods.get(".".join(prefix)))
                name = ".".join(prefix + (_RENAME.get(key, key),))
                out[name] = torch.from_numpy(np.array(arr, copy=True,
                                                      order="C"))
    walk(tree, ())
    return out


def load_flax_params(module, params, ignore_unused=False, ignored=None):
    """Load a Flax tree into ``module``; every parameter and buffer must
    be covered, and every leaf used unless ``ignore_unused``. The dotted
    names of the leaves ignored are appended to the list ``ignored``, if
    one is given. -> ``module``"""
    sd = flax_to_state_dict(params, module)
    if ignore_unused:
        want = module.state_dict().keys()
        unused = sorted(k for k in sd if k not in want)
        for k in unused:
            del sd[k]
        if ignored is not None:
            ignored.extend(unused)
    module.load_state_dict(sd, strict=True)
    return module


def is_state_dict(params):
    """A port state dict (``{dotted name: tensor}``), not a Flax tree."""
    return all(torch.is_tensor(v) for v in params.values())


def load_params(module, params, ignore_unused=False, ignored=None):
    """Load a port state dict (strictly), or a Flax tree as
    :func:`load_flax_params` does. -> ``module``"""
    if is_state_dict(params):
        module.load_state_dict(params, strict=True)
        return module
    return load_flax_params(module, params, ignore_unused, ignored)


def to_flax_params(module):
    """The inverse of :func:`flax_to_state_dict`: ``module``'s parameters
    and persistent buffers as a tree in the JAX package's Flax layout
    (float32 numpy leaves, without the outer ``params``), e.g. to write
    the port's weights as a converted checkpoint. A DenseGeneral kernel
    comes back as a Dense kernel (its head split is not in the module)."""
    tree = {}
    for path, mod in module.named_modules():
        named = list(mod.named_parameters(recurse=False)) + [
            (n, b) for n, b in mod.named_buffers(recurse=False)
            if n not in mod._non_persistent_buffers_set]
        for name, val in named:
            arr = val.detach().to(torch.float32).cpu().numpy()
            if name == "weight" and isinstance(mod,
                                               torch.nn.ConvTranspose2d):
                key = "kernel"
                arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
            elif name == "weight" and arr.ndim >= 2:
                key = "kernel"
                arr = arr.T if arr.ndim == 2 else arr.transpose(
                    *range(2, arr.ndim), 1, 0)
            elif name == "weight":
                key = "scale"
            else:
                key = name
            node = tree
            for part in path.split(".") if path else ():
                node = node.setdefault(part, {})
            node[key] = np.ascontiguousarray(arr)
    return tree


@torch.no_grad()
def flax_like_init(module, generator, normal=()):
    """Draw ``module``'s parameters from ``generator`` as a Flax ``init``
    of the same tree would (not the same draws): LeCun-normal kernels and
    matrices, zero biases, unit norm scales, N(0, 1) for the leaves named
    in ``normal``; buffers (batch-norm statistics) keep their values.
    -> ``module``"""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in normal:
            p.normal_(0.0, 1.0, generator=generator)
        elif leaf == "weight" and p.ndim >= 2:
            p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()),
                      generator=generator)
        elif leaf == "weight":
            p.fill_(1.0)
        else:
            p.zero_()
    return module
