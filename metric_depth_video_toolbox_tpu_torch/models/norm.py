"""Inference-mode normalisation layers (PyTorch port of the JAX package's
``models/norm.py``: ``InstanceNorm`` and ``EvalBatchNorm``)."""

from __future__ import annotations

import torch
from torch import nn


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=False) over the spatial axes of an (N, C, H,
    W) tensor: ``(x - mean) * rsqrt(var + 1e-5)`` with the biased variance.
    The statistics are computed in float32 and cast to the input's dtype,
    the normalisation in the input's dtype (``x.mean`` / ``x.var`` of a
    bfloat16 array in JAX accumulate in float32 and return bfloat16)."""

    def forward(self, x):
        xf = x.to(torch.float32)
        var, mu = torch.var_mean(xf, dim=(-2, -1), keepdim=True,
                                 correction=0)
        return (x - mu.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + 1e-5)


class EvalBatchNorm(nn.Module):
    """BatchNorm2d in eval mode over axis 1 of an (N, C, ...) tensor:
    ``(x - mean) * rsqrt(var + 1e-5) * weight + bias``, computed in
    float32 and returned in the input's dtype. The
    running statistics are buffers named as the Flax leaves (``mean``,
    ``var``); ``weight`` is the Flax ``scale``."""

    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = (torch.rsqrt(self.var + 1e-5) * self.weight).reshape(shape)
        return ((x.to(torch.float32) - self.mean.reshape(shape)) * inv
                + self.bias.reshape(shape)).to(x.dtype)
