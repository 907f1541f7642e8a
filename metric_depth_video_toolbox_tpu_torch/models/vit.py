"""DINOv2-style ViT backbone (PyTorch port of ``models/vit.py``).

Module and parameter names follow the Flax tree of the JAX package
(``patch_embed``, ``block{i}.attn.qkv``, ``ls1.gamma``, ...), so
``models.from_jax`` carries weights across by name. Parameters are
float32; the matmuls and convolutions run in ``cfg.compute_dtype`` and
the LayerNorms in float32, as in the JAX package. Images are NHWC and
tokens (B, N, D) at the public functions.

Attention is ``F.scaled_dot_product_attention``: the JAX package's default
attention is XLA's, outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6   # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    layerscale_init: float = 1.0
    out_indices: Sequence[int] = (2, 5, 8, 11)
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


VIT_S = ViTConfig(embed_dim=384, depth=12, num_heads=6,
                  out_indices=(2, 5, 8, 11))
VIT_B = ViTConfig(embed_dim=768, depth=12, num_heads=12,
                  out_indices=(2, 5, 8, 11))
VIT_L = ViTConfig(embed_dim=1024, depth=24, num_heads=16,
                  out_indices=(4, 11, 17, 23))
VIT_G = ViTConfig(embed_dim=1536, depth=40, num_heads=24,
                  out_indices=(9, 19, 29, 39))
VIT_TINY = ViTConfig(embed_dim=64, depth=4, num_heads=4,
                     out_indices=(0, 1, 2, 3))

PRESETS = {"vits": VIT_S, "vitb": VIT_B, "vitl": VIT_L, "vitg": VIT_G,
           "vitt": VIT_TINY}


class Dense(nn.Linear):
    """``nn.Linear`` computing in a given dtype (flax ``nn.Dense(dtype=)``:
    input, weight and bias cast before the product)."""

    def __init__(self, in_features, out_features, dtype, bias=True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Conv2d):
    """NHWC convolution with flax ``nn.Conv``'s 'SAME' padding (stride 1
    or a kernel that tiles the input), computing in a given dtype."""

    def __init__(self, in_ch, out_ch, kernel, dtype, stride=1, bias=True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        k = self.kernel_size[0]
        if self.stride[0] == 1 and k > 1:
            lo = (k - 1) // 2
            pad = (lo, k - 1 - lo, lo, k - 1 - lo)
        else:
            pad = (0, 0, 0, 0)
        y = F.conv2d(F.pad(x.to(dt).permute(0, 3, 1, 2), pad),
                     self.weight.to(dt),
                     self.bias.to(dt) if self.bias is not None else None,
                     stride=self.stride)
        return y.permute(0, 2, 3, 1)


def layer_norm(mod, x):
    """LayerNorm in float32 (flax ``nn.LayerNorm(dtype=float32)``)."""
    return F.layer_norm(x.to(torch.float32), mod.normalized_shape,
                        mod.weight, mod.bias, LN_EPS)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.qkv = Dense(d, 3 * d, cfg.compute_dtype)
        self.proj = Dense(d, d, cfg.compute_dtype)

    def forward(self, x):
        c = self.cfg
        b, n, d = x.shape
        hd = d // c.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, c.num_heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)    # (B, H, N, hd)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = Dense(cfg.embed_dim, hidden, cfg.compute_dtype)
        self.fc2 = Dense(hidden, cfg.embed_dim, cfg.compute_dtype)
        # erf GELU in float32; the tanh form in bfloat16, where its error
        # sits below bfloat16 rounding (the JAX package's choice)
        self.approximate = "tanh" if cfg.dtype == "bfloat16" else "none"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class LayerScale(nn.Module):
    def __init__(self, dim, init=1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = Attention(cfg)
        self.ls1 = LayerScale(d, cfg.layerscale_init)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = Mlp(cfg)
        self.ls2 = LayerScale(d, cfg.layerscale_init)

    def forward(self, x):
        x = x + self.ls1(self.attn(layer_norm(self.norm1, x)))
        return x + self.ls2(self.mlp(layer_norm(self.norm2, x)))


class ViT(nn.Module):
    """images (B, H, W, 3) in [0, 1], H and W multiples of the patch ->
    (list of (B, gh, gw, D) normed features at cfg.out_indices, cls token
    (B, D) of the last block)."""

    def __init__(self, cfg: ViTConfig, num_patches: int = 1):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        p = cfg.patch_size
        self.patch_embed = Conv(3, d, p, cfg.compute_dtype, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, d))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", Block(cfg))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, images):
        c = self.cfg
        dt = c.compute_dtype
        b, h, w, _ = images.shape
        gh, gw = h // c.patch_size, w // c.patch_size
        if self.pos_embed.shape[1] != gh * gw + 1:
            raise ValueError(f"pos_embed holds {self.pos_embed.shape[1] - 1}"
                             f" patches, the images {gh}x{gw}")
        mean = torch.tensor([0.485, 0.456, 0.406], dtype=dt,
                            device=images.device)
        std = torch.tensor([0.229, 0.224, 0.225], dtype=dt,
                           device=images.device)
        x = (images.to(dt) - mean) / std
        x = self.patch_embed(x).reshape(b, gh * gw, c.embed_dim)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, -1), x], 1)
        x = x + self.pos_embed.to(x.dtype)
        wanted = set(c.out_indices)
        stored = {}
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x)
            if i in wanted:
                stored[i] = layer_norm(self.norm, x).to(dt)
        xn = layer_norm(self.norm, x)
        feats = [stored[i][:, 1:].reshape(b, gh, gw, c.embed_dim)
                 for i in c.out_indices]
        return feats, xn[:, 0]
