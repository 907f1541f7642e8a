"""DINOv2-style ViT backbone (PyTorch port of ``models/vit.py``).

Module and parameter names follow the Flax tree of the JAX package
(``patch_embed``, ``block{i}.attn.qkv``, ``ls1.gamma``, ...), so
``models.from_jax`` carries weights across by name. Parameters are
float32; the matmuls and convolutions run in ``cfg.compute_dtype`` and
the LayerNorms in float32, as in the JAX package. Images are NHWC and
tokens (B, N, D) at the public functions.

Attention is ``F.scaled_dot_product_attention`` by default (the JAX
package's default attention is XLA's, outside any Pallas kernel), or, with
``attention_impl="flash_packed"``, the packed-qkv kernel of
:mod:`..ops.attention_packed` for every attention of the ViT.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.ops import attention_packed

LN_EPS = 1e-6   # flax.linen.LayerNorm's default
ATTENTION_IMPLS = ("xla", "flash", "flash_packed")


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
    # The JAX package's values. "xla" (default) and "flash" (there the stock
    # Pallas flash kernel, not a kernel of this repository) are both
    # ``F.scaled_dot_product_attention``, which never materialises the
    # scores, so no sequence length needs a reroute. "flash_packed" sends
    # every attention, per-view and cross-view, through the packed-qkv
    # kernel, with the token axis padded once for the whole depth to
    # ``attention_packed.PAD_MULTIPLE``; on a CUDA device it launches the
    # kernel or raises (the JAX package's gates on the head count, the
    # head dim, the 512 multiple and the backend are the TPU compiler's and
    # are not carried over).
    attention_impl: str = "xla"
    # DA3-style cross-view self-attention: in the listed blocks attention
    # runs over the concatenated tokens of all views of a group (same
    # weights). The caller opts in per forward with ``view_group``.
    cross_view_indices: Sequence[int] = ()
    # None: matmuls in ``dtype``; "int8": the blocks' Dense layers (qkv,
    # proj, fc1, fc2) run dynamically quantized int8 matmuls
    # (:class:`QDense`). The parameters are the same either way.
    quant: str | None = None

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r}: "
                             f"expected one of {ATTENTION_IMPLS}")

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
    or a kernel that tiles the input), or ``padding`` on every side,
    computing in a given dtype."""

    def __init__(self, in_ch, out_ch, kernel, dtype, stride=1, bias=True,
                 padding=None):
        super().__init__(in_ch, out_ch, kernel, stride=stride, bias=bias)
        self.compute_dtype = dtype
        self.explicit_padding = padding

    def forward(self, x):
        dt = self.compute_dtype
        k = self.kernel_size[0]
        if self.explicit_padding is not None:
            pad = (self.explicit_padding,) * 4
        elif self.stride[0] == 1 and k > 1:
            lo = (k - 1) // 2
            pad = (lo, k - 1 - lo, lo, k - 1 - lo)
        else:
            pad = (0, 0, 0, 0)
        y = F.conv2d(F.pad(x.to(dt).permute(0, 3, 1, 2), pad),
                     self.weight.to(dt),
                     self.bias.to(dt) if self.bias is not None else None,
                     stride=self.stride)
        return y.permute(0, 2, 3, 1)


class QDense(Dense):
    """:class:`Dense` with the same parameters, whose product is the
    dynamically quantized int8 one of :func:`..ops.quant.int8_dense`."""

    def forward(self, x):
        from metric_depth_video_toolbox_tpu_torch.ops import quant
        return quant.int8_dense(x, self.weight, self.bias, self.compute_dtype)


def dense(cfg: ViTConfig, in_features, out_features):
    """A block's Dense layer: :class:`QDense` when ``cfg.quant`` is
    "int8", else :class:`Dense`."""
    cls = QDense if cfg.quant == "int8" else Dense
    return cls(in_features, out_features, cfg.compute_dtype)


def layer_norm(mod, x):
    """LayerNorm in float32 (flax ``nn.LayerNorm(dtype=float32)``)."""
    return F.layer_norm(x.to(torch.float32), mod.normalized_shape,
                        mod.weight, mod.bias, LN_EPS)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.qkv = dense(cfg, d, 3 * d)
        self.proj = dense(cfg, d, d)

    def forward(self, x, valid=None):
        """``valid``: optional (N,) bool marking the real tokens of a
        pre-padded sequence (shared by the batch); pad keys are left out
        of every softmax, pad queries give rows the caller slices off."""
        c = self.cfg
        b, n, d = x.shape
        hd = d // c.num_heads
        qkv = self.qkv(x)
        if c.attention_impl == "flash_packed":
            if valid is None:
                valid = torch.ones(n, dtype=torch.bool, device=x.device)
            out = attention_packed.packed_flash_attention(
                qkv.reshape(b, n, 3 * c.num_heads, hd), valid, c.num_heads,
                1.0 / float(hd) ** 0.5)
            return self.proj(out.reshape(b, n, d))
        # the heads of this block: all of them, or a tensor-parallel
        # rank's share (parallel.sharding.shard_params)
        heads = qkv.shape[-1] // (3 * hd)
        q, k, v = qkv.reshape(b, n, 3, heads, hd) \
            .permute(2, 0, 3, 1, 4).unbind(0)             # (B, H, N, hd)
        mask = None if valid is None else valid[None, None, None, :]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return self.proj(out.transpose(1, 2).reshape(b, n, heads * hd))


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.fc1 = dense(cfg, cfg.embed_dim, hidden)
        self.fc2 = dense(cfg, hidden, cfg.embed_dim)
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

    def forward(self, x, valid=None):
        x = x + self.ls1(self.attn(layer_norm(self.norm1, x), valid=valid))
        return x + self.ls2(self.mlp(layer_norm(self.norm2, x)))


class ViT(nn.Module):
    """images (B, H, W, 3) in [0, 1], H and W multiples of the patch ->
    (list of (B, gh, gw, D) normed features at cfg.out_indices, cls token
    (B, D) of the last block).

    ``cond``: optional (B, gh, gw, D) added to the patch tokens (camera-ray
    embeddings). ``view_group``: B is a stack of view groups of this size,
    and the blocks of ``cfg.cross_view_indices`` attend over the
    concatenated tokens of each whole group."""

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

    def forward(self, images, cond=None, view_group=None):
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
        if cond is not None:
            x = x + cond.reshape(b, gh * gw, c.embed_dim).to(x.dtype)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, -1), x], 1)
        x = x + self.pos_embed.to(x.dtype)

        # the packed kernel's route pads the token axis once for the whole
        # depth: pad rows are masked out of every attention as keys and
        # sliced off where features are taken; LayerNorm and the MLP run
        # on them too
        n_real = gh * gw + 1
        n_pad = (-n_real) % attention_packed.PAD_MULTIPLE \
            if c.attention_impl == "flash_packed" else 0
        valid = None
        if n_pad:
            x = F.pad(x, (0, 0, 0, n_pad))
            valid = torch.arange(n_real + n_pad, device=x.device) < n_real
        n_tok = n_real + n_pad
        vg = view_group if (view_group and view_group > 1) else None
        wanted = set(c.out_indices)
        stored = {}
        for i in range(c.depth):
            blk = getattr(self, f"block{i}")
            if vg and i in c.cross_view_indices:
                # cross-view: the group's sequences back to back, each
                # view's pads staying where they are (one run per view)
                xg = x.reshape(b // vg, vg * n_tok, c.embed_dim)
                x = blk(xg, valid=None if valid is None
                        else valid.repeat(vg)).reshape(b, n_tok, c.embed_dim)
            else:
                x = blk(x, valid=valid)
            if i in wanted:
                stored[i] = layer_norm(self.norm, x[:, :n_real]).to(dt)
        xn = layer_norm(self.norm, x[:, :n_real])
        feats = [stored[i][:, 1:].reshape(b, gh, gw, c.embed_dim)
                 for i in c.out_indices]
        return feats, xn[:, 0]


@torch.no_grad()
def seeded_init(module, generator, layerscale_init=1.0):
    """Draw a module's weights from ``generator`` with the JAX package's
    initializers: LeCun-normal matrices and kernels, zero biases and cls
    token, unit norm scales, N(0, 0.02) position embedding."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.ndim >= 2:
            fan_in = p[0].numel()
            p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
        elif leaf == "weight":
            p.fill_(1.0)
        elif leaf == "gamma":
            p.fill_(layerscale_init)
        elif leaf == "pos_embed":
            p.normal_(0.0, 0.02, generator=generator)
        else:
            p.zero_()
    return module


def _cubic_kernel(x, a=-0.75):
    x = np.abs(x)
    return np.where(x <= 1, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
                    np.where(x < 2, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x
                             - 4 * a, 0.0))


def _bicubic_mat(n_in, n_out):
    """(n_out, n_in) bicubic resampling matrix: half-pixel centers, edge
    clamped, a = -0.75 (``F.interpolate(mode="bicubic")``)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(src).astype(np.int64)
    m = np.zeros((n_out, n_in), np.float32)
    for off in (-1, 0, 1, 2):
        idx = base + off
        w = _cubic_kernel(src - idx)
        np.add.at(m, (np.arange(n_out), np.clip(idx, 0, n_in - 1)), w)
    return m


def interpolate_pos_embed(pos, grid_src, grid_dst):
    """Resample a (1, gh*gw+1, D) position embedding (numpy) to another
    patch grid: bicubic, the cls token passed through."""
    pos = np.asarray(pos, np.float32)
    cls_tok, patch = pos[:, :1], pos[:, 1:]
    (gh0, gw0), (gh1, gw1) = grid_src, grid_dst
    d = patch.shape[-1]
    grid = patch.reshape(gh0, gw0, d)
    grid = np.einsum("oh,hwd->owd", _bicubic_mat(gh0, gh1), grid)
    grid = np.einsum("ow,hwd->hod", _bicubic_mat(gw0, gw1), grid)
    return np.concatenate([cls_tok, grid.reshape(1, gh1 * gw1, d)], axis=1)
