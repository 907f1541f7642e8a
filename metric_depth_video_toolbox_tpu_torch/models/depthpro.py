"""DepthPro: multi-scale patch-encoder metric depth with a FOV head
(PyTorch port of ``models/depthpro.py``, the op order of HF
``DepthProForDepthEstimation``; weights by
``models.convert.convert_depthpro_hf``).

- The input is scaled to 3 ratios (0.25 / 0.5 / 1) and split into
  overlapping ``vit_image_size`` patches (1 + 9 + 25 = 35 at 1536 px); all
  patches of all scales run through one DINOv2 tower as one batch.
- Patch features are merged back into per-scale maps (overlap trimmed);
  two intermediate depths of the tower are hooked for the fine levels.
- A second tower encodes the whole image at the tower's size; a fusion
  pyramid with deconvolutions decodes canonical inverse depth at the
  input resolution.
- A third tower and a conv head regress the field of view (degrees).

The towers run in ``cfg.vit``'s dtype; the neck, the fusion, the heads run
in float32 (the JAX package's convolutions take the float32 parameters'
type). Resizes are bilinear with half-pixel centers and no antialias, as
torch's ``F.interpolate``. NHWC at the public functions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.models.dpt import ConvTranspose
from metric_depth_video_toolbox_tpu_torch.models.vit import (Conv, Dense,
                                                              ViTConfig)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DepthProConfig:
    # one DINOv2 configuration for the patch, image and FOV towers
    vit: ViTConfig = dataclasses.field(
        default_factory=lambda: dataclasses.replace(
            vit_mod.VIT_L, patch_size=16))
    vit_image_size: int = 384      # the towers' image size = patch size
    scaled_images_ratios: Sequence[float] = (0.25, 0.5, 1.0)
    scaled_images_overlap_ratios: Sequence[float] = (0.0, 0.5, 0.25)
    scaled_images_feature_dims: Sequence[int] = (1024, 1024, 512)
    intermediate_hook_ids: Sequence[int] = (11, 5)
    intermediate_feature_dims: Sequence[int] = (256, 256)
    fusion_hidden_size: int = 256
    merge_padding_value: int = 3
    num_fov_head_layers: int = 2
    use_fov: bool = True

    @property
    def out_size(self):
        return self.vit_image_size // self.vit.patch_size


DEPTHPRO_L = DepthProConfig()  # apple/DepthPro-hf (1536 px)

DEPTHPRO_TINY = DepthProConfig(
    vit=ViTConfig(patch_size=8, embed_dim=32, depth=4, num_heads=2,
                  dtype="float32", attention_impl="xla"),
    vit_image_size=32,
    scaled_images_feature_dims=(16, 16, 16),
    intermediate_hook_ids=(3, 1),
    intermediate_feature_dims=(16, 16),
    fusion_hidden_size=16,
)


def resize(x, hw):
    """NHWC bilinear resize, half-pixel centers, no antialias (torch
    ``F.interpolate(mode="bilinear", align_corners=False)``), in float32
    and cast back."""
    if tuple(hw) == tuple(x.shape[1:3]):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).to(F32), size=tuple(hw),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _split_patches(x, ps, overlap):
    """All (ps, ps) windows at stride int(ps (1 - overlap)), patch-major
    over the batch (the patch index varies slowest)."""
    _, h, w, _ = x.shape
    if h == ps and w == ps:
        return x
    stride = int(ps * (1 - overlap))
    return torch.cat([x[:, top:top + ps, left:left + ps, :]
                      for top in range(0, h - ps + 1, stride)
                      for left in range(0, w - ps + 1, stride)], dim=0)


def _merge_patches(x, batch, padding):
    """Tile patch-major patches back into one map, trimming ``padding``
    from the interior edges (the overlaps)."""
    n, s, _, _ = x.shape
    if n == batch:
        return x
    side = int((n // batch) ** 0.5)
    if n // batch < 4:
        padding = 0
    padding = min(s // 4, padding)
    rows = []
    i = 0
    for hh in range(side):
        cols = []
        for ww in range(side):
            box = x[batch * i: batch * (i + 1)]
            top = padding if hh != 0 else 0
            bot = padding if hh != side - 1 else 0
            left = padding if ww != 0 else 0
            right = padding if ww != side - 1 else 0
            cols.append(box[:, top: s - bot, left: s - right, :])
            i += 1
        rows.append(torch.cat(cols, dim=2))
    return torch.cat(rows, dim=1)


def _reconstruct(tokens, batch, padding, out_hw):
    """Drop the cls token, grid the patch tokens, merge the patches and
    resize to ``out_hw`` (an identity at the production working point)."""
    n, seq, d = tokens.shape
    side = int(seq ** 0.5)
    x = tokens[:, -(side * side):, :].reshape(n, side, side, d)
    return resize(_merge_patches(x, batch, padding), out_hw)


class DinoTokens(nn.Module):
    """A DINOv2 tower on pre-normalized pixels -> (final-norm tokens, cls
    first, float32; the raw (un-normed) tokens after the blocks of
    ``hooks``)."""

    def __init__(self, cfg: ViTConfig, hooks=(), num_patches=1):
        super().__init__()
        self.cfg = cfg
        self.hooks = tuple(hooks)
        d, p = cfg.embed_dim, cfg.patch_size
        self.patch_embed = Conv(3, d, p, cfg.compute_dtype, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + 1, d))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", vit_mod.Block(cfg))
        self.norm = nn.LayerNorm(d, eps=vit_mod.LN_EPS)

    def forward(self, x):
        c = self.cfg
        b, h, w, _ = x.shape
        gh, gw = h // c.patch_size, w // c.patch_size
        x = self.patch_embed(x).reshape(b, gh * gw, c.embed_dim)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, -1), x], 1)
        x = x + self.pos_embed.to(x.dtype)
        raw = {}
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x)
            if i in self.hooks:
                raw[i] = x
        return vit_mod.layer_norm(self.norm, x), [raw[i] for i in self.hooks]


class DepthProNet(nn.Module):
    """(B, S, S, 3) pixels normalized as the HF processor does (mean = std
    = 0.5), S a power-of-two multiple of ``out_size`` with min(ratios) S >=
    ``vit_image_size`` -> (canonical inverse depth (B, S, S), FOV in
    degrees (B,) or None)."""

    def __init__(self, cfg: DepthProConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        d, fh = c.vit.embed_dim, c.fusion_hidden_size
        n = c.out_size ** 2
        sdims, idims = c.scaled_images_feature_dims, \
            c.intermediate_feature_dims
        self.patch_encoder = DinoTokens(c.vit, c.intermediate_hook_ids, n)
        self.image_encoder = DinoTokens(c.vit, (), n)
        self.upsample_image = ConvTranspose(d, 2, F32, out_ch=sdims[0])
        for i, dim in enumerate(sdims):
            self.add_module(f"upsample_scaled{i}_proj",
                            Conv(d, dim, 1, F32, bias=False))
            self.add_module(f"upsample_scaled{i}_up0",
                            ConvTranspose(dim, 2, F32, bias=False))
        for i, dim in enumerate(idims):
            ch = fh if i == 0 else dim
            self.add_module(f"upsample_inter{i}_proj",
                            Conv(d, ch, 1, F32, bias=False))
            for j in range(2 + i):
                self.add_module(f"upsample_inter{i}_up{j}", ConvTranspose(
                    ch if j == 0 else dim, 2, F32, out_ch=dim, bias=False))
        self.fuse_low = Conv(2 * sdims[0], sdims[0], 1, F32)
        dims = list(sdims) + list(idims)
        self.n_levels = len(dims)
        for i, dim in enumerate(dims):
            if not (i == len(dims) - 1 and dim == fh):
                self.add_module(f"project{i}",
                                Conv(dim, fh, 3, F32, bias=False, padding=1))
        for i in range(len(dims)):
            nm = f"fusion{i}"
            for r in (("_rcu1",) if i else ()) + ("_rcu2",):
                for k in ("_conv1", "_conv2"):
                    self.add_module(nm + r + k, Conv(fh, fh, 3, F32,
                                                     padding=1))
            if i < len(dims) - 1:
                self.add_module(nm + "_deconv",
                                ConvTranspose(fh, 2, F32, bias=False))
            self.add_module(nm + "_project", Conv(fh, fh, 1, F32))
        self.head_conv1 = Conv(fh, fh // 2, 3, F32, padding=1)
        self.head_deconv = ConvTranspose(fh // 2, 2, F32)
        self.head_conv2 = Conv(fh // 2, 32, 3, F32, padding=1)
        self.head_conv3 = Conv(32, 1, 1, F32)
        if c.use_fov:
            self.fov_encoder = DinoTokens(c.vit, (), n)
            self.fov_neck = Dense(d, fh // 2, F32)
            self.fov_conv = Conv(fh, fh // 2, 3, F32, stride=2, padding=1)
            ch = fh // 2
            for i in range(c.num_fov_head_layers):
                out = math.ceil(fh / 2 ** (i + 2))
                self.add_module(f"fov_head{i}",
                                Conv(ch, out, 3, F32, stride=2, padding=1))
                ch = out
            fk = int((c.out_size - 1) / 2 ** c.num_fov_head_layers + 1)
            self.fov_head_final = Conv(ch, 1, fk, F32, padding=0)

    def _rcu(self, x, name):
        y = getattr(self, name + "_conv1")(torch.relu(x))
        return x + getattr(self, name + "_conv2")(torch.relu(y))

    def forward(self, pixel):
        c = self.cfg
        b, h, w, _ = pixel.shape
        ex = int(math.log2(w / c.out_size))
        base_hw = (h // 2 ** ex, w // 2 ** ex)
        n_sc = len(c.scaled_images_ratios)

        # the patch tower: every patch of every scale in one batch, the
        # high-resolution patches first
        patches, counts = [], []
        for r, ov in zip(c.scaled_images_ratios,
                         c.scaled_images_overlap_ratios):
            s = pixel if r == 1.0 else resize(pixel,
                                               (int(h * r), int(w * r)))
            pt = _split_patches(s, c.vit_image_size, ov)
            patches.append(pt)
            counts.append(pt.shape[0])
        tokens, raws = self.patch_encoder(torch.cat(patches[::-1], dim=0))
        splits = [int(v) for v in np.cumsum(counts[::-1])[:-1]]
        per_scale = torch.tensor_split(tokens, splits, dim=0)[::-1]
        feats = [_reconstruct(tk, b, int(c.merge_padding_value
                                         * (1 / c.scaled_images_ratios[i])),
                              (base_hw[0] * 2 ** i, base_hw[1] * 2 ** i))
                 for i, tk in enumerate(per_scale)]
        ipad = int(c.merge_padding_value / c.scaled_images_ratios[-1])
        ihw = (base_hw[0] * 2 ** (n_sc - 1), base_hw[1] * 2 ** (n_sc - 1))
        inter = [_reconstruct(tk, b, ipad, ihw) for tk in raws]

        # the image tower on the whole image at the tower's size
        img = resize(pixel, (c.vit_image_size, c.vit_image_size))
        itokens, _ = self.image_encoder(img)
        image_feat = _reconstruct(itokens, b, 0, base_hw)

        # the neck
        ups = [self.upsample_image(image_feat)]
        for i in range(n_sc):
            x = getattr(self, f"upsample_scaled{i}_proj")(feats[i])
            ups.append(getattr(self, f"upsample_scaled{i}_up0")(x))
        for i in range(len(c.intermediate_feature_dims)):
            x = getattr(self, f"upsample_inter{i}_proj")(inter[i])
            for j in range(2 + i):
                x = getattr(self, f"upsample_inter{i}_up{j}")(x)
            ups.append(x)
        glob = self.fuse_low(torch.cat([ups[1], ups[0]], dim=-1))
        levels = [glob] + ups[2:]
        proj = [getattr(self, f"project{i}")(f)
                if hasattr(self, f"project{i}") else f
                for i, f in enumerate(levels)]

        # the fusion pyramid, global level first
        fused = None
        for i in range(len(proj)):
            nm = f"fusion{i}"
            fused = (proj[0] if fused is None
                     else fused + self._rcu(proj[i], nm + "_rcu1"))
            fused = self._rcu(fused, nm + "_rcu2")
            if i < len(proj) - 1:
                fused = getattr(self, nm + "_deconv")(fused)
            fused = getattr(self, nm + "_project")(fused)

        x = self.head_deconv(self.head_conv1(fused))
        x = self.head_conv3(torch.relu(self.head_conv2(x)))
        depth = torch.relu(x)[..., 0]
        if not c.use_fov:
            return depth, None

        # the FOV tower and its strided global features
        ftok, _ = self.fov_encoder(img)
        ffeat = _reconstruct(self.fov_neck(ftok), b, 0, base_hw)
        g = torch.relu(self.fov_conv(proj[0]))
        x = resize(ffeat + g, (c.out_size, c.out_size))
        for i in range(c.num_fov_head_layers):
            x = torch.relu(getattr(self, f"fov_head{i}")(x))
        return depth, self.fov_head_final(x).reshape(b)


def working_size(cfg, target=None):
    """The square inference size: a power-of-two multiple of ``out_size``
    with min(ratio) x size >= ``vit_image_size`` (1536 for
    apple/DepthPro-hf)."""
    min_r = min(cfg.scaled_images_ratios)
    size = cfg.out_size
    while size * min_r < cfg.vit_image_size or (target and size < target):
        size *= 2
    return size
