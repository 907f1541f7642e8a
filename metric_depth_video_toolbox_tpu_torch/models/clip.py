"""CLIP vision tower (PyTorch port of ``models/clip.py``): the image
conditioning of the SVD / StereoCrafter graph, which cross-attends to the
projected embedding of the conditioning frame.

The layout of transformers' ``CLIPVisionModelWithProjection`` (pre-norm
ViT, class token, learned positions, projection), with module and parameter
names of the JAX package's Flax tree (``patch_embedding``,
``layer{i}.q_proj``, ``class_embedding``, ``position_embedding``, ...), so
``models.from_jax`` carries weights across by name. Attention is
``F.scaled_dot_product_attention`` (the JAX package's is an einsum softmax,
outside any Pallas kernel).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models.diffusion import LayerNorm
from metric_depth_video_toolbox_tpu_torch.models.vit import Dense
from metric_depth_video_toolbox_tpu_torch.ops import image as im


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280        # ViT-H/14 (SVD's image encoder)
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    hidden_act: str = "gelu"       # exact gelu; "quick_gelu" for OpenAI's
    dtype: str = "float32"

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


CLIP_VIT_H = CLIPVisionConfig()
CLIP_TINY = CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                             num_layers=2, num_heads=2, image_size=32,
                             patch_size=8, projection_dim=16)

# OpenAI's normalisation
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _act(name, x):
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


class CLIPLayer(nn.Module):
    def __init__(self, d, heads, mlp_dim, act, dtype):
        super().__init__()
        self.heads, self.act, self.dtype = heads, act, dtype
        self.layer_norm1 = LayerNorm(d)
        self.q_proj = Dense(d, d, dtype)
        self.k_proj = Dense(d, d, dtype)
        self.v_proj = Dense(d, d, dtype)
        self.out_proj = Dense(d, d, dtype)
        self.layer_norm2 = LayerNorm(d)
        self.fc1 = Dense(d, mlp_dim, dtype)
        self.fc2 = Dense(mlp_dim, d, dtype)

    def forward(self, x):
        b, s, d = x.shape
        h = self.layer_norm1(x).to(self.dtype)

        def heads(t):
            return t.reshape(b, s, self.heads, -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(
            heads(self.q_proj(h)), heads(self.k_proj(h)),
            heads(self.v_proj(h)))
        x = x + self.out_proj(o.transpose(1, 2).reshape(b, s, d))
        h = self.layer_norm2(x).to(self.dtype)
        return x + self.fc2(_act(self.act, self.fc1(h)))


class CLIPVisionTower(nn.Module):
    """(B, S, S, 3) CLIP-normalised images -> (B, projection_dim) image
    embeddings (the SVD UNet's cross-attention context is
    ``embeds[:, None]``)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIP_VIT_H):
        super().__init__()
        self.cfg = cfg
        d, dt, p = cfg.hidden_size, cfg.compute_dtype, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Parameter(
            torch.zeros((cfg.image_size // p) ** 2 + 1, d))
        self.pre_layernorm = LayerNorm(d)
        for i in range(cfg.num_layers):
            setattr(self, f"layer{i}", CLIPLayer(
                d, cfg.num_heads, cfg.intermediate_size, cfg.hidden_act, dt))
        self.post_layernorm = LayerNorm(d)
        self.visual_projection = Dense(d, cfg.projection_dim, torch.float32,
                                       bias=False)

    def forward(self, x):
        cfg = self.cfg
        dt = cfg.compute_dtype
        b, d = x.shape[0], cfg.hidden_size
        h = F.conv2d(x.permute(0, 3, 1, 2).to(dt),
                     self.patch_embedding.weight.to(dt),
                     stride=cfg.patch_size).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(dt).expand(b, 1, d)
        h = torch.cat([cls, h], dim=1) + self.position_embedding.to(dt)[None]
        h = self.pre_layernorm(h).to(dt)
        for i in range(cfg.num_layers):
            h = getattr(self, f"layer{i}")(h)
        return self.visual_projection(self.post_layernorm(h[:, 0]))


def preprocess(frames_01, image_size=224):
    """(B, H, W, 3) in [0, 1] -> CLIP-normalised (B, S, S, 3): bilinear
    resize (antialiased when shrinking), OpenAI mean and std."""
    x = im.resize(frames_01.float(), (image_size, image_size))
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std
