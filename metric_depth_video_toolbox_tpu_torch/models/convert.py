"""Checkpoint conversion: upstream torch state dicts -> parameter trees in
the JAX package's Flax layout (the port's copy of its ``models/convert.py``).

The port's modules are named after that layout, and ``models.from_jax``
maps a tree onto them by name, so there is one mapping of names, and a
tree made here equals the JAX package's leaf for leaf. Conventions:

  torch Linear  (out, in)         -> Dense kernel (in, out): transpose
  torch Conv2d  (out, in, kh, kw) -> Conv kernel (kh, kw, in, out)
  torch LayerNorm weight / bias   -> scale / bias

Covered: DINOv2 (original and HF layouts), the DPT heads, DA-V2, DA3,
Video-Depth-Anything, PromptDA (HF layout), MoGe, UniDepth-V2, UniK3D,
DepthPro (HF layout), Wan (InSpatio-World), U²-Net, the SVD family
(StereoCrafter UNet and VAE, GeometryCrafter's point-map VAE, the m2svid
sgm checkpoint), the CLIP vision tower, DROID / Mega-SAM, torchvision's
RAFT and CoTracker3. Files are read and written by ``io.checkpoint``
(Flax's msgpack or a pickle), without JAX.
"""

from __future__ import annotations

import os

import numpy as np

from metric_depth_video_toolbox_tpu_torch.io.checkpoint import (  # noqa: F401
    load_checkpoint, save_checkpoint)
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod


def _t(x):
    return np.asarray(x, np.float32)


def linear(sd, prefix):
    out = {"kernel": _t(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def conv(sd, prefix):
    w = _t(sd[prefix + ".weight"])  # (out, in, kh, kw)
    out = {"kernel": w.transpose(2, 3, 1, 0)}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def conv_transpose(sd, prefix):
    # torch ConvTranspose2d (in, out, kh, kw) computes the gradient-of-
    # conv (kernel applied spatially FLIPPED relative to lax.conv_
    # transpose's correlation); flip kh/kw so flax nn.ConvTranspose
    # reproduces torch outputs (verified numerically vs HF torch).
    w = _t(sd[prefix + ".weight"])
    out = {"kernel": w.transpose(2, 3, 0, 1)[::-1, ::-1].copy()}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def layernorm(sd, prefix):
    return {"scale": _t(sd[prefix + ".weight"]),
            "bias": _t(sd[prefix + ".bias"])}


def groupnorm(sd, prefix):
    return {"scale": _t(sd[prefix + ".weight"]),
            "bias": _t(sd[prefix + ".bias"])}


def batchnorm(sd, prefix):
    """torch BatchNorm2d (eval) -> our EvalBatchNorm params (running
    stats become converted params; inference-only framework)."""
    return {"scale": _t(sd[prefix + ".weight"]),
            "bias": _t(sd[prefix + ".bias"]),
            "mean": _t(sd[prefix + ".running_mean"]),
            "var": _t(sd[prefix + ".running_var"])}


def conv3d(sd, prefix):
    """torch Conv3d (out, in, kt, kh, kw) -> flax 3D Conv kernel
    (kt, kh, kw, in, out)."""
    w = _t(sd[prefix + ".weight"])
    out = {"kernel": w.transpose(2, 3, 4, 1, 0)}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def convert_dinov2_vit(state_dict, cfg):
    """torch DINOv2/DA-V2 backbone state dict -> our models.vit.ViT params.

    Expected torch layout (DINOv2): patch_embed.proj, cls_token,
    pos_embed, blocks.N.{norm1, attn.qkv, attn.proj, ls1.gamma, norm2,
    mlp.fc1, mlp.fc2, ls2.gamma}, norm.
    """
    sd = {k.replace("pretrained.", ""): v for k, v in state_dict.items()}
    p = {
        "patch_embed": conv(sd, "patch_embed.proj"),
        "cls_token": _t(sd["cls_token"]),
        "pos_embed": _t(sd["pos_embed"]),
        "norm": layernorm(sd, "norm"),
    }
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        p[f"block{i}"] = {
            "norm1": layernorm(sd, f"{b}.norm1"),
            "attn": {"qkv": linear(sd, f"{b}.attn.qkv"),
                     "proj": linear(sd, f"{b}.attn.proj")},
            "ls1": {"gamma": _t(sd[f"{b}.ls1.gamma"])},
            "norm2": layernorm(sd, f"{b}.norm2"),
            "mlp": {"fc1": linear(sd, f"{b}.mlp.fc1"),
                    "fc2": linear(sd, f"{b}.mlp.fc2")},
            "ls2": {"gamma": _t(sd[f"{b}.ls2.gamma"])},
        }
    return p


def convert_dpt_head(state_dict, cfg):
    """torch DA-V2 ``depth_head`` state dict -> our models.dpt.DPTHead
    params. Requires DPTConfig(torch_resize=True, fast_head=False) so
    the op graph is weight-exact (learned resize layers + original head
    conv order).

    Torch layout: depth_head.projects.N, depth_head.resize_layers.N,
    depth_head.scratch.layerN_rn, depth_head.scratch.refinenetN
    (.resConfUnit{1,2}.conv{1,2}, .out_conv), scratch.output_conv1,
    scratch.output_conv2.{0,2}.
    """
    sd = {k.replace("depth_head.", ""): v for k, v in state_dict.items()
          if k.startswith("depth_head.")} or dict(state_dict)
    return _dpt_head_from(sd, cfg)


def _dpt_head_from(sd, cfg):
    p = {}
    for i in range(4):
        p[f"project{i}"] = conv(sd, f"projects.{i}")
        p[f"scratch{i}"] = {
            "kernel": _t(sd[f"scratch.layer{i + 1}_rn.weight"]
                         ).transpose(2, 3, 1, 0)}
    p["resize0"] = conv_transpose(sd, "resize_layers.0")
    p["resize1"] = conv_transpose(sd, "resize_layers.1")
    p["resize3"] = conv(sd, "resize_layers.3")

    def rcu(prefix):
        return {"conv1": conv(sd, prefix + ".conv1"),
                "conv2": conv(sd, prefix + ".conv2")}

    # torch refinenet4 fuses the COARSEST level (our fusion3) down to
    # refinenet1 = finest (our fusion0); refinenet4 has no resConfUnit1
    # skip in DA-V2 (single input), matching our fusion3 call.
    for ours, theirs in (("fusion3", 4), ("fusion2", 3), ("fusion1", 2),
                         ("fusion0", 1)):
        rn = f"scratch.refinenet{theirs}"
        blk = {"rcu2": rcu(rn + ".resConfUnit2"),
               "project": conv(sd, rn + ".out_conv")}
        if f"{rn}.resConfUnit1.conv1.weight" in sd and ours != "fusion3":
            blk["rcu1"] = rcu(rn + ".resConfUnit1")
        p[ours] = blk
    p["head_conv1"] = conv(sd, "scratch.output_conv1")
    p["head_conv2"] = conv(sd, "scratch.output_conv2.0")
    p["head_conv3"] = conv(sd, "scratch.output_conv2.2")
    return p


def convert_dinov2_hf(state_dict, cfg, prefix="backbone."):
    """HF transformers Dinov2 layout -> our models.vit.ViT params.

    HF uses separate query/key/value projections; our ViT uses the
    original DINOv2 fused qkv, so [q; k; v] concatenate along the output
    dim (verified numerically in tests/test_weight_exact.py)."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items()
          if k.startswith(prefix)} if prefix else dict(state_dict)
    p = {
        "patch_embed": conv(sd, "embeddings.patch_embeddings.projection"),
        "cls_token": _t(sd["embeddings.cls_token"]),
        "pos_embed": _t(sd["embeddings.position_embeddings"]),
        "norm": layernorm(sd, "layernorm"),
    }
    for i in range(cfg.depth):
        b = f"encoder.layer.{i}"
        qw = np.concatenate([
            _t(sd[f"{b}.attention.attention.{n}.weight"])
            for n in ("query", "key", "value")], axis=0)
        qb = np.concatenate([
            _t(sd[f"{b}.attention.attention.{n}.bias"])
            for n in ("query", "key", "value")], axis=0)
        p[f"block{i}"] = {
            "norm1": layernorm(sd, f"{b}.norm1"),
            "attn": {"qkv": {"kernel": qw.T, "bias": qb},
                     "proj": linear(sd, f"{b}.attention.output.dense")},
            "ls1": {"gamma": _t(sd[f"{b}.layer_scale1.lambda1"])},
            "norm2": layernorm(sd, f"{b}.norm2"),
            "mlp": {"fc1": linear(sd, f"{b}.mlp.fc1"),
                    "fc2": linear(sd, f"{b}.mlp.fc2")},
            "ls2": {"gamma": _t(sd[f"{b}.layer_scale2.lambda1"])},
        }
    return p


def convert_dpt_head_hf(state_dict, n_levels=4):
    """HF transformers DepthAnything neck+head layout -> our DPTHead
    params. HF fusion_stage.layers[0] is the COARSEST level (applied
    first) = our fusion3; layers[0].residual_layer1 exists in the HF
    tree but is never called (first fusion has no skip), so it is
    dropped. Requires DPTConfig(torch_resize=True, fast_head=False)."""
    sd = state_dict
    p = {}
    for i in range(n_levels):
        p[f"project{i}"] = conv(sd, f"neck.reassemble_stage.layers.{i}"
                                    ".projection")
        p[f"scratch{i}"] = {
            "kernel": _t(sd[f"neck.convs.{i}.weight"]).transpose(2, 3, 1, 0)}
    p["resize0"] = conv_transpose(sd, "neck.reassemble_stage.layers.0.resize")
    p["resize1"] = conv_transpose(sd, "neck.reassemble_stage.layers.1.resize")
    p["resize3"] = conv(sd, "neck.reassemble_stage.layers.3.resize")

    def rcu(prefix):
        return {"conv1": conv(sd, prefix + ".convolution1"),
                "conv2": conv(sd, prefix + ".convolution2")}

    for ours, theirs in (("fusion3", 0), ("fusion2", 1), ("fusion1", 2),
                         ("fusion0", 3)):
        fl = f"neck.fusion_stage.layers.{theirs}"
        blk = {"rcu2": rcu(fl + ".residual_layer2"),
               "project": conv(sd, fl + ".projection")}
        if ours != "fusion3":
            blk["rcu1"] = rcu(fl + ".residual_layer1")
        p[ours] = blk
    p["head_conv1"] = conv(sd, "head.conv1")
    p["head_conv2"] = conv(sd, "head.conv2")
    p["head_conv3"] = conv(sd, "head.conv3")
    return p


def convert_da2_hf(state_dict, vit_cfg, grid_hw=None):
    """Full HF-layout Depth-Anything checkpoint (e.g.
    depth-anything/Depth-Anything-V2-*-hf) -> our DepthAnything params.
    Use with DPTConfig(torch_resize=True, fast_head=False); metric
    checkpoints additionally need head_act='sigmoid'. ``grid_hw``
    resamples the position embedding to a new (gh, gw) patch grid."""
    backbone = convert_dinov2_hf(state_dict, vit_cfg)
    if grid_hw is not None:
        n = backbone["pos_embed"].shape[1] - 1
        g0 = int(round(float(np.sqrt(n))))
        backbone["pos_embed"] = vit_mod.interpolate_pos_embed(
            backbone["pos_embed"], (g0, n // g0), grid_hw)
    return {"params": {
        "backbone": backbone,
        "head": convert_dpt_head_hf(state_dict),
    }}


def convert_promptda_hf(state_dict, vit_cfg, grid_hw=None):
    """HF-layout PromptDepthAnything checkpoint (e.g.
    depth-anything/prompt-depth-anything-vitl-hf) -> our PromptDA params:
    the Depth-Anything tree plus each fusion level's prompt branch
    (fusion_stage.layers.N.prompt_depth_layer.convolution{1,2,3})."""
    out = convert_da2_hf(state_dict, vit_cfg, grid_hw)
    head = out["params"]["head"]
    for ours, theirs in (("fusion3", 0), ("fusion2", 1), ("fusion1", 2),
                         ("fusion0", 3)):
        pl = f"neck.fusion_stage.layers.{theirs}.prompt_depth_layer"
        head[ours]["prompt"] = {
            "conv1": conv(state_dict, pl + ".convolution1"),
            "conv2": conv(state_dict, pl + ".convolution2"),
            "conv3": conv(state_dict, pl + ".convolution3"),
        }
    return out


def convert_da2(state_dict, vit_cfg):
    """Full Depth-Anything-V2 checkpoint -> our DepthAnything params
    ({'params': {'backbone': ..., 'head': ...}}). Use with
    DPTConfig(torch_resize=True, fast_head=False)."""
    return {"params": {
        "backbone": convert_dinov2_vit(state_dict, vit_cfg),
        "head": convert_dpt_head(state_dict, vit_cfg),
    }}


def convert_da3(state_dict, cfg, grid_hw=None):
    """Full Depth-Anything-3 checkpoint -> our models.da3.DA3 params
    (the reference's default engine, video_da3.py:274 loads
    depth-anything/da3nested-giant-large).

    DA3's published architecture is a plain DINOv2 backbone — its
    cross-view attention is parameter-free input reshaping (our ViT
    cross_view_indices), so the backbone converts through the ordinary
    DINOv2 mapping unchanged — plus a dual-DPT depth-ray head (one DPT
    decode per branch in the DA-V2 scratch layout):

      backbone.*        DINOv2 keys (patch_embed.proj, cls_token,
                        pos_embed, blocks.N.attn.qkv/proj, ls1/ls2,
                        mlp.fc1/fc2, norm)
      head.depth.*      DPT branch: projects.N, resize_layers.N,
                        scratch.layerN_rn, scratch.refinenetN,
                        scratch.output_conv1/2 (1ch depth)
      head.ray.*        same DPT layout, 6ch ray-map output
      ray_embed.*       optional known-intrinsics conditioning Linear

    ``cfg`` is a models.da3.DA3Config whose dpt has torch_resize=True,
    fast_head=False (weight-exact decode order). ``grid_hw`` resamples
    the position embedding to a new patch grid. Forward equivalence vs
    a torch mirror of this graph: tests/test_weight_exact_da3.py.
    """
    def sub(prefix):
        return {k[len(prefix):]: v for k, v in state_dict.items()
                if k.startswith(prefix)}

    bb = convert_dinov2_vit(sub("backbone."), cfg.vit)
    if grid_hw is not None:
        n = bb["pos_embed"].shape[1] - 1
        g0 = int(round(float(np.sqrt(n))))
        bb["pos_embed"] = vit_mod.interpolate_pos_embed(
            bb["pos_embed"], (g0, n // g0), grid_hw)
    p = {"backbone": bb,
         "head": {"depth": _dpt_head_from(sub("head.depth."), cfg.dpt)}}
    ray_sd = sub("head.ray.")
    if ray_sd:
        p["head"]["ray"] = _dpt_head_from(ray_sd, cfg.dpt)
    if "ray_embed.weight" in state_dict:
        p["ray_embed"] = linear(state_dict, "ray_embed")
    return {"params": p}


def convert_moge(state_dict, cfg):
    """MoGe point-map checkpoint (reference moge_video.py:13, the
    Ruicheng/moge-vitl family) -> our models.moge.MoGeNet params.

    Layout (documented in models/moge.py): backbone.* DINOv2 keys;
    head.projects.{i} summed 1x1 level projections;
    head.upsample_blocks.{i} = [ConvTranspose2d(in+2,out,2,2),
    Conv3x3, ResidualConvBlock...]; head.output_block = [Conv3x3(in+2,
    32), ReLU, Conv1x1(32, 4)]. Forward equivalence vs a torch mirror:
    tests/test_weight_exact_moge.py.
    """
    def sub(prefix):
        return {k[len(prefix):]: v for k, v in state_dict.items()
                if k.startswith(prefix)}

    hd = sub("head.")
    head = {}
    for i in range(4):
        head[f"project{i}"] = conv(hd, f"projects.{i}")
    for i in range(len(cfg.dim_upsample)):
        ub = f"upsample_blocks.{i}"
        head[f"upsample{i}"] = conv_transpose(hd, f"{ub}.0")
        head[f"upconv{i}"] = conv(hd, f"{ub}.1")
        for j in range(cfg.num_res_blocks):
            rb = f"{ub}.{2 + j}"
            head[f"res{i}_{j}"] = {
                "norm1": groupnorm(hd, rb + ".norm1"),
                "conv1": conv(hd, rb + ".conv1"),
                "norm2": groupnorm(hd, rb + ".norm2"),
                "conv2": conv(hd, rb + ".conv2"),
            }
    head["out_conv1"] = conv(hd, "output_block.0")
    head["out_conv2"] = conv(hd, "output_block.2")
    return {"params": {
        "backbone": convert_dinov2_vit(sub("backbone."), cfg.vit),
        "head": head,
    }}


def _vit_block_params(sd, prefix):
    """One DINOv2-style transformer block (norm1, attn.qkv/proj,
    ls1/ls2.gamma, norm2, mlp.fc1/fc2) -> models.vit.Block params."""
    return {
        "norm1": layernorm(sd, f"{prefix}.norm1"),
        "attn": {"qkv": linear(sd, f"{prefix}.attn.qkv"),
                 "proj": linear(sd, f"{prefix}.attn.proj")},
        "ls1": {"gamma": _t(sd[f"{prefix}.ls1.gamma"])},
        "norm2": layernorm(sd, f"{prefix}.norm2"),
        "mlp": {"fc1": linear(sd, f"{prefix}.mlp.fc1"),
                "fc2": linear(sd, f"{prefix}.mlp.fc2")},
        "ls2": {"gamma": _t(sd[f"{prefix}.ls2.gamma"])},
    }


def _token_decoder(sd, cfg, num_blocks, with_rays):
    """UniDepth/UniK3D token decoder (projects.N [+ ray_mlp1/2] +
    blocks.N) -> models.unidepth.TokenDecoder params. ``sd`` is the
    torch sub-dict rooted at the decoder (e.g. 'depth.')."""
    p = {f"project{i}": linear(sd, f"projects.{i}") for i in range(4)}
    if with_rays:
        p["ray_mlp1"] = linear(sd, "ray_mlp1")
        p["ray_mlp2"] = linear(sd, "ray_mlp2")
    for i in range(num_blocks):
        p[f"block{i}"] = _vit_block_params(sd, f"blocks.{i}")
    return p


def _pixel_head(sd, cfg):
    """UniDepth/UniK3D pixel head (upsampleN/upconvN + out_conv1/2) ->
    models.unidepth.PixelHead params."""
    p = {}
    for i in range(len(cfg.dim_upsample)):
        p[f"upsample{i}"] = conv_transpose(sd, f"upsample{i}")
        p[f"upconv{i}"] = conv(sd, f"upconv{i}")
    p["out_conv1"] = conv(sd, "out_conv1")
    p["out_conv2"] = conv(sd, "out_conv2")
    return p


def _sub(state_dict, prefix):
    return {k[len(prefix):]: v for k, v in state_dict.items()
            if k.startswith(prefix)}


def convert_unidepth(state_dict, cfg):
    """UniDepth-V2 class checkpoint (reference unidepth_video.py:14,
    lpiccinelli/unidepth-v2-vitl14 family) -> our
    models.unidepth.UniDepthNet params.

    Layout (documented in models/unidepth.py): backbone.* DINOv2 keys;
    camera.{in_proj, queries, q/k/v/out_proj, mlp1, mlp2} attention-
    pooled pinhole head; depth.{projects.N, ray_mlp1/2, blocks.N,
    upsampleN/upconvN, out_conv1/2}. Forward equivalence vs a torch
    mirror: tests/test_weight_exact_unidepth.py.
    """
    cam = _sub(state_dict, "camera.")
    camera = {
        "in_proj": linear(cam, "in_proj"),
        "queries": _t(cam["queries"]),
        "q_proj": linear(cam, "q_proj"),
        "k_proj": linear(cam, "k_proj"),
        "v_proj": linear(cam, "v_proj"),
        "out_proj": linear(cam, "out_proj"),
        "mlp1": linear(cam, "mlp1"),
        "mlp2": linear(cam, "mlp2"),
    }
    dep = _sub(state_dict, "depth.")
    return {"params": {
        "backbone": convert_dinov2_vit(_sub(state_dict, "backbone."),
                                       cfg.vit),
        "camera": camera,
        "depth": {
            "tokens": _token_decoder(dep, cfg, cfg.num_blocks, True),
            "pixel": _pixel_head(dep, cfg),
        },
    }}


def convert_unik3d(state_dict, cfg):
    """UniK3D class checkpoint (reference unik3d_video.py:13,
    lpiccinelli/unik3d-vitl family) -> our models.unidepth.UniK3DNet
    params.

    Layout (documented in models/unidepth.py): backbone.* DINOv2 keys;
    angular.{projects.N, blocks.N, out} dense ray-field head;
    radius.{projects.N, ray_mlp1/2, blocks.N, upsampleN/upconvN,
    out_conv1/2} SH-ray-conditioned radial head. Forward equivalence vs
    a torch mirror: tests/test_weight_exact_unidepth.py.
    """
    ang = _sub(state_dict, "angular.")
    rad = _sub(state_dict, "radius.")
    return {"params": {
        "backbone": convert_dinov2_vit(_sub(state_dict, "backbone."),
                                       cfg.vit),
        "angular": _token_decoder(ang, cfg, cfg.num_angular_blocks,
                                  False),
        "angular_out": linear(ang, "out"),
        "radius_tokens": _token_decoder(rad, cfg, cfg.num_blocks, True),
        "radius_pixel": _pixel_head(rad, cfg),
    }}


def _motion_module(sd, prefix, n_blocks=1, n_attn=2):
    """AnimateDiff TemporalTransformer3DModel state dict -> our
    TemporalModule params (models.video_depth)."""
    tt = prefix + ".temporal_transformer"
    p = {"norm": {"scale": _t(sd[tt + ".norm.weight"]),
                  "bias": _t(sd[tt + ".norm.bias"])},
         "proj_in": linear(sd, tt + ".proj_in"),
         "proj_out": linear(sd, tt + ".proj_out")}
    for j in range(n_blocks):
        tb = f"{tt}.transformer_blocks.{j}"
        blk = {}
        for k in range(n_attn):
            ab = f"{tb}.attention_blocks.{k}"
            blk[f"norm{k}"] = layernorm(sd, f"{tb}.norms.{k}")
            blk[f"attn{k}"] = {
                "to_q": linear(sd, ab + ".to_q"),
                "to_k": linear(sd, ab + ".to_k"),
                "to_v": linear(sd, ab + ".to_v"),
                "to_out": linear(sd, ab + ".to_out.0"),
            }
        blk["ff_norm"] = layernorm(sd, tb + ".ff_norm")
        blk["geglu"] = linear(sd, tb + ".ff.net.0.proj")
        blk["ff_out"] = linear(sd, tb + ".ff.net.2")
        p[f"block{j}"] = blk
    return p


def convert_vda(state_dict, cfg):
    """Video-Depth-Anything checkpoint (video_depth_anything_vit{s,l}
    .pth, reference download_weights.py:80-133) -> our
    VideoDepthAnything params. ``cfg`` is a VideoDepthConfig; use
    dpt torch_resize=True, fast_head=False for weight-exact decode.

    Upstream layout: pretrained.* (DINOv2) + head.* (DPT with
    head.motion_modules.{0..3}.temporal_transformer.*; head-level
    forward equivalence proven in tests/test_weight_exact_vda.py)."""
    head_sd = {k[len("head."):]: v for k, v in state_dict.items()
               if k.startswith("head.")}
    head = _dpt_head_from(head_sd, cfg.vit)
    for i in range(4):
        head[f"motion{i}"] = _motion_module(
            head_sd, f"motion_modules.{i}", n_blocks=cfg.temporal_layers)
    return {"params": {
        "backbone": convert_dinov2_vit(state_dict, cfg.vit),
        "head": head,
    }}


def _prompt_context(sd, cfg):
    """Fixed prompt context for convert_wan: a precomputed umT5
    encoding shipped with the checkpoint (key 'mdvt.prompt_context'),
    zero-padded/truncated to (n_prompt_tokens, text_dim); zeros bank
    when absent."""
    ctx = sd.get("mdvt.prompt_context")
    bank = np.zeros((cfg.n_prompt_tokens, cfg.text_dim), np.float32)
    if ctx is not None:
        ctx = np.asarray(_t(ctx), np.float32)
        n = min(ctx.shape[0], cfg.n_prompt_tokens)
        bank[:n] = ctx[:n, :cfg.text_dim]
    return bank


def convert_wan(state_dict, cfg):
    """Wan2.1-class causal video DiT checkpoint (the layout of
    InSpatio-World-1.3B.safetensors, reference
    inspatio_world_infill.py:44-47) -> our models.wan.WanDiT params.

    Torch layout: patch_embedding (Conv3d 1x2x2), text_embedding.{0,2},
    time_embedding.{0,2}, time_projection.1, blocks.N.{self_attn.q/k/v/o
    + norm_q/norm_k (RMSNorm), cross_attn.q/k/v/o + norm_q/norm_k,
    norm3 (affine LN), ffn.0/2, modulation (1,6,D)}, head.{head,
    modulation (1,2,D)}. The learned prompt-token bank (our stand-in
    for the reference's fixed umT5-encoded prompt) is not in upstream
    checkpoints and keeps its init. Forward equivalence vs a torch
    mirror: tests/test_weight_exact_wan.py.
    """
    sd = state_dict

    def attn(prefix):
        return {
            "q": linear(sd, prefix + ".q"),
            "k": linear(sd, prefix + ".k"),
            "v": linear(sd, prefix + ".v"),
            "o": linear(sd, prefix + ".o"),
            "norm_q": {"scale": _t(sd[prefix + ".norm_q.weight"])},
            "norm_k": {"scale": _t(sd[prefix + ".norm_k.weight"])},
        }

    w = _t(sd["patch_embedding.weight"])  # (D, in, 1, p, p)
    p = {
        "patch_embedding": {
            "kernel": w.transpose(2, 3, 4, 1, 0),
            "bias": _t(sd["patch_embedding.bias"])},
        "text_embedding1": linear(sd, "text_embedding.0"),
        "text_embedding2": linear(sd, "text_embedding.2"),
        "time_embedding1": linear(sd, "time_embedding.0"),
        "time_embedding2": linear(sd, "time_embedding.2"),
        "time_projection": linear(sd, "time_projection.1"),
        "head": linear(sd, "head.head"),
        "head_modulation": _t(sd["head.modulation"]),
        # the reference runs the DiT with a FIXED umT5 encoding of
        # "The image shows a scene from a video"
        # (inspatio_world_infill.py:~400, encode_text once at startup).
        # Upstream checkpoints don't carry that tensor, so the converter
        # accepts a precomputed encoding under the side-channel key
        # 'mdvt.prompt_context' (shape (n_tok<=n_prompt_tokens,
        # text_dim); produced once by running umT5 at conversion time
        # and stored next to the weights). Fallback: a deterministic
        # zeros bank — callers may also pass any encoding via context=.
        "prompt_tokens": _prompt_context(sd, cfg),
    }
    for i in range(cfg.layers):
        b = f"blocks.{i}"
        p[f"block{i}"] = {
            "self_attn": attn(b + ".self_attn"),
            "cross_attn": attn(b + ".cross_attn"),
            "norm3": layernorm(sd, b + ".norm3"),
            "ffn1": linear(sd, b + ".ffn.0"),
            "ffn2": linear(sd, b + ".ffn.2"),
            "modulation": _t(sd[b + ".modulation"]),
        }
    return {"params": p}


def convert_droid(state_dict, cfg=None):
    """A DROID-SLAM-class checkpoint (Mega-SAM's ``megasam_final.pth``) ->
    ``models.droid.DroidNet``'s tree. The DataParallel ``module.`` prefix
    is stripped; fnet. / cnet. BasicEncoders (conv1, layerL.N.{conv1,
    conv2, downsample.0}, conv2; the instance norms carry no tensors),
    update.{corr_encoder.0/.2, flow_encoder.0/.2, gru.{convz, convr,
    convq, w, convz_glo, convr_glo, convq_glo}, delta.0/.2, weight.0/.2,
    agg.{conv1, conv2, eta.0, upmask.0}}; other tensors (Mega-SAM's
    motion head) are ignored. ``cfg`` (default DROID): its layer count."""
    from metric_depth_video_toolbox_tpu_torch.models import droid as dm
    cfg = cfg or dm.DROID
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in state_dict.items()}

    def encoder(prefix):
        p = {"conv1": conv(sd, prefix + "conv1"),
             "conv2": conv(sd, prefix + "conv2")}
        for li in range(len(cfg.layers)):
            for ni in range(2):
                tb = f"{prefix}layer{li + 1}.{ni}"
                blk = {"conv1": conv(sd, tb + ".conv1"),
                       "conv2": conv(sd, tb + ".conv2")}
                if tb + ".downsample.0.weight" in sd:
                    blk["downsample"] = conv(sd, tb + ".downsample.0")
                p[f"layer{li + 1}_{ni}"] = blk
        return p

    u = "update."
    upd = {
        "corr_enc1": conv(sd, u + "corr_encoder.0"),
        "corr_enc2": conv(sd, u + "corr_encoder.2"),
        "flow_enc1": conv(sd, u + "flow_encoder.0"),
        "flow_enc2": conv(sd, u + "flow_encoder.2"),
        "gru": {n: conv(sd, f"{u}gru.{n}") for n in
                ("convz", "convr", "convq", "w",
                 "convz_glo", "convr_glo", "convq_glo")},
        "delta1": conv(sd, u + "delta.0"),
        "delta2": conv(sd, u + "delta.2"),
        "weight1": conv(sd, u + "weight.0"),
        "weight2": conv(sd, u + "weight.2"),
        "agg_conv1": conv(sd, u + "agg.conv1"),
        "agg_conv2": conv(sd, u + "agg.conv2"),
        "agg_eta": conv(sd, u + "agg.eta.0"),
        "agg_upmask": conv(sd, u + "agg.upmask.0"),
    }
    return {"params": {"fnet": encoder("fnet."),
                       "cnet": encoder("cnet."),
                       "update": upd}}


def convert_raft(state_dict, cfg=None):
    """torchvision ``raft_large`` checkpoint -> ``models.raft.RAFT``'s
    tree: feature_encoder / context_encoder (convnormrelu stem,
    layer{1,2,3} of two ResidualBlocks, the 1x1 conv; the context
    encoder's batch norms), update_block.{motion_encoder,
    recurrent_block.convgru{1,2}, flow_head}, mask_predictor."""
    sd = state_dict

    def encoder(te, batch):
        p = {"stem": {"conv": conv(sd, f"{te}.convnormrelu.0")},
             "proj": conv(sd, f"{te}.conv")}
        if batch:
            p["stem"]["norm"] = batchnorm(sd, f"{te}.convnormrelu.1")
        for li in (1, 2, 3):
            for bi in (0, 1):
                b = f"{te}.layer{li}.{bi}"
                blk = {"convnormrelu1": {
                           "conv": conv(sd, b + ".convnormrelu1.0")},
                       "convnormrelu2": {
                           "conv": conv(sd, b + ".convnormrelu2.0")}}
                if batch:
                    blk["convnormrelu1"]["norm"] = batchnorm(
                        sd, b + ".convnormrelu1.1")
                    blk["convnormrelu2"]["norm"] = batchnorm(
                        sd, b + ".convnormrelu2.1")
                if b + ".downsample.0.0.weight" in sd:
                    blk["down_conv"] = conv(sd, b + ".downsample.0.0")
                    if batch:
                        blk["down_norm"] = batchnorm(
                            sd, b + ".downsample.0.1")
                p[f"layer{li}_{bi}"] = blk
        return p

    p = {"fnet": encoder("feature_encoder", batch=False),
         "cnet": encoder("context_encoder", batch=True)}
    me = "update_block.motion_encoder"
    p["motion"] = {n: {"conv": conv(sd, f"{me}.{n}.0")}
                   for n in ("convcorr1", "convcorr2", "convflow1",
                             "convflow2", "conv")}
    for g in (1, 2):
        p[f"gru{g}"] = {n: conv(
            sd, f"update_block.recurrent_block.convgru{g}.{n}")
            for n in ("convz", "convr", "convq")}
    p["flow_head1"] = conv(sd, "update_block.flow_head.conv1")
    p["flow_head2"] = conv(sd, "update_block.flow_head.conv2")
    p["mask_conv1"] = {"conv": conv(sd, "mask_predictor.convrelu.0")}
    p["mask_conv2"] = conv(sd, "mask_predictor.conv")
    return {"params": p}


def _virtual_tracks_key(sd):
    # upstream spells it "virual_tracks"; "virtual_tracks" is accepted too
    return ("updateformer.virual_tracks" if "updateformer.virual_tracks"
            in sd else "updateformer.virtual_tracks")


def convert_cotracker3(state_dict, cfg=None):
    """facebookresearch/co-tracker ``cotracker3_offline`` state dict ->
    ``models.cotracker.CoTracker3``'s tree; every dimension comes from the
    tensors' shapes. Keys: fnet.{conv1, conv2, conv3}, fnet.layer{1..4}
    .{0,1}.{conv1, conv2, downsample.0}, corr_mlp.{fc1, fc2},
    updateformer.{input_transform, virual_tracks, time_blocks.N,
    space_virtual_blocks.N, space_point2virtual_blocks.N,
    space_virtual2point_blocks.N, flow_head, vis_conf_head} with the
    blocks' attn / cross_attn.{to_q, to_kv, to_out}, norm1 / norm2 /
    norm_context, mlp.{fc1, fc2}."""
    sd = state_dict

    fnet = {"conv1": conv(sd, "fnet.conv1"),
            "conv2": conv(sd, "fnet.conv2"),
            "conv3": conv(sd, "fnet.conv3")}
    for li in (1, 2, 3, 4):
        for bi in (0, 1):
            b = f"fnet.layer{li}.{bi}"
            blk = {"conv1": conv(sd, b + ".conv1"),
                   "conv2": conv(sd, b + ".conv2")}
            if b + ".downsample.0.weight" in sd:
                blk["down_conv"] = conv(sd, b + ".downsample.0")
            fnet[f"layer{li}_{bi}"] = blk

    def attention(p):
        return {"to_q": linear(sd, p + ".to_q"),
                "to_kv": linear(sd, p + ".to_kv"),
                "to_out": linear(sd, p + ".to_out")}

    def mlp(p):
        return {"fc1": linear(sd, p + ".mlp.fc1"),
                "fc2": linear(sd, p + ".mlp.fc2")}

    def attn_block(p):
        return {"norm1": layernorm(sd, p + ".norm1"),
                "attn": attention(p + ".attn"),
                "norm2": layernorm(sd, p + ".norm2"), "mlp": mlp(p)}

    def cross_block(p):
        return {"norm1": layernorm(sd, p + ".norm1"),
                "norm_context": layernorm(sd, p + ".norm_context"),
                "cross_attn": attention(p + ".cross_attn"),
                "norm2": layernorm(sd, p + ".norm2"), "mlp": mlp(p)}

    uf = {"input_transform": linear(sd, "updateformer.input_transform"),
          "flow_head": linear(sd, "updateformer.flow_head"),
          "vis_conf_head": linear(sd, "updateformer.vis_conf_head")}
    virt = _t(sd[_virtual_tracks_key(sd)])  # (1, V, 1, C) -> (V, 1, C)
    uf["virtual_tracks"] = virt.reshape(virt.shape[-3], 1, virt.shape[-1])

    for i in range(_depth(sd, "time_blocks")):
        uf[f"time_blocks_{i}"] = attn_block(f"updateformer.time_blocks.{i}")
    for j in range(_depth(sd, "space_virtual_blocks")):
        uf[f"space_virtual_blocks_{j}"] = attn_block(
            f"updateformer.space_virtual_blocks.{j}")
        uf[f"space_point2virtual_blocks_{j}"] = cross_block(
            f"updateformer.space_point2virtual_blocks.{j}")
        uf[f"space_virtual2point_blocks_{j}"] = cross_block(
            f"updateformer.space_virtual2point_blocks.{j}")

    return {"params": {
        "fnet": fnet,
        "corr_mlp_fc1": linear(sd, "corr_mlp.fc1"),
        "corr_mlp_fc2": linear(sd, "corr_mlp.fc2"),
        "updateformer": uf}}


def _depth(sd, stack):
    """The number of blocks in ``updateformer.<stack>``."""
    i = 0
    while f"updateformer.{stack}.{i}.norm1.weight" in sd:
        i += 1
    return i


def cotracker3_config_from_state_dict(state_dict, **overrides):
    """A CoTracker3Config from a checkpoint's shapes: latent and hidden
    widths, the correlation window (-> radius), the depths, the virtual
    track count and the correlation levels (from the input transform's
    width, given the flow embedding's C, 64 unless overridden)."""
    from metric_depth_video_toolbox_tpu_torch.models import cotracker as ct
    sd = state_dict
    latent = sd["fnet.conv3.weight"].shape[0]
    win = round(sd["corr_mlp.fc1.weight"].shape[1] ** 0.25)
    hidden = sd["updateformer.input_transform.weight"].shape[0]
    input_dim = sd["updateformer.input_transform.weight"].shape[1]
    emb = sd["corr_mlp.fc2.weight"].shape[0]
    hid_mlp = sd["corr_mlp.fc1.weight"].shape[0]
    nv = _t(sd[_virtual_tracks_key(sd)]).reshape(-1, hidden).shape[0]
    flow_c = overrides.pop("flow_embed_dim", 64)
    levels = (input_dim - 2 - (2 * flow_c + 2)) // emb
    kw = dict(latent_dim=latent, corr_radius=(win - 1) // 2,
              corr_levels=levels, corr_mlp_hidden=hid_mlp,
              corr_emb_dim=emb, hidden_size=hidden,
              time_depth=_depth(sd, "time_blocks"),
              space_depth=_depth(sd, "space_virtual_blocks"),
              num_virtual_tracks=nv, flow_embed_dim=flow_c)
    kw.update(overrides)
    return ct.CoTracker3Config(**kw)


def convert_u2net(state_dict, cfg=None):
    """Original u2net/u2netp torch checkpoint -> our models.segmentation
    U2Net params (forward equivalence proven in
    tests/test_weight_exact_u2net.py).

    Original layout: stage{1..6}[d].rebnconv{in,1..7,1d..6d}.
    {conv_s1, bn_s1}, side{1..6}, outconv."""
    sd = state_dict

    def rebn(prefix):
        return {"conv": conv(sd, prefix + ".conv_s1"),
                "bn": batchnorm(sd, prefix + ".bn_s1")}

    p = {}
    stage_names = [f"stage{i}" for i in range(1, 7)] + \
        [f"stage{i}d" for i in range(5, 0, -1)]
    for st in stage_names:
        blk = {}
        for key in list(sd):
            if not key.startswith(st + ".rebnconv"):
                continue
            sub = key[len(st) + 1:].split(".")[0]  # e.g. rebnconv3d
            if sub not in blk:
                blk[sub] = rebn(f"{st}.{sub}")
        p[st] = blk
    for i in range(1, 7):
        p[f"side{i}"] = conv(sd, f"side{i}")
    p["outconv"] = conv(sd, "outconv")
    return {"params": p}


def _mix(sd, prefix):
    return {"mix_factor": _t(sd[prefix + ".mix_factor"]).reshape(())}


def _resnet2d(sd, p):
    out = {"norm1": layernorm(sd, p + ".norm1"),
           "conv1": conv(sd, p + ".conv1"),
           "norm2": layernorm(sd, p + ".norm2"),
           "conv2": conv(sd, p + ".conv2")}
    if p + ".time_emb_proj.weight" in sd:
        out["time_emb_proj"] = linear(sd, p + ".time_emb_proj")
    if p + ".conv_shortcut.weight" in sd:
        out["conv_shortcut"] = conv(sd, p + ".conv_shortcut")
    return out


def _resnet_temporal(sd, p):
    out = {"norm1": layernorm(sd, p + ".norm1"),
           "conv1": conv3d(sd, p + ".conv1"),
           "norm2": layernorm(sd, p + ".norm2"),
           "conv2": conv3d(sd, p + ".conv2")}
    if p + ".time_emb_proj.weight" in sd:
        out["time_emb_proj"] = linear(sd, p + ".time_emb_proj")
    if p + ".conv_shortcut.weight" in sd:
        out["conv_shortcut"] = conv3d(sd, p + ".conv_shortcut")
    return out


def _st_resblock(sd, p):
    return {"spatial_res_block": _resnet2d(sd, p + ".spatial_res_block"),
            "temporal_res_block": _resnet_temporal(
                sd, p + ".temporal_res_block"),
            "time_mixer": _mix(sd, p + ".time_mixer")}


def _attn_mod(sd, p):
    return {"to_q": linear(sd, p + ".to_q"),
            "to_k": linear(sd, p + ".to_k"),
            "to_v": linear(sd, p + ".to_v"),
            "to_out": linear(sd, p + ".to_out.0")}


def _ff_mod(sd, p):
    return {"proj": linear(sd, p + ".net.0.proj"),
            "out": linear(sd, p + ".net.2")}


def _basic_tblock(sd, p):
    return {"norm1": layernorm(sd, p + ".norm1"),
            "attn1": _attn_mod(sd, p + ".attn1"),
            "norm2": layernorm(sd, p + ".norm2"),
            "attn2": _attn_mod(sd, p + ".attn2"),
            "norm3": layernorm(sd, p + ".norm3"),
            "ff": _ff_mod(sd, p + ".ff")}


def _temporal_tblock(sd, p):
    out = _basic_tblock(sd, p)
    out["norm_in"] = layernorm(sd, p + ".norm_in")
    out["ff_in"] = _ff_mod(sd, p + ".ff_in")
    return out


def _transformer_st(sd, p, n_layers=1):
    out = {"norm": layernorm(sd, p + ".norm"),
           "proj_in": linear(sd, p + ".proj_in"),
           "proj_out": linear(sd, p + ".proj_out"),
           "time_pos_embed": {
               "linear_1": linear(sd, p + ".time_pos_embed.linear_1"),
               "linear_2": linear(sd, p + ".time_pos_embed.linear_2")},
           "time_mixer": _mix(sd, p + ".time_mixer")}
    for li in range(n_layers):
        out[f"block{li}"] = _basic_tblock(
            sd, f"{p}.transformer_blocks.{li}")
        out[f"tblock{li}"] = _temporal_tblock(
            sd, f"{p}.temporal_transformer_blocks.{li}")
    return out


def convert_svd_unet(state_dict, cfg):
    """diffusers UNetSpatioTemporalConditionModel state dict (the SVD /
    StereoCrafter UNet, reference stereo_crafter_infill.py:97-99) -> our
    models.svd.SVDUNet params. ``cfg`` is an SVDConfig. Forward
    equivalence proven in tests/test_weight_exact_svd.py against a torch
    re-implementation of the diffusers graph."""
    sd = state_dict
    n = len(cfg.block_out_channels)
    nl = cfg.transformer_layers_per_block
    p = {"conv_in": conv(sd, "conv_in"),
         "time_embedding": {
             "linear_1": linear(sd, "time_embedding.linear_1"),
             "linear_2": linear(sd, "time_embedding.linear_2")},
         "add_embedding": {
             "linear_1": linear(sd, "add_embedding.linear_1"),
             "linear_2": linear(sd, "add_embedding.linear_2")},
         "conv_norm_out": layernorm(sd, "conv_norm_out"),
         "conv_out": conv(sd, "conv_out")}
    for i in range(n):
        db = f"down_blocks.{i}"
        for j in range(cfg.layers_per_block):
            p[f"down{i}_res{j}"] = _st_resblock(sd, f"{db}.resnets.{j}")
            if i < n - 1:
                p[f"down{i}_attn{j}"] = _transformer_st(
                    sd, f"{db}.attentions.{j}", nl)
        if i < n - 1:
            p[f"down{i}_pool"] = conv(sd, f"{db}.downsamplers.0.conv")
    p["mid_res0"] = _st_resblock(sd, "mid_block.resnets.0")
    p["mid_res1"] = _st_resblock(sd, "mid_block.resnets.1")
    p["mid_attn"] = _transformer_st(sd, "mid_block.attentions.0", nl)
    for k in range(n):          # diffusers up_blocks.0 = coarsest
        i = n - 1 - k           # our up{i} indexes by resolution level
        ub = f"up_blocks.{k}"
        for j in range(cfg.layers_per_block + 1):
            p[f"up{i}_res{j}"] = _st_resblock(sd, f"{ub}.resnets.{j}")
            if i < n - 1:
                p[f"up{i}_attn{j}"] = _transformer_st(
                    sd, f"{ub}.attentions.{j}", nl)
        if i > 0:
            p[f"up{i}_upconv"] = conv(sd, f"{ub}.upsamplers.0.conv")
    return {"params": p}


def _vae_attn(sd, p):
    return {"group_norm": layernorm(sd, p + ".group_norm"),
            "attn": _attn_mod(sd, p)}


def convert_svd_vae(state_dict, cfg):
    """diffusers AutoencoderKLTemporalDecoder state dict (the SVD VAE)
    -> our models.svd.{SVDVAEEncoder, SVDVAEDecoder} params. Returns
    {'encoder': {'params': ...}, 'decoder': {'params': ...}}."""
    sd = state_dict
    n = len(cfg.block_out_channels)
    enc = {"conv_in": conv(sd, "encoder.conv_in"),
           "conv_norm_out": layernorm(sd, "encoder.conv_norm_out"),
           "conv_out": conv(sd, "encoder.conv_out"),
           "quant_conv": conv(sd, "quant_conv")}
    for i in range(n):
        for j in range(cfg.layers_per_block):
            enc[f"down{i}_res{j}"] = _resnet2d(
                sd, f"encoder.down_blocks.{i}.resnets.{j}")
        if i < n - 1:
            enc[f"down{i}_pool"] = conv(
                sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")
    enc["mid_res0"] = _resnet2d(sd, "encoder.mid_block.resnets.0")
    enc["mid_res1"] = _resnet2d(sd, "encoder.mid_block.resnets.1")
    enc["mid_attn"] = _vae_attn(sd, "encoder.mid_block.attentions.0")

    dec = {"conv_in": conv(sd, "decoder.conv_in"),
           "conv_norm_out": layernorm(sd, "decoder.conv_norm_out"),
           "conv_out": conv(sd, "decoder.conv_out"),
           "time_conv_out": conv3d(sd, "decoder.time_conv_out"),
           "mid_attn": _vae_attn(sd, "decoder.mid_block.attentions.0")}
    for j in range(cfg.layers_per_block):
        dec[f"mid_res{j}"] = _st_resblock(
            sd, f"decoder.mid_block.resnets.{j}")
    for k in range(n):          # up_blocks.0 = coarsest = our up0
        for j in range(cfg.layers_per_block + 1):
            dec[f"up{k}_res{j}"] = _st_resblock(
                sd, f"decoder.up_blocks.{k}.resnets.{j}")
        if k < n - 1:
            dec[f"up{k}_upconv"] = conv(
                sd, f"decoder.up_blocks.{k}.upsamplers.0.conv")
    return {"encoder": {"params": enc}, "decoder": {"params": dec}}


def _sgm_video_unet_to_diffusers(sd, cfg):
    """Rename an sgm/ldm VideoUNet state dict (the m2svid / Hi3D stack,
    reference m2svid_infill.py:485-488: ``sgm.util.instantiate_from_config``
    + ``init_from_ckpt('ckpts/m2svid_weights.pt')``) to the diffusers
    UNetSpatioTemporalConditionModel key layout, so convert_svd_unet's
    proven mapping finishes the job. The two layouts are tensor-for-
    tensor identical (diffusers' SVD was converted FROM this sgm graph);
    only module paths differ:

        time_embed.0/2            -> time_embedding.linear_1/2
        label_emb.0.0/0.2         -> add_embedding.linear_1/2
        input_blocks.0.0          -> conv_in
        input_blocks.i.0 ResBlock -> down_blocks.l.resnets.j
          (in_layers.0/2, emb_layers.1, out_layers.0/3, skip_connection
           -> norm1/conv1, time_emb_proj, norm2/conv2, conv_shortcut,
           spatial + .time_stack temporal halves, time_mixer)
        input_blocks.i.1 SpatialVideoTransformer
                                  -> down_blocks.l.attentions.j
          (time_stack.j -> temporal_transformer_blocks.j,
           time_pos_embed.0/2 -> .linear_1/2)
        input_blocks.i.0.op       -> down_blocks.l.downsamplers.0.conv
        middle_block.0/1/2        -> mid_block.resnets.0 / attentions.0
                                     / resnets.1
        output_blocks.*           -> up_blocks.* (+ trailing Upsample
                                     module -> upsamplers.0.conv)
        out.0/2                   -> conv_norm_out / conv_out
    """
    n = len(cfg.block_out_channels)
    lpb = cfg.layers_per_block
    ren = {"time_embed.0": "time_embedding.linear_1",
           "time_embed.2": "time_embedding.linear_2",
           "label_emb.0.0": "add_embedding.linear_1",
           "label_emb.0.2": "add_embedding.linear_2",
           "input_blocks.0.0": "conv_in",
           "out.0": "conv_norm_out",
           "out.2": "conv_out"}

    def res_rules(src, dst):
        for half_s, half_d in (("", ".spatial_res_block"),
                               (".time_stack", ".temporal_res_block")):
            ren[f"{src}{half_s}.in_layers.0"] = f"{dst}{half_d}.norm1"
            ren[f"{src}{half_s}.in_layers.2"] = f"{dst}{half_d}.conv1"
            ren[f"{src}{half_s}.emb_layers.1"] = \
                f"{dst}{half_d}.time_emb_proj"
            ren[f"{src}{half_s}.out_layers.0"] = f"{dst}{half_d}.norm2"
            ren[f"{src}{half_s}.out_layers.3"] = f"{dst}{half_d}.conv2"
            ren[f"{src}{half_s}.skip_connection"] = \
                f"{dst}{half_d}.conv_shortcut"
        ren[f"{src}.time_mixer"] = f"{dst}.time_mixer"

    def attn_rules(src, dst):
        # spatial transformer_blocks keep their names; the temporal
        # stack and pos-embed differ
        ren[src] = dst
        ren[f"{src}.time_stack"] = f"{dst}.temporal_transformer_blocks"
        ren[f"{src}.time_pos_embed.0"] = f"{dst}.time_pos_embed.linear_1"
        ren[f"{src}.time_pos_embed.2"] = f"{dst}.time_pos_embed.linear_2"

    idx = 1
    for i in range(n):
        for j in range(lpb):
            res_rules(f"input_blocks.{idx}.0",
                      f"down_blocks.{i}.resnets.{j}")
            if i < n - 1:
                attn_rules(f"input_blocks.{idx}.1",
                           f"down_blocks.{i}.attentions.{j}")
            idx += 1
        if i < n - 1:
            ren[f"input_blocks.{idx}.0.op"] = \
                f"down_blocks.{i}.downsamplers.0.conv"
            idx += 1
    res_rules("middle_block.0", "mid_block.resnets.0")
    attn_rules("middle_block.1", "mid_block.attentions.0")
    res_rules("middle_block.2", "mid_block.resnets.1")
    idx = 0
    for k in range(n):          # output_blocks.0 = coarsest level
        i = n - 1 - k           # resolution level
        has_attn = i < n - 1
        for j in range(lpb + 1):
            res_rules(f"output_blocks.{idx}.0",
                      f"up_blocks.{k}.resnets.{j}")
            if has_attn:
                attn_rules(f"output_blocks.{idx}.1",
                           f"up_blocks.{k}.attentions.{j}")
            if j == lpb and k < n - 1:
                m = 2 if has_attn else 1
                ren[f"output_blocks.{idx}.{m}.conv"] = \
                    f"up_blocks.{k}.upsamplers.0.conv"
            idx += 1
    # longest-prefix rename (rules are module paths; match at '.'
    # boundaries so e.g. input_blocks.1 does not eat input_blocks.10)
    rules = sorted(ren.items(), key=lambda kv: -len(kv[0]))
    out = {}
    for key, val in sd.items():
        for src, dst in rules:
            if key == src or key.startswith(src + "."):
                out[dst + key[len(src):]] = val
                break
        else:
            out[key] = val
    return out


def convert_m2svid_sgm(state_dict, cfg=None):
    """m2svid (sgm/Hi3D video LDM, reference m2svid_infill.py:485-488)
    full-model checkpoint -> our models.svd.SVDUNet params.

    The checkpoint wraps the denoiser under ``model.diffusion_model.``;
    that VideoUNet is architecturally the SVD spatio-temporal UNet with
    a conditioning-extended conv_in (noisy z + reprojected-view latent
    + mask, the reference's input_batch contract m2svid_infill.py:89-98),
    which our SVDConfig(in_channels=9) graph already is. The VAE and
    CLIP conditioner ship as stock SVD weights and load via
    convert_svd_vae / convert_clip_vision."""
    from metric_depth_video_toolbox_tpu_torch.models import svd as svdm
    cfg = cfg or svdm.SVDConfig()
    pref = "model.diffusion_model."
    unet_sd = {k[len(pref):]: v for k, v in state_dict.items()
               if k.startswith(pref)}
    if not unet_sd:      # bare VideoUNet state dict (no sgm wrapper)
        unet_sd = state_dict
    return convert_svd_unet(_sgm_video_unet_to_diffusers(unet_sd, cfg),
                            cfg)


def convert_stereocrafter(unet_sd, vae_sd, cfg=None, vae_cfg=None):
    """StereoCrafter release = SVD UNet fine-tune + SVD VAE (reference
    stereo_crafter_infill.py:97-99). Combines convert_svd_unet +
    convert_svd_vae into one models.svd.SVDInpainter param tree."""
    from metric_depth_video_toolbox_tpu_torch.models import svd as svd_mod
    cfg = cfg or svd_mod.SVDConfig()
    vae_cfg = vae_cfg or svd_mod.SVDVAEConfig()
    vae = convert_svd_vae(vae_sd, vae_cfg)
    return {"params": {
        "unet": convert_svd_unet(unet_sd, cfg)["params"],
        "vae_encoder": vae["encoder"]["params"],
        "vae_decoder": vae["decoder"]["params"],
    }}


def convert_clip_vision(state_dict, cfg):
    """HF transformers CLIPVisionModelWithProjection state dict (the SVD
    image-conditioning tower, e.g. laion CLIP-ViT-H-14) -> our
    models.clip.CLIPVisionTower params. Forward equivalence proven
    against the real transformers module in
    tests/test_weight_exact_clip.py. Note HF's attribute is spelled
    ``pre_layrnorm`` (typo preserved in their checkpoints)."""
    sd = state_dict
    vm = "vision_model."
    pre_key = (vm + "pre_layrnorm" if vm + "pre_layrnorm.weight" in sd
               else vm + "pre_layernorm")
    p = {
        "patch_embedding": {"kernel": _t(
            sd[vm + "embeddings.patch_embedding.weight"]
        ).transpose(2, 3, 1, 0)},
        "class_embedding": _t(sd[vm + "embeddings.class_embedding"]),
        "position_embedding": _t(
            sd[vm + "embeddings.position_embedding.weight"]),
        "pre_layernorm": layernorm(sd, pre_key),
        "post_layernorm": layernorm(sd, vm + "post_layernorm"),
        "visual_projection": {"kernel": _t(
            sd["visual_projection.weight"]).T},
    }
    for i in range(cfg.num_layers):
        b = f"{vm}encoder.layers.{i}"
        p[f"layer{i}"] = {
            "layer_norm1": layernorm(sd, f"{b}.layer_norm1"),
            "q_proj": linear(sd, f"{b}.self_attn.q_proj"),
            "k_proj": linear(sd, f"{b}.self_attn.k_proj"),
            "v_proj": linear(sd, f"{b}.self_attn.v_proj"),
            "out_proj": linear(sd, f"{b}.self_attn.out_proj"),
            "layer_norm2": layernorm(sd, f"{b}.layer_norm2"),
            "fc1": linear(sd, f"{b}.mlp.fc1"),
            "fc2": linear(sd, f"{b}.mlp.fc2"),
        }
    return {"params": p}


def convert_depthpro_hf(state_dict, cfg):
    """HF transformers DepthProForDepthEstimation state dict (e.g.
    apple/DepthPro-hf) -> our models.depthpro.DepthProNet params.
    Forward equivalence proven against the real transformers module in
    tests/test_weight_exact_depthpro.py (reference depthpro_video.py
    reads predicted_depth + focallength_px from this model)."""
    sd = state_dict
    p = {
        "patch_encoder": convert_dinov2_hf(
            sd, cfg.vit, prefix="depth_pro.encoder.patch_encoder.model."),
        "image_encoder": convert_dinov2_hf(
            sd, cfg.vit, prefix="depth_pro.encoder.image_encoder.model."),
    }
    up = "depth_pro.neck.feature_upsample."
    p["upsample_image"] = conv_transpose(sd, up + "image_block.layers.0")
    for i in range(len(cfg.scaled_images_ratios)):
        b = f"{up}scaled_images.{i}.layers"
        p[f"upsample_scaled{i}_proj"] = conv(sd, f"{b}.0")
        p[f"upsample_scaled{i}_up0"] = conv_transpose(sd, f"{b}.1")
    for i in range(len(cfg.intermediate_hook_ids)):
        b = f"{up}intermediate.{i}.layers"
        p[f"upsample_inter{i}_proj"] = conv(sd, f"{b}.0")
        for j in range(2 + i):
            p[f"upsample_inter{i}_up{j}"] = conv_transpose(
                sd, f"{b}.{j + 1}")
    p["fuse_low"] = conv(sd, "depth_pro.neck.fuse_image_with_low_res")
    n_levels = (len(cfg.scaled_images_ratios)
                + len(cfg.intermediate_hook_ids))
    dims = (list(cfg.scaled_images_feature_dims)
            + list(cfg.intermediate_feature_dims))
    for i in range(n_levels):
        if i == n_levels - 1 and dims[i] == cfg.fusion_hidden_size:
            continue  # HF Identity projection
        p[f"project{i}"] = conv(
            sd, f"depth_pro.neck.feature_projection.projections.{i}")
    for i in range(n_levels):
        fl = (f"fusion_stage.intermediate.{i}" if i < n_levels - 1
              else "fusion_stage.final")
        if i > 0:  # layer 0's residual_layer1 exists in HF but is unused
            p[f"fusion{i}_rcu1_conv1"] = conv(
                sd, fl + ".residual_layer1.convolution1")
            p[f"fusion{i}_rcu1_conv2"] = conv(
                sd, fl + ".residual_layer1.convolution2")
        p[f"fusion{i}_rcu2_conv1"] = conv(
            sd, fl + ".residual_layer2.convolution1")
        p[f"fusion{i}_rcu2_conv2"] = conv(
            sd, fl + ".residual_layer2.convolution2")
        if i < n_levels - 1:
            p[f"fusion{i}_deconv"] = conv_transpose(sd, fl + ".deconv")
        p[f"fusion{i}_project"] = conv(sd, fl + ".projection")
    p["head_conv1"] = conv(sd, "head.layers.0")
    p["head_deconv"] = conv_transpose(sd, "head.layers.1")
    p["head_conv2"] = conv(sd, "head.layers.2")
    p["head_conv3"] = conv(sd, "head.layers.4")
    if cfg.use_fov and "fov_model.conv.weight" in sd:
        p["fov_encoder"] = convert_dinov2_hf(
            sd, cfg.vit, prefix="fov_model.fov_encoder.model.")
        p["fov_neck"] = linear(sd, "fov_model.fov_encoder.neck")
        p["fov_conv"] = conv(sd, "fov_model.conv")
        for i in range(cfg.num_fov_head_layers):
            p[f"fov_head{i}"] = conv(sd, f"fov_model.head.layers.{2 * i}")
        p["fov_head_final"] = conv(
            sd, f"fov_model.head.layers.{2 * cfg.num_fov_head_layers}")
    return {"params": p}


def convert_torch_file(path, kind, cfg=None):
    """Load a torch checkpoint file (CPU) and convert by ``kind``, with the
    JAX package's dispatch. As there, ``cfg`` None reaches the converters
    that need one (``dinov2``, ``da2``, ``da2_hf``, ``promptda_hf``,
    ``vda``, ``svd_unet``, ``svd_vae``, ``clip_vision``), which then fail on
    ``cfg.<field>``; ``pmap_vae`` defaults to ``PMAP_VAE``."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}
    if kind == "dinov2":
        return convert_dinov2_vit(sd, cfg)
    if kind == "da2":
        return convert_da2(sd, cfg)
    if kind == "da3":
        from metric_depth_video_toolbox_tpu_torch.models import da3
        return convert_da3(sd, cfg or da3.DA3_L)
    if kind == "moge":
        from metric_depth_video_toolbox_tpu_torch.models import moge
        return convert_moge(sd, cfg or moge.MOGE_L)
    if kind == "unidepth":
        from metric_depth_video_toolbox_tpu_torch.models import unidepth
        return convert_unidepth(sd, cfg or unidepth.UNIDEPTH_L)
    if kind == "unik3d":
        from metric_depth_video_toolbox_tpu_torch.models import unidepth
        return convert_unik3d(sd, cfg or unidepth.UNIDEPTH_L)
    if kind in ("droid", "megasam"):
        return convert_droid(sd, cfg)
    if kind in ("wan", "inspatio_world"):
        from metric_depth_video_toolbox_tpu_torch.models import wan
        return convert_wan(sd, cfg or wan.WAN_1_3B)
    if kind == "da2_hf":
        return convert_da2_hf(sd, cfg)
    if kind == "promptda_hf":
        return convert_promptda_hf(sd, cfg)
    if kind == "raft":
        return convert_raft(sd, cfg)
    if kind == "u2net":
        return convert_u2net(sd, cfg)
    if kind in ("vda", "video_depth"):
        return convert_vda(sd, cfg)
    if kind == "svd_unet":
        return convert_svd_unet(sd, cfg)
    if kind in ("m2svid", "m2svid_sgm"):
        return convert_m2svid_sgm(sd, cfg)
    if kind == "svd_vae":
        return convert_svd_vae(sd, cfg)
    if kind == "pmap_vae":
        from metric_depth_video_toolbox_tpu_torch.models import svd as svdm
        return convert_svd_vae(sd, cfg or svdm.PMAP_VAE)
    if kind == "clip_vision":
        return convert_clip_vision(sd, cfg)
    if kind == "cotracker3":
        return convert_cotracker3(sd, cfg)
    if kind == "depthpro_hf":
        from metric_depth_video_toolbox_tpu_torch.models import depthpro
        return convert_depthpro_hf(sd, cfg or depthpro.DEPTHPRO_L)
    raise ValueError(f"unknown checkpoint kind: {kind}")


# --- weight registry (the JAX package's, from its download_weights) ----

WEIGHT_REGISTRY = {
    # "urls": direct-download sources (reference download_weights.py
    # MODELS table); "hf": a Hugging Face repo id fetched as a snapshot
    # (the reference git-clones the same repos). Both are DATA — the
    # downloader below works wherever the network allows and degrades
    # to local-file validation in zero-egress environments.
    "vda": {"kind": "video_depth", "files": [
        "video_depth_anything_vits.pth", "video_depth_anything_vitl.pth"],
        "urls": [
            "https://huggingface.co/depth-anything/Video-Depth-Anything"
            "-Small/resolve/main/video_depth_anything_vits.pth",
            "https://huggingface.co/depth-anything/Video-Depth-Anything"
            "-Large/resolve/main/video_depth_anything_vitl.pth"]},
    "da_v2_metric": {"kind": "dinov2", "files": [
        "depth_anything_v2_metric_hypersim_vitl.pth"],
        "urls": [
            "https://huggingface.co/depth-anything/Depth-Anything-V2-"
            "Metric-Hypersim-Large/resolve/main/"
            "depth_anything_v2_metric_hypersim_vitl.pth"]},
    "da3": {"kind": "da3", "files": ["da3nested-giant-large"],
            "hf": "depth-anything/DA3NESTED-GIANT-LARGE"},
    "moge": {"kind": "moge", "files": ["moge-vitl"],
             "hf": "Ruicheng/moge-vitl"},
    "unidepth": {"kind": "unidepth", "files": ["unidepth-v2-vitl14"],
                 "hf": "lpiccinelli/unidepth-v2-vitl14"},
    "unik3d": {"kind": "unik3d", "files": ["unik3d-vitl"],
               "hf": "lpiccinelli/unik3d-vitl"},
    "inspatio_world": {"kind": "wan", "files": [
        "InSpatio-World-1.3B.safetensors"],
        "urls": ["https://huggingface.co/inspatio/world/resolve/main/"
                 "InSpatio-World-1.3B.safetensors"]},
    "raft": {"kind": "raft", "files": ["raft-large.pth"],
             "urls": ["https://github.com/sczhou/ProPainter/releases/"
                      "download/v0.1.0/raft-things.pth"]},
    "stereocrafter": {"kind": "svd_unet", "files": ["stereocrafter"],
                      "hf": "TencentARC/StereoCrafter"},
    # m2svid ships an sgm/Hi3D full-model checkpoint (reference
    # m2svid_infill.py:487); the denoiser maps onto our SVDUNet via
    # convert_m2svid_sgm, VAE/CLIP are stock SVD weights
    "m2svid": {"kind": "m2svid_sgm", "files": ["m2svid_weights.pt"],
               "urls": ["https://storage.googleapis.com/gresearch/"
                        "m2svid/m2svid_weights.pt"]},
    # DepthCrafter / GeometryCrafter are SVD fine-tunes: same UNet+VAE
    # layout, converted by the stereocrafter converters and loaded into
    # pipeline.depth.{DepthCrafter,GeometryCrafter}Engine(cfg=SVDConfig())
    "depthcrafter": {"kind": "svd_unet", "files": ["DepthCrafter"],
                     "hf": "tencent/DepthCrafter"},
    "geometrycrafter": {"kind": "svd_unet", "files": ["GeometryCrafter"],
                        "hf": "TencentARC/GeometryCrafter"},
    # the dedicated point-map VAE (TencentARC/GeometryCrafter,
    # subfolder point_map_vae — reference geometrycrafter_video.py:311)
    "geometrycrafter_pmap_vae": {
        "kind": "pmap_vae", "files": ["GeometryCrafter/point_map_vae"],
        "hf": "TencentARC/GeometryCrafter"},
    "u2net": {"kind": "u2net", "files": ["u2net.onnx"],
              "urls": ["https://github.com/danielgatis/rembg/releases/"
                       "download/v0.0.0/u2net.onnx"]},
    "cotracker3": {"kind": "cotracker3", "files": ["scaled_offline.pth"],
                   "urls": ["https://huggingface.co/facebook/cotracker3/"
                            "resolve/main/scaled_offline.pth"]},
    # the Mega-SAM tracker net (reference sam_track_video.py:171)
    "megasam": {"kind": "droid", "files": ["megasam_final.pth"],
                "urls": ["https://github.com/mega-sam/mega-sam/raw/main/"
                         "checkpoints/megasam_final.pth"]},
    "depthpro": {"kind": "depthpro_hf", "files": ["DepthPro-hf"],
                 "hf": "apple/DepthPro-hf"},
    "clip_vith": {"kind": "clip_vision", "files": [
        "CLIP-ViT-H-14-laion2B-s32B-b79K"],
        "hf": "laion/CLIP-ViT-H-14-laion2B-s32B-b79K"},
}


def weight_sources(name):
    """(urls, hf_repo_or_None) for a registry entry — the download
    plan, exposed for --dry_run and tests."""
    entry = WEIGHT_REGISTRY[name]
    return list(entry.get("urls", ())), entry.get("hf")


def download_weights(name, dest_dir="weights", dry_run=False,
                     _urlretrieve=None, _snapshot=None):
    """Reference download_weights.py equivalent: fetch the published
    checkpoints for ``name`` into ``dest_dir`` (direct URLs via urllib,
    Hugging Face repos via huggingface_hub snapshots), skipping files
    already present. In zero-egress environments behaves as before —
    validates local presence and names what is missing and from where.
    ``dry_run`` prints the plan without touching the network.
    ``_urlretrieve``/``_snapshot`` are test seams."""
    os.makedirs(dest_dir, exist_ok=True)
    entry = WEIGHT_REGISTRY[name]
    urls, hf_repo = weight_sources(name)
    missing = [f for f in entry["files"]
               if not os.path.exists(os.path.join(dest_dir, f))]
    if not missing:
        return [os.path.join(dest_dir, f) for f in entry["files"]]
    if dry_run:
        for u in urls:
            print(f"would download {u}")
        if hf_repo:
            print(f"would snapshot https://huggingface.co/{hf_repo}")
        return []
    errors = []
    for i, u in enumerate(urls):
        # urls pair positionally with files when the counts match;
        # otherwise the url's basename is the local name
        target = os.path.join(
            dest_dir, entry["files"][i] if len(urls) == len(entry["files"])
            else os.path.basename(u))
        if os.path.exists(target):
            continue
        try:
            import urllib.request
            fetch = _urlretrieve or urllib.request.urlretrieve
            print(f"downloading {u} -> {target}")
            fetch(u, target + ".part")
            os.replace(target + ".part", target)
        except Exception as e:
            errors.append(f"{u}: {e}")
    if hf_repo:
        folder = os.path.join(dest_dir, entry["files"][0].split("/")[0])
        if not os.path.exists(folder):
            try:
                if _snapshot is None:
                    from huggingface_hub import snapshot_download
                else:
                    snapshot_download = _snapshot
                print(f"snapshotting {hf_repo} -> {folder}")
                snapshot_download(repo_id=hf_repo, local_dir=folder)
            except Exception as e:
                errors.append(f"{hf_repo}: {e}")
    missing = [f for f in entry["files"]
               if not os.path.exists(os.path.join(dest_dir, f))]
    if missing:
        raise FileNotFoundError(
            f"weights for '{name}' not present locally: {missing}"
            + (f" (download errors: {'; '.join(errors)})" if errors
               else "") +
            f". Place the torch checkpoints in {dest_dir}/ and run "
            f"models.convert.convert_torch_file on them.")
    return [os.path.join(dest_dir, f) for f in entry["files"]]


