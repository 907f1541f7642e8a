"""What the engine adapters share: seeded weights made on the device, and
the check that the program built its models at the configuration's
widths."""

from __future__ import annotations

import math

import torch


def meta_state_shapes(build):
    """The (name, shape) of every parameter and persistent buffer of the
    module that ``build()`` makes, without allocating it."""
    with torch.device("meta"):
        mod = build()
    return [(k, tuple(v.shape)) for k, v in mod.state_dict().items()]


@torch.no_grad()
def seeded_state(shapes, gen, device, layerscale_init=1.0):
    """A state dict drawn on the device in one call: LeCun-normal matrices
    and kernels (std 1 / sqrt(fan in)), N(0, 0.02) position embeddings,
    unit norm scales, ``layerscale_init`` layer scales, zero biases and
    class tokens (the initializers of the port's ``seeded_init``), float32,
    the type the engines hold their parameters in."""
    normal = [(k, s) for k, s in shapes
              if (k.endswith(".weight") and len(s) >= 2)
              or k.endswith("pos_embed")]
    total = sum(math.prod(s) for _, s in normal)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    state, at = {}, 0
    for k, s in normal:
        n = math.prod(s)
        std = 0.02 if k.endswith("pos_embed") else 1.0 / math.sqrt(
            n // s[0])
        state[k] = flat[at:at + n].view(s).mul_(std)
        at += n
    for k, s in shapes:
        if k in state:
            continue
        if k.endswith(".weight"):
            state[k] = torch.ones(s, device=device)
        elif k.endswith(".gamma"):
            state[k] = torch.full(s, float(layerscale_init), device=device)
        else:
            state[k] = torch.zeros(s, device=device)
    return state


def vit_config(base, vit, dtype):
    """The port's ViT config ``base`` at the widths of the configuration
    file's ``vit`` block (the same values at the published widths)."""
    import dataclasses
    kw = dict(patch_size=vit["patch_size"], embed_dim=vit["embed_dim"],
              depth=vit["depth"], num_heads=vit["num_heads"],
              mlp_ratio=vit["mlp_ratio"],
              out_indices=tuple(vit["out_indices"]), dtype=dtype)
    if "cross_view_indices" in vit:
        kw["cross_view_indices"] = tuple(vit["cross_view_indices"])
    return dataclasses.replace(base, **kw)


def weight_generator(seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2654435761 + 97) % 2 ** 64)
    return gen


def expect_shapes(module, want):
    """Raise unless each named tensor of ``module``'s state has the shape
    ``want`` gives it."""
    have = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    bad = {k: (have.get(k), tuple(s)) for k, s in want.items()
           if have.get(k) != tuple(s)}
    if bad:
        raise RuntimeError(f"the program built its model at other widths "
                           f"than the configuration states: {bad}")


def vit_shapes(prefix, vit):
    d = vit["embed_dim"]
    hidden = int(d * vit["mlp_ratio"])
    last = vit["depth"] - 1
    want = {}
    for i in (0, last):
        b = f"{prefix}block{i}."
        want[b + "attn.qkv.weight"] = (3 * d, d)
        want[b + "attn.proj.weight"] = (d, d)
        want[b + "mlp.fc1.weight"] = (hidden, d)
        want[b + "mlp.fc2.weight"] = (d, hidden)
    want[prefix + "patch_embed.weight"] = (d, 3, vit["patch_size"],
                                           vit["patch_size"])
    return want


def expect_depth(module, prefix, depth):
    """Raise unless the ViT under ``prefix`` has ``depth`` blocks."""
    names = module.state_dict().keys()
    have = {k[len(prefix):].split(".")[0] for k in names
            if k.startswith(prefix + "block")}
    if len(have) != depth:
        raise RuntimeError(f"{prefix}: {len(have)} blocks, the "
                           f"configuration states {depth}")


def dpt_shapes(prefix, dpt, embed_dim, n_out=1):
    f, ch = dpt["features"], dpt["out_channels"]
    want = {}
    for i, c in enumerate(ch):
        want[f"{prefix}project{i}.weight"] = (c, embed_dim, 1, 1)
        want[f"{prefix}scratch{i}.weight"] = (f, c, 3, 3)
    want[prefix + "fusion0.rcu1.conv1.weight"] = (f, f, 3, 3)
    want[prefix + "head_conv1.weight"] = (f // 2, f, 3, 3)
    want[prefix + "head_conv2.weight"] = (32, f // 2, 3, 3)
    want[prefix + "head_conv3.weight"] = (n_out, 32, 1, 1)
    return want

