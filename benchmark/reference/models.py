"""The plain reference of the depth models, in float32: the DINOv2 ViT
(with DA3's cross-view blocks), the DPT head, Video Depth Anything's
temporal head and DA3's dual head with its closed-form camera solve.

Written as functions of a state dict whose names are the port's module
names (``backbone.block3.attn.qkv.weight``), so the benchmark hands both
sides the same tensors. The arithmetic follows the published graphs as the
configuration files state them (``assumed``: the DPT decode with
half-pixel bilinear resizes and the 3 x 3 head convolutions before the last
upsample), with every product in float32 and TF32 off. It imports nothing
of the port.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
GN_EPS = 1e-6
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SCALES = (4, 2, 1, 0.5)


# the control's precision: None (float32), or "fp8" inside
# ``float8_operands()``
_PRECISION = {"mode": None}


@contextlib.contextmanager
def float8_operands():
    """The control: every linear and convolution rounds its input (per
    row, over the channels) and its weight (per output channel) to float8
    e4m3 with an absolute-maximum scale, one precision below bfloat16."""
    _PRECISION["mode"] = "fp8"
    try:
        yield
    finally:
        _PRECISION["mode"] = None


def _fp8(t, dim):
    s = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _operands(x, w, x_dim):
    if _PRECISION["mode"] != "fp8":
        return x, w
    return _fp8(x, x_dim), _fp8(w, tuple(range(1, w.ndim)))


def no_tf32():
    """Every float32 product in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _attention(q, k, v):
    """Softmax attention over (B, H, N, d) in float32; a long sequence
    without its (N, N) scores in memory (the memory-efficient kernel on
    the card)."""
    if q.is_cuda and q.shape[-2] >= 1024:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q, k, v)
    return F.scaled_dot_product_attention(q, k, v)


def linear(sd, name, x, bias=True):
    x, w = _operands(x, sd[name + ".weight"], -1)
    return F.linear(x, w, sd[name + ".bias"] if bias else None)


def layer_norm(sd, name, x):
    return F.layer_norm(x, (x.shape[-1],), sd[name + ".weight"],
                        sd[name + ".bias"], LN_EPS)


def conv(sd, name, x, bias=True, stride=1):
    """NHWC convolution, 'SAME' padding at stride 1."""
    w = sd[name + ".weight"]
    k = w.shape[-1]
    if stride == 1 and k > 1:
        lo = (k - 1) // 2
        pad = (lo, k - 1 - lo, lo, k - 1 - lo)
    else:
        pad = (0, 0, 0, 0)
    x, w = _operands(x, w, -1)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pad), w,
                 sd[name + ".bias"] if bias else None, stride=stride)
    return y.permute(0, 2, 3, 1)


def resize_nchw(x, out_hw):
    """Bilinear, half-pixel centres, antialiased when a side shrinks."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == tuple(x.shape[-2:]):
        return x
    shrink = oh < x.shape[-2] or ow < x.shape[-1]
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=False, antialias=shrink)


def resize_nhwc(x, hw):
    return resize_nchw(x.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


# -- the ViT -------------------------------------------------------------------

def vit(sd, p, images, widths, view_group=None):
    """images (B, H, W, 3) in [0, 1] -> the four normed feature maps
    (B, gh, gw, D) at ``out_indices``. ``widths``: the configuration's
    vit block. The blocks of ``cross_view_indices`` attend over the
    concatenated tokens of each group of ``view_group`` views."""
    ps, d = widths["patch_size"], widths["embed_dim"]
    heads, depth = widths["num_heads"], widths["depth"]
    cross = set(widths.get("cross_view_indices", ()))
    b, h, w, _ = images.shape
    gh, gw = h // ps, w // ps
    dev = images.device
    mean = torch.tensor(MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(STD, dtype=torch.float32, device=dev)
    x = (images - mean) / std
    x, wp = _operands(x, sd[p + "patch_embed.weight"], -1)
    x = F.conv2d(x.permute(0, 3, 1, 2), wp, sd[p + "patch_embed.bias"],
                 stride=ps)
    x = x.permute(0, 2, 3, 1).reshape(b, gh * gw, d)
    x = torch.cat([sd[p + "cls_token"].expand(b, 1, d), x], 1)
    x = x + sd[p + "pos_embed"]
    n = gh * gw + 1
    hd = d // heads
    feats = {}
    for i in range(depth):
        q = f"{p}block{i}."
        y = layer_norm(sd, q + "norm1", x)
        group = view_group if (view_group and view_group > 1
                               and i in cross) else 1
        yb = y.reshape(b // group, group * n, d)
        qkv = linear(sd, q + "attn.qkv", yb)
        qq, kk, vv = qkv.reshape(b // group, group * n, 3, heads, hd) \
            .permute(2, 0, 3, 1, 4).unbind(0)
        att = _attention(qq, kk, vv).transpose(1, 2).reshape(
            b // group, group * n, d)
        att = linear(sd, q + "attn.proj", att).reshape(b, n, d)
        x = x + att * sd[q + "ls1.gamma"]
        y = layer_norm(sd, q + "norm2", x)
        y = linear(sd, q + "mlp.fc2", F.gelu(linear(sd, q + "mlp.fc1", y)))
        x = x + y * sd[q + "ls2.gamma"]
        if i in widths["out_indices"]:
            feats[i] = layer_norm(sd, p + "norm", x)
    return [feats[i][:, 1:].reshape(b, gh, gw, d)
            for i in widths["out_indices"]]


# -- the DPT head ----------------------------------------------------------------

def _rcu(sd, p, x):
    y = conv(sd, p + ".conv1", torch.relu(x))
    return x + conv(sd, p + ".conv2", torch.relu(y))


def _fusion(sd, p, x, skip=None, out_hw=None):
    if skip is not None:
        x = x + _rcu(sd, p + ".rcu1", skip)
    x = _rcu(sd, p + ".rcu2", x)
    if out_hw is not None:
        x = resize_nhwc(x, out_hw)
    return conv(sd, p + ".project", x)


def _pyramid(sd, p, feats, between_levels=None):
    """Project and move the four levels to x4, x2, x1, x0.5 of the grid;
    ``between_levels(i, y)`` on levels 2 and 3 before their 3 x 3 conv."""
    _, gh, gw, _ = feats[0].shape
    pyr = []
    for i, f in enumerate(feats):
        y = conv(sd, f"{p}project{i}", f)
        y = resize_nhwc(y, (int(gh * SCALES[i]), int(gw * SCALES[i])))
        if between_levels is not None and i >= 2:
            y = between_levels(i - 2, y)
        pyr.append(conv(sd, f"{p}scratch{i}", y, bias=False))
    return pyr


def _fuse(sd, p, pyr, between=None):
    def hook(i, x):
        return between(i, x) if between is not None else x
    x = hook(0, _fusion(sd, p + "fusion3", pyr[3],
                        out_hw=pyr[2].shape[1:3]))
    x = hook(1, _fusion(sd, p + "fusion2", x, skip=pyr[2],
                        out_hw=pyr[1].shape[1:3]))
    x = _fusion(sd, p + "fusion1", x, skip=pyr[1], out_hw=pyr[0].shape[1:3])
    return _fusion(sd, p + "fusion0", x, skip=pyr[0])


def dpt_head(sd, p, feats, patch, act):
    """-> (B, gh * patch, gw * patch, n_out) after ``act``."""
    _, gh, gw, _ = feats[0].shape
    x = conv(sd, p + "head_conv1", _fuse(sd, p, _pyramid(sd, p, feats)))
    x = conv(sd, p + "head_conv3",
             torch.relu(conv(sd, p + "head_conv2", x)))
    x = resize_nhwc(x, (gh * patch, gw * patch))
    return torch.relu(x) if act == "relu" else x


# -- Video Depth Anything's temporal head ------------------------------------------

def _sinusoidal_pe(t, d, dev):
    pos = np.arange(t, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float32)
                 * (-np.log(10000.0) / d))
    pe = np.zeros((t, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: (d + 1) // 2])
    return torch.from_numpy(pe).to(dev)


def _temporal_attention(sd, p, x, heads):
    """x (N, T, C): attention across the frame axis of each token."""
    n, t, c = x.shape
    x = x + _sinusoidal_pe(t, c, x.device)

    def split(y):
        return y.reshape(n, t, heads, c // heads).transpose(1, 2)
    out = _attention(split(linear(sd, p + ".to_q", x, bias=False)),
                     split(linear(sd, p + ".to_k", x, bias=False)),
                     split(linear(sd, p + ".to_v", x, bias=False)))
    return linear(sd, p + ".to_out", out.transpose(1, 2).reshape(n, t, c))


def temporal_module(sd, p, x, heads, groups, layers=1, token_block=8192):
    """GroupNorm -> proj_in -> blocks of two temporal attentions and a
    GEGLU feed-forward -> proj_out -> residual, over (T, H, W, C); the
    tokens in blocks of ``token_block``."""
    t, h, w, c = x.shape
    y = F.group_norm(x.permute(0, 3, 1, 2), min(groups, c),
                     sd[p + ".norm.weight"], sd[p + ".norm.bias"],
                     GN_EPS).permute(0, 2, 3, 1)
    y = linear(sd, p + ".proj_in", y.reshape(t, h * w, c)).transpose(0, 1)
    out = []
    for s in range(0, h * w, token_block):
        z = y[s:s + token_block]
        for j in range(layers):
            q = f"{p}.block{j}"
            for a in range(2):
                z = z + _temporal_attention(
                    sd, f"{q}.attn{a}", layer_norm(sd, f"{q}.norm{a}", z),
                    heads)
            hh, gate = linear(sd, q + ".geglu",
                              layer_norm(sd, q + ".ff_norm", z)).chunk(2, -1)
            z = z + linear(sd, q + ".ff_out", hh * F.gelu(gate))
        out.append(z)
    y = linear(sd, p + ".proj_out", torch.cat(out).transpose(0, 1))
    return y.reshape(t, h, w, c) + x


def vda_forward(sd, frames, cfg):
    """frames (T, h, w, 3) in [0, 1] -> (T, h, w) relative disparity."""
    vit_w, head = cfg["vit"], cfg["temporal"]
    feats = vit(sd, "backbone.", frames, vit_w)
    heads, groups = head["heads"], head["norm_groups"]
    p = "head."

    def motion(i, y):
        return temporal_module(sd, f"{p}motion{i}", y, heads, groups)
    _, gh, gw, _ = feats[0].shape
    pyr = _pyramid(sd, p, feats, motion)
    x = _fuse(sd, p, pyr, lambda i, x: motion(i + 2, x))
    x = conv(sd, p + "head_conv1", x)
    ps = vit_w["patch_size"]
    x = resize_nhwc(torch.relu(conv(sd, p + "head_conv2", x)),
                    (gh * ps, gw * ps))
    return torch.relu(conv(sd, p + "head_conv3", x))[..., 0]


def depth_anything_metric(sd, images, cfg):
    """images (B, h, w, 3) in [0, 1] -> (B, h, w) metric depth: the relu
    head clipped to [0, max_depth]."""
    feats = vit(sd, "backbone.", images, cfg["vit"])
    out = dpt_head(sd, "head.", feats, cfg["vit"]["patch_size"], "relu")
    return torch.clamp(out[..., 0], 0.0, cfg["max_depth"])


# -- DA3 ------------------------------------------------------------------------------

def rigid_rotation(source, target):
    """The rotation about the origin that maps (V, N, 3) ``source`` onto
    ``target`` in the least-squares sense (Kabsch), (V, 3, 3)."""
    hm = torch.einsum("vni,vnj->vij", source, target)
    u, _, vt = torch.linalg.svd(hm)
    det = torch.linalg.det(torch.einsum("vji,vkj->vik", vt, u))
    flip = torch.cat([torch.ones(det.shape + (2,), dtype=torch.float32,
                                 device=det.device), det[..., None]], -1)
    return torch.einsum("vji,vj,vkj->vik", vt, flip, u)


def cameras_from_raymap(rays, img_w, min_focal_frac=0.1):
    """(V, h, w, 6) ray origins and directions -> (w2c (V, 4, 4), x-FOV in
    degrees (V,)): the centre as the mean origin, the focal by least
    squares on the angle to the mean direction, the rotation by Kabsch from
    the canonical rays at that focal."""
    v, h, w, _ = rays.shape
    dev = rays.device
    o = rays[..., :3].reshape(v, h * w, 3)
    d = rays[..., 3:6].reshape(v, h * w, 3)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-6)
    center = torch.mean(o, dim=1)
    z = torch.mean(d, dim=1)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1e-6)
    sx = img_w / w
    uu = (torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2) * sx
    vv = (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2) * sx
    du = uu[None, :].expand(h, w).reshape(-1)
    dv = vv[:, None].expand(h, w).reshape(-1)
    r = torch.sqrt(du * du + dv * dv)
    cos = torch.clamp(torch.einsum("vnc,vc->vn", d, z), -1.0, 1.0)
    tan = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0)) \
        / torch.clamp(cos, min=1e-3)
    f = (torch.sum(r * r[None] * tan, dim=1)
         / torch.clamp(torch.sum(r * tan * tan, dim=1), min=1e-6))
    f = torch.clamp(f, min=min_focal_frac * img_w)
    g = torch.stack([du[None].expand(v, -1) / f[:, None],
                     dv[None].expand(v, -1) / f[:, None],
                     torch.ones((v, h * w), dtype=torch.float32, device=dev)],
                    dim=-1)
    g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    r_w2c = rigid_rotation(g, d).transpose(1, 2)
    w2c = torch.eye(4, dtype=torch.float32, device=dev).repeat(v, 1, 1)
    w2c[:, :3, :3] = r_w2c
    w2c[:, :3, 3] = -torch.einsum("vij,vj->vi", r_w2c, center)
    xfov = 2.0 * torch.rad2deg(torch.atan2(
        torch.full_like(f, img_w / 2.0), f))
    return w2c, xfov


def da3_forward(sd, frames, cfg):
    """frames (V, h, w, 3) in [0, 1], one window of views -> (depth
    (V, h, w), w2c (V, 4, 4), xfov (V,))."""
    vit_w = cfg["vit"]
    ps = vit_w["patch_size"]
    v = frames.shape[0]
    feats = vit(sd, "backbone.", frames, vit_w, view_group=v)
    depth = dpt_head(sd, "head.depth.", feats, ps, "relu")[..., 0]
    depth = torch.clamp(depth, 0.0, cfg["engine"]["max_depth"])
    rays = dpt_head(sd, "head.ray.", feats, ps, "none")
    gh, gw = rays.shape[1] // ps, rays.shape[2] // ps
    pooled = rays.reshape(v, gh, ps, gw, ps, 6).mean(dim=(2, 4))
    w2c, xfov = cameras_from_raymap(pooled, float(rays.shape[2]))
    return depth, w2c, xfov


def tokens(work_hw, patch):
    return (work_hw[0] // patch) * (work_hw[1] // patch) + 1


def working_resolution(h, w, input_size, patch):
    """Aspect kept, the short side at ``input_size``, snapped to patches."""
    scale = input_size / min(h, w)
    nh = max(patch, int(round(h * scale / patch)) * patch)
    nw = max(patch, int(round(w * scale / patch)) * patch)
    return nh, nw
