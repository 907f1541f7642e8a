"""Flash attention over the packed qkv projection (port of
``ops/attention_pallas.py`` B4).

:func:`packed_flash_attention` launches the hand-written CUDA kernel
``csrc/packed_flash_attention.cu`` on CUDA tensors and runs
:func:`packed_flash_attention_plain`, a dense softmax over the valid keys in
float32, on CPU tensors. There is no fallback between the two: a CUDA
tensor launches the kernel or raises.

Contract (the JAX kernel's): qkv4 (B, N, 3H, D) is the qkv projection's
output through a free reshape, index along dim 2 = role * H + head (role
0/1/2 = q/k/v); valid (N,) marks real tokens and is shared by the batch.
Keys at invalid positions are left out of every softmax; queries are not
masked, so a pad query's row is finite and the caller slices it off.
Returns (B, N, H, D), which reshapes freely to (B, N, H * D). The kernel
bounds the ragged tail itself, so N needs no multiple; the ViT pads its
token axis to :data:`PAD_MULTIPLE` all the same.

In bfloat16 the kernel is the wgmma + TMA core of ``csrc/flash_sm90.cuh``
at head dim 64 or 128, reading q, k and v in place from qkv4. What it is
given is prepared by plain functions the CPU tests reach:
:func:`key_tile_classes` (which 128-key tiles to skip, take whole or
mask), :func:`key_bits` (the validity as a bitmap, for the masked tiles)
and ``blockcausal.pad_head_dim`` (zero columns up to the core's head dim,
a copy of qkv4 that only narrow test models take).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from metric_depth_video_toolbox_tpu_torch.ops.blockcausal import (
    KERNEL_DTYPES, KEY_TILE, error_ratio, kernel_head_dim, pad_head_dim)

__all__ = ["LAUNCHES", "PAD_MULTIPLE", "error_ratio", "key_bits",
           "key_tile_classes", "packed_flash_attention",
           "packed_flash_attention_plain"]

# kernel launches by wrapper name; the wrapper adds one per launch
LAUNCHES = {"packed_flash_attention": 0}

# The ViT pads each view's tokens to this multiple, which divides the
# kernel's 128-key tile (kBK in csrc/flash_sm90.cuh): a view's pads are one
# run at its end, so a key tile is all valid, or mixed where a view ends
# inside it or a run of pads starts. At DA3_L's 2305 tokens per view (2368
# padded) that is about one mixed tile per view, 52 of 962 in a cross-view
# sequence; the rest take the unmasked path. The pad sets the token count
# of every ViT layer: 64 adds 63 rows per view where 128 would add 127.
# The JAX package pads to 512, the TPU compiler's block.
PAD_MULTIPLE = 64

# elements of the score matrix per chunk (of heads, or of one head's query
# rows) in the plain version
_PLAIN_CHUNK = 1 << 28


def packed_flash_attention_plain(qkv4, valid, num_heads, sm_scale):
    """Dense attention over the valid keys in float32; returns qkv4's
    dtype. Chunked over heads (and, when one head's scores exceed 2**28
    elements, over its query rows). A sequence with no valid key gives
    zeros, as the kernel does."""
    b, n, three_h, d = qkv4.shape
    h = num_heads
    out = torch.zeros((b, n, h, d), dtype=qkv4.dtype, device=qkv4.device)
    keys = torch.nonzero(valid.reshape(-1) != 0).reshape(-1)
    nk = keys.numel()
    if nk == 0 or n == 0:
        return out
    heads = max(1, min(h, _PLAIN_CHUNK // max(n * nk, 1)))
    rows = n if heads > 1 or n * nk <= _PLAIN_CHUNK \
        else max(1, _PLAIN_CHUNK // nk)
    for bi in range(b):
        for h0 in range(0, h, heads):
            h1 = min(h0 + heads, h)
            # (heads, D, NK) and (heads, NK, D) of the valid keys
            kc = qkv4[bi, :, h + h0:h + h1].index_select(0, keys) \
                .float().permute(1, 2, 0)
            vc = qkv4[bi, :, 2 * h + h0:2 * h + h1].index_select(0, keys) \
                .float().permute(1, 0, 2)
            for r in range(0, n, rows):
                q = qkv4[bi, r:r + rows, h0:h1].float().permute(1, 0, 2)
                p = torch.softmax(torch.matmul(q, kc) * sm_scale, dim=-1)
                out[bi, r:r + rows, h0:h1] = torch.matmul(p, vc) \
                    .permute(1, 0, 2).to(qkv4.dtype)
    return out


def key_tile_classes(valid, tile=KEY_TILE):
    """-> int8 (ceil(N / tile),) class of each key tile under ``valid``
    (N,): 0 = no valid key (the kernel skips it), 1 = every key valid (no
    mask), 2 = mixed (masked by column). A tile reaching past N counts the
    missing keys as invalid."""
    n = valid.numel()
    ok = F.pad(valid.reshape(-1) != 0, (0, (-n) % tile)).reshape(-1, tile)
    return torch.where(ok.all(1), 1, torch.where(ok.any(1), 2, 0)).to(
        torch.int8)


def key_bits(valid, tile=KEY_TILE):
    """-> uint8 bitmap of ``valid`` (N,): bit b of byte i is key 8 i + b,
    zero-padded to whole key tiles (16 bytes per 128-key tile), which the
    kernel reads as four 32-bit words per tile."""
    n = valid.numel()
    ok = F.pad(valid.reshape(-1) != 0, (0, (-n) % tile)).view(-1, 8)
    weight = 1 << torch.arange(8, dtype=torch.int32, device=valid.device)
    return (ok.to(torch.int32) * weight).sum(1).to(torch.uint8)


def _check_args(qkv4, valid, num_heads):
    if qkv4.ndim != 4 or qkv4.shape[2] != 3 * num_heads:
        raise ValueError(f"qkv4 must be (B, N, 3 * {num_heads}, D), got "
                         f"{tuple(qkv4.shape)}")
    if qkv4.dtype not in KERNEL_DTYPES:
        raise ValueError(f"qkv4 must be bfloat16 or float32, got "
                         f"{qkv4.dtype}")
    b, n, _, d = qkv4.shape
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 16 "
                         f"up to 128")
    if tuple(valid.shape) != (n,):
        raise ValueError(f"valid must be ({n},), got {tuple(valid.shape)}")


def packed_flash_attention(qkv4, valid, num_heads, sm_scale):
    """Attention over packed qkv4 (B, N, 3H, D) under the key-validity
    vector ``valid`` (N,) bool or integer -> (B, N, H, D). CPU tensors run
    :func:`packed_flash_attention_plain`; CUDA tensors launch the kernel
    (bfloat16 or float32, D a multiple of 16 up to 128, one launch for
    every (b, h), q, k and v read in place at their stride of 3 * H * D)
    and count it in ``LAUNCHES``. In bfloat16 a head dim other than 64 or
    128 is zero-padded to one of them: a copy of qkv4, which only narrow
    test models take (every production ViT has heads of 64)."""
    if qkv4.device != valid.device:
        raise ValueError(f"arguments on several devices: {qkv4.device}, "
                         f"{valid.device}")
    dev = qkv4.device
    if dev.type == "cpu":
        return packed_flash_attention_plain(qkv4, valid, num_heads, sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"packed_flash_attention runs on cuda or cpu, not "
                         f"{dev}")
    _check_args(qkv4, valid, num_heads)
    b, n, _, d = qkv4.shape
    classes = bits = None
    dk = d
    if qkv4.dtype == torch.bfloat16:
        dk = kernel_head_dim(d)
        qkv4 = pad_head_dim(qkv4, dk)
        classes, bits = key_tile_classes(valid), key_bits(valid)
    qkv4 = qkv4.contiguous()
    if qkv4.data_ptr() % 16:
        qkv4 = qkv4.clone()
    ok = valid.to(torch.int32).contiguous()
    out = torch.empty((b, n, num_heads, dk), dtype=qkv4.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().mdvt_packed_flash_attention(
            qkv4.data_ptr(), ok.data_ptr(),
            None if bits is None else bits.data_ptr(),
            None if classes is None else classes.data_ptr(), out.data_ptr(),
            b, n, num_heads, dk, float(sm_scale), KERNEL_DTYPES[qkv4.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"packed_flash_attention kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["packed_flash_attention"] += 1
    return out if dk == d else out[..., :d]


def _library():
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    lib = cuda_build.load("packed_flash_attention")
    fn = lib.mdvt_packed_flash_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib
