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
"""

from __future__ import annotations

import ctypes

import torch

from metric_depth_video_toolbox_tpu_torch.ops.blockcausal import (
    KERNEL_DTYPES, error_ratio)

__all__ = ["LAUNCHES", "PAD_MULTIPLE", "error_ratio",
           "packed_flash_attention", "packed_flash_attention_plain"]

# kernel launches by wrapper name; the wrapper adds one per launch
LAUNCHES = {"packed_flash_attention": 0}

# The kernel's query and key tile (kBQ = kBK = 64 in the source). A ViT that
# pads each view's tokens to this multiple starts every view of a cross-view
# sequence on a tile boundary: no query tile straddles two views, and each
# view holds exactly one key tile that needs the per-column mask (the
# others are all valid and take the unmasked path). The JAX package pads to
# 512, the TPU compiler's block; here that would only add rows.
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
    if b * num_heads > 65535:
        raise ValueError(f"B * H = {b * num_heads}: the kernel's grid takes "
                         f"at most 65535 (batch, head) pairs per launch")


def packed_flash_attention(qkv4, valid, num_heads, sm_scale):
    """Attention over packed qkv4 (B, N, 3H, D) under the key-validity
    vector ``valid`` (N,) bool or integer -> (B, N, H, D). CPU tensors run
    :func:`packed_flash_attention_plain`; CUDA tensors launch the kernel
    (bfloat16 or float32, D a multiple of 16 up to 128, one launch for
    every (b, h), q, k and v read in place at their stride of 3 * H * D)
    and count it in ``LAUNCHES``."""
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
    qkv4 = qkv4.contiguous()
    if qkv4.data_ptr() % 16:
        qkv4 = qkv4.clone()
    ok = valid.to(torch.int32).contiguous()
    out = torch.empty((b, n, num_heads, d), dtype=qkv4.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().mdvt_packed_flash_attention(
            qkv4.data_ptr(), ok.data_ptr(), out.data_ptr(), b, n, num_heads,
            d, float(sm_scale), KERNEL_DTYPES[qkv4.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"packed_flash_attention kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["packed_flash_attention"] += 1
    return out


def _library():
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    lib = cuda_build.load("packed_flash_attention")
    fn = lib.mdvt_packed_flash_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib
