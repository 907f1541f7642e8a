"""Block-causal attention (port of ``ops/blockcausal_pallas.py`` B3).

:func:`block_causal_attention` launches the hand-written CUDA kernel
``csrc/block_causal_attention.cu`` on CUDA tensors and runs
:func:`block_causal_attention_plain`, a dense masked softmax in float32, on
CPU tensors. There is no fallback between the two: a CUDA tensor launches
the kernel or raises.

Contract (the JAX kernel's): q, k, v (B, H, N, D); block_ids (N,) int32,
nondecreasing frame-block index per token; query i attends key j iff
``block_ids[j] <= block_ids[i]``. The kernel bounds the ragged tail itself,
so N needs no padding; a caller that pads anyway with the JAX package's
convention (pad queries id max, pad keys id max + 1) gets the same real
rows.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches by wrapper name; the wrapper adds one per launch
LAUNCHES = {"block_causal_attention": 0}

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# elements of the score matrix per chunk (of heads, or of one head's query
# rows) in the plain version
_PLAIN_CHUNK = 1 << 28


def block_causal_attention_plain(q, k, v, block_ids, sm_scale):
    """Dense block-causal attention in float32, chunked over heads (and,
    when one head's (N, N) scores exceed 2**28 elements, over its query
    rows), so one chunk's scores stay near 2**28 elements; returns q's
    dtype."""
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    bh = b * h
    qf, kf, vf, of = (t.reshape(bh, n, d) for t in (q, k, v, out))
    heads = max(1, _PLAIN_CHUNK // max(n * n, 1))
    rows = n if heads > 1 else max(1, _PLAIN_CHUNK // max(n, 1))
    for i in range(0, bh, heads):
        kc = kf[i:i + heads].float().transpose(1, 2)
        vc = vf[i:i + heads].float()
        for r in range(0, n, rows):
            mask = block_ids[None, :] <= block_ids[r:r + rows, None]
            s = torch.matmul(qf[i:i + heads, r:r + rows].float(), kc)
            s = (s * sm_scale).masked_fill(~mask, float("-inf"))
            of[i:i + heads, r:r + rows] = torch.matmul(
                torch.softmax(s, dim=-1), vc).to(q.dtype)
    return out


def error_ratio(got, ref):
    """How far the kernel's output ``got`` is from ``ref``, the plain
    version run in float32 on the same inputs, as a share of the limit the
    kernel is held to (it agrees when the result is <= 1): max over the
    elements of |got - ref| / limit.

    float32: limit 2e-5. bfloat16: the kernel rounds its output to bf16
    (at most 2**-8 of the value) and P to bf16 before P V, as the Pallas
    kernel does. P's rounding (relative, ~1.6e-3 spread) sums over the
    visible keys to an error of ~1.6e-3 of the output's RMS per element,
    ~9e-3 at the largest of 3e7 elements. So the limit is 2**-8 |ref| +
    2**-5 RMS(ref)."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    if got.dtype == torch.float32:
        return float(err.max()) / 2e-5
    rms = ref.square().mean().sqrt()
    return float((err / (2 ** -8 * ref.abs() + 2 ** -5 * rms)).max())


def _check_args(q, k, v, block_ids):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be bfloat16 or float32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 16 "
                         f"up to 128")
    if block_ids.dtype != torch.int32 or tuple(block_ids.shape) != \
            (q.shape[2],):
        raise ValueError(f"block_ids must be int32 ({q.shape[2]},), got "
                         f"{block_ids.dtype} {tuple(block_ids.shape)}")


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def block_causal_attention(q, k, v, block_ids, sm_scale):
    """Block-causal attention of q, k, v (B, H, N, D) under ``block_ids``
    (N,) int32. CPU tensors run :func:`block_causal_attention_plain`; CUDA
    tensors launch the kernel (bfloat16 or float32, D a multiple of 16 up
    to 128, one launch for every (b, h)) and count it in ``LAUNCHES``."""
    devices = {t.device for t in (q, k, v, block_ids)}
    if len(devices) != 1:
        raise ValueError(f"arguments on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return block_causal_attention_plain(q, k, v, block_ids, sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"block_causal_attention runs on cuda or cpu, not "
                         f"{dev}")
    _check_args(q, k, v, block_ids)
    b, h, n, d = q.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
    ids = block_ids.contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().mdvt_block_causal_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ids.data_ptr(),
            out.data_ptr(), b, h, n, d, float(sm_scale),
            KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"block_causal_attention kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["block_causal_attention"] += 1
    return out


def _library():
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    lib = cuda_build.load("block_causal_attention")
    fn = lib.mdvt_block_causal_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib
