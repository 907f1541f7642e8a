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

In bfloat16 the kernel is the wgmma + TMA core of ``csrc/flash_sm90.cuh``
at head dim 64 or 128. What it is given is prepared by plain functions the
CPU tests reach: :func:`pad_head_dim` (zero columns up to the core's head
dim, which change no dot product), :func:`tma_strides` (the operands are
read at their own strides, so (B, N, H, D) tensors pass as transposed
views, without a copy), :func:`visible_prefix` and :func:`key_ranges`
(the keys each query and each query tile sees).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# kernel launches by wrapper name; the wrapper adds one per launch
LAUNCHES = {"block_causal_attention": 0}

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 core's key tile (kBK in csrc/flash_sm90.cuh), and its query
# tile by head dim: 64 rows per consumer warpgroup, three at D = 64 and two
# at D = 128 (FlashConfig::kBQ)
KEY_TILE = 128
QUERY_TILE = {64: 192, 128: 128}
# elements of the score matrix per chunk (of heads, or of one head's query
# rows) in the plain version
_PLAIN_CHUNK = 1 << 28


def block_causal_attention_plain(q, k, v, block_ids, sm_scale):
    """Dense block-causal attention in float32, chunked over heads (and,
    when one head's (N, N) scores exceed 2**28 elements, over its query
    rows), so one chunk's scores stay near 2**28 elements; returns q's
    dtype."""
    b, h, n, d = q.shape
    # contiguous whatever q's strides: the chunks below write through views
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
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


def kernel_head_dim(d):
    """-> the head dim the bf16 core runs a head dim ``d`` <= 128 at."""
    return 64 if d <= 64 else 128


def pad_head_dim(t, d_kernel):
    """``t`` (..., d) with zero columns appended up to ``d_kernel`` (a copy),
    or ``t`` itself when it is that wide already. Zero columns add nothing
    to q k^T and give zero output columns, which the caller drops."""
    pad = d_kernel - t.shape[-1]
    return F.pad(t, (0, pad)) if pad else t


def tma_strides(t, what):
    """-> the (b, h, n) element strides of a bf16 (B, H, N, D) operand as
    the core's TMA maps read it; raises ValueError where TMA cannot: the
    last dim not contiguous, a stride not a multiple of 16 bytes, or the
    base not 16-byte aligned. A dim of extent 1 is never stepped along, so
    its stride is replaced by one TMA takes."""
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: the last dim must be contiguous, strides "
                         f"{tuple(t.stride())}")
    span = max(s * (n - 1) for s, n in zip(t.stride(), t.shape)) + 8
    span = -(-span // 8) * 8
    strides = [s if n > 1 else span for s, n in zip(t.stride()[:3],
                                                     t.shape[:3])]
    if any(s % 8 for s in strides) or t.data_ptr() % 16:
        raise ValueError(f"{what}: TMA needs 16-byte strides and base, got "
                         f"strides {tuple(t.stride())} (elements of 2 "
                         f"bytes) at offset {t.data_ptr() % 16} of 16")
    return strides


def visible_prefix(block_ids):
    """-> int32 (N,): for each query, the number of keys it sees (ids <=
    its id). With ``block_ids`` nondecreasing those keys are a prefix, so
    key j is visible to query i iff j < visible_prefix[i]."""
    ids = block_ids.contiguous()
    return torch.searchsorted(ids, ids, right=True).to(torch.int32)


def key_ranges(prefix, tile):
    """-> (key_end, full_end), int32 per query tile of ``tile`` rows, from
    :func:`visible_prefix`: the keys its last query sees, and its first.
    The tile's keys below full_end are seen by all its queries, those from
    key_end on by none."""
    n = prefix.numel()
    first = torch.arange(0, n, tile, device=prefix.device)
    last = (first + tile - 1).clamp(max=n - 1)
    return prefix[last].contiguous(), prefix[first].contiguous()


def block_causal_attention(q, k, v, block_ids, sm_scale):
    """Block-causal attention of q, k, v (B, H, N, D) under ``block_ids``
    (N,) int32 nondecreasing. CPU tensors run
    :func:`block_causal_attention_plain`; CUDA tensors launch the kernel
    and count it in ``LAUNCHES``: bfloat16 through the wgmma core (any head
    dim the wrapper takes is zero-padded to 64 or 128; q, k and v are read
    at their own strides, so transposed (B, N, H, D) views need no copy,
    and the output is a (B, H, N, D) view of a (B, N, H, D) tensor), or
    float32 through the FMA kernel (contiguous copies where needed). D is
    a multiple of 16 up to 128; one launch for every (b, h)."""
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
    ids = block_ids.contiguous()
    strides = (ctypes.c_longlong * 12)()
    row_end = key_end = full_end = None
    if q.dtype == torch.bfloat16:
        dk = kernel_head_dim(d)
        q, k, v = (pad_head_dim(t, dk) for t in (q, k, v))
        out = torch.empty((b, n, h, dk), dtype=q.dtype,
                          device=dev).transpose(1, 2)
        for i, (t, what) in enumerate(((q, "q"), (k, "k"), (v, "v"))):
            strides[3 * i:3 * i + 3] = tma_strides(t, what)
        strides[9:12] = out.stride()[:3]
        row_end = visible_prefix(ids)
        key_end, full_end = key_ranges(row_end, QUERY_TILE[dk])
    else:
        dk = d
        q, k, v = (t.contiguous() for t in (q, k, v))
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
        out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().mdvt_block_causal_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ids.data_ptr(),
            None if row_end is None else row_end.data_ptr(),
            None if key_end is None else key_end.data_ptr(),
            None if full_end is None else full_end.data_ptr(),
            out.data_ptr(), b, h, n, dk, strides, float(sm_scale),
            KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"block_causal_attention kernel launch failed: "
                           f"CUDA error {rc}")
    LAUNCHES["block_causal_attention"] += 1
    return out if dk == d else out[..., :d]


def _library():
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    lib = cuda_build.load("block_causal_attention")
    fn = lib.mdvt_block_causal_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
    return lib
