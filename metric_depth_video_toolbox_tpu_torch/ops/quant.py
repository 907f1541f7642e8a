"""int8 matmuls of the ViT blocks (PyTorch port of ``ops/quant.py``):
dynamic symmetric quantization of weights and activations.

- weights:     per-output-channel scale  s_w[j] = max_i |W[i, j]| / 127
- activations: per-token scale           s_x[t] = max_j |x[t, j]| / 127
- out[t, j] = (sum_i q_x[t, i] q_w[i, j]) * (s_x[t] * s_w[j]) + b[j]

Both operands are quantized at every call from the float parameters, so a
checkpoint needs no other format. The int8 x int8 -> int32 product is
``torch._int_mm`` on a CUDA tensor (cuBLAS's int8 GEMM; the JAX package's is
XLA's ``dot_general``, outside any Pallas kernel) and the plain int32 matmul
on the CPU, which is exact: both give the same int32 accumulators.
``torch._int_mm`` takes (m, k) x (k, n) with m > 16 and k, n multiples of 8:
the ViT blocks' (tokens, d) x (d, 3d | d | 4d | d) products at ViT-S (d =
384), ViT-B (768) and ViT-L (1024) all qualify, the token count being the
batch times the patches plus one. On a CUDA tensor of another shape
:func:`int8_dense` raises.
"""

from __future__ import annotations

import torch


def quantize_symmetric(x, dim, eps=1e-8):
    """Symmetric int8 quantization along ``dim``: (q int8 in [-127, 127],
    float32 scale with ``dim`` kept as size 1), x ~= q * scale."""
    x = x.to(torch.float32)
    scale = torch.clamp(torch.amax(torch.abs(x), dim=dim, keepdim=True),
                        min=eps) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul(q_x, q_w):
    """(m, k) int8 x (k, n) int8 -> (m, n) int32: ``torch._int_mm`` on a
    CUDA tensor (which must have m > 16 and k, n multiples of 8), the plain
    int32 product on the CPU."""
    if q_x.is_cuda:
        m, k = q_x.shape
        n = q_w.shape[1]
        if m <= 16 or k % 8 or n % 8:
            raise ValueError(f"int8 matmul of ({m}, {k}) x ({k}, {n}): "
                             f"torch._int_mm needs more than 16 rows and "
                             f"both other sides multiples of 8")
        return torch._int_mm(q_x, q_w)
    return torch.matmul(q_x.to(torch.int32), q_w.to(torch.int32))


def int8_dense(x, weight, bias=None, compute_dtype=torch.bfloat16):
    """Quantized ``x @ weight.T + bias``: x (..., d_in) float, weight
    (d_out, d_in) (``nn.Linear``'s layout), bias (d_out,) or None ->
    (..., d_out) in ``compute_dtype``."""
    lead = x.shape[:-1]
    q_x, s_x = quantize_symmetric(x.reshape(-1, x.shape[-1]), dim=1)
    q_w, s_w = quantize_symmetric(weight, dim=1)   # (d_out, d_in), (d_out, 1)
    # q_w.t(): (d_in, d_out) column-major, the layout cuBLAS's int8 GEMM takes
    acc = int8_matmul(q_x, q_w.t())
    out = acc.to(torch.float32) * (s_x * s_w.t())
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(compute_dtype).reshape(lead + (weight.shape[0],))
