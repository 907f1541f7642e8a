"""The metric-depth video codec (PyTorch port of ``ops/codec.py``).

Depth in meters is quantized to a 32-bit code ``e = depth * 255**4 /
max_depth`` and its two most significant bytes are packed into video
channels: byte3 -> R and G, byte2 -> B (bit16 mode, the production
contract), or bytes 2/1/0 -> R/G/B (24-bit mode). The bytes equal the JAX
package's: the code is built from the same two float32 halves, and held in
int64 because torch has no uint32 shifts.

NaN depth encodes as code 0 (the JAX package's float->uint32 cast gives 0
there; torch's float->int cast of NaN is undefined, so it is mapped
explicitly). +inf clamps to ``max_depth``.
"""

from __future__ import annotations

import math

import torch

_FULL_SCALE = float(255**4)

LOG_C = 2.0
LOG_A = 16538.0


def _clamped(depth, max_depth):
    d = depth.to(torch.float32)
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    return torch.clamp(d, 0.0, float(max_depth))


def encode_depth_to_uint32(depth, max_depth):
    """Quantize metric depth to the code space (int64 holding a uint32)."""
    d = _clamped(depth, max_depth)
    c = torch.tensor(_FULL_SCALE / float(max_depth) / 65536.0,
                     dtype=torch.float32, device=d.device)
    scaled = d * c
    hi = torch.clamp(torch.floor(scaled), 0.0, 65535.0)
    lo = torch.clamp(torch.floor((scaled - hi) * 65536.0), 0.0, 65535.0)
    return (hi.to(torch.int64) << 16) | lo.to(torch.int64)


def decode_uint32_to_depth(code, max_depth):
    multi = torch.tensor(float(max_depth) / _FULL_SCALE, dtype=torch.float32,
                         device=code.device)
    return code.to(torch.float32) * multi


def encode_depth_to_uint32_log(depth, max_depth):
    """Log-scale variant: ``e = round(A * log1p(depth / C))``.

    Evaluated in float64, as the upstream numpy codec does. XLA's float32
    ``log1p`` is not correctly rounded, so about 1 code in 10^4 differs by
    one from the JAX package here (tests/test_torch_codec.py)."""
    d = _clamped(depth, max_depth).to(torch.float64)
    return torch.round(LOG_A * torch.log1p(d / LOG_C)).to(torch.int64)


def decode_uint32_log_to_depth(code, max_depth):
    del max_depth  # interface symmetry with the linear codec
    e = code.to(torch.float64)
    return (LOG_C * torch.expm1(e / LOG_A)).to(torch.float32)


def pack_uint32_to_rgb(code, bit16=True):
    """int64 codes (...) -> uint8 (..., 3)."""
    code = code.to(torch.int64)
    if bit16:
        msb = (code >> 24) & 0xFF
        b2 = (code >> 16) & 0xFF
        planes = [msb, msb, b2]
    else:
        planes = [(code >> 16) & 0xFF, (code >> 8) & 0xFF, code & 0xFF]
    return torch.stack(planes, dim=-1).to(torch.uint8)


def unpack_rgb_to_uint32(rgb, bit16=True, average_rg=False):
    """uint8 (..., 3) -> int64 codes (...)."""
    rgb = rgb.to(torch.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    if bit16:
        msb = (r + g) // 2 if average_rg else r
        return (msb << 24) | (b << 16)
    return (r << 16) | (g << 8) | b


def encode_depth_frame(depth, max_depth, bit16=True, log=False):
    """depth (..., H, W) meters -> RGB uint8 (..., H, W, 3)."""
    enc = encode_depth_to_uint32_log if log else encode_depth_to_uint32
    return pack_uint32_to_rgb(enc(depth, max_depth), bit16=bit16)


def decode_depth_frame(rgb, max_depth, bit16=True, average_rg=False,
                       log=False):
    """RGB uint8 (..., H, W, 3) -> float32 depth (..., H, W) meters."""
    code = unpack_rgb_to_uint32(rgb, bit16=bit16, average_rg=average_rg)
    dec = decode_uint32_log_to_depth if log else decode_uint32_to_depth
    return dec(code, max_depth)


def normalize_depth(depth, low_pct=1.0, high_pct=99.0):
    """Percentile-normalize a depth map to [0, 1] for display. The
    percentiles are over the finite values, sorted with the others as
    +inf past them, each the value at index int(p / 100 * (n_valid - 1))
    (no interpolation); non-finite pixels, and every pixel where the
    range is at most 1e-6, give 0."""
    d = depth.to(torch.float32)
    finite = torch.isfinite(d)
    safe = torch.where(finite, d, torch.zeros_like(d))
    flat = torch.sort(torch.where(finite, d, torch.full_like(d, math.inf))
                      .reshape(-1)).values
    last = torch.clamp(finite.sum(), min=1).to(torch.float32) - 1

    def at(pct):
        idx = torch.tensor(pct / 100.0, dtype=torch.float32) * last
        return flat[torch.clamp(idx, 0, flat.numel() - 1).to(torch.int64)]
    d_min, d_max = at(low_pct), at(high_pct)
    rng = d_max - d_min
    out = torch.clamp((safe - d_min) / torch.clamp(rng, min=1e-6), 0.0, 1.0)
    return torch.where(rng <= 1e-6, torch.zeros_like(out), out)


def quantization_step(max_depth, bit16=True):
    """Size in meters of one representable depth step."""
    bits_dropped = 16 if bit16 else 8
    return (2.0**bits_dropped) * float(max_depth) / _FULL_SCALE
