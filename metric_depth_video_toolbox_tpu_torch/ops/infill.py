"""Infill colour matching (PyTorch port of ``ops/infill.py``'s linear
histogram matching), batched over frames.

The normal-march infill and lower-side marking of the JAX module wait for
ROADMAP A7 / A11.
"""

from __future__ import annotations

import torch


def _matrix_sqrt_psd(a, eps=1e-8):
    """(..., 3, 3) symmetric PSD -> (sqrt(a), inverse sqrt(a)), through
    the eigendecomposition with eigenvalues clamped at ``eps``."""
    vals, vecs = torch.linalg.eigh(a)
    vals = torch.clamp(vals, min=eps)
    vt = vecs.transpose(-1, -2)
    return ((vecs * torch.sqrt(vals)[..., None, :]) @ vt,
            (vecs / torch.sqrt(vals)[..., None, :]) @ vt)


def lhm_color_transfer(generated, reference, ref_weights=None):
    """Linear histogram matching: give ``generated`` the mean and covariance
    of ``reference``, whose statistics are weighted (e.g. masked to
    non-hole pixels).

    generated/reference: (..., H, W, 3) float, one frame per leading index.
    ref_weights:         (..., H, W) float weights for the reference stats.
    Returns generated', same scale as the input, float32.
    """
    lead = generated.shape[:-3]
    g = generated.float().reshape(lead + (-1, 3))
    # The statistics and the 3x3 transform are computed in float64: a
    # near-grey frame has an ill-conditioned covariance (eigenvalues from
    # 2.7 to 2.4e4 on a render of chip_smoke.py's synthetic clip), and a
    # float32 product over a frame's pixels is not reliably accurate on an
    # H100 (cuBLAS's batched f32 GEMM with a transposed operand was off by
    # 6e-4 relative there, enough to move the output by 5 LSB).
    r = reference.double().reshape(lead + (-1, 3))
    w = (torch.ones(r.shape[:-1], dtype=torch.float64, device=r.device)
         if ref_weights is None else ref_weights.double().reshape(
             lead + (-1,)))
    eye = 1e-5 * torch.eye(3, dtype=torch.float64, device=r.device)
    wsum = torch.clamp(w.sum(dim=-1), min=1e-6)[..., None]
    mu_r = (r * w[..., None]).sum(dim=-2) / wsum
    rc = (r - mu_r[..., None, :]) * torch.sqrt(w)[..., None]
    cov_r = rc.transpose(-1, -2) @ rc / wsum[..., None] + eye
    del r, rc
    g64 = g.double()
    mu_g = g64.mean(dim=-2)
    gc64 = g64 - mu_g[..., None, :]
    cov_g = gc64.transpose(-1, -2) @ gc64 / g.shape[-2] + eye
    del g64, gc64
    sqrt_r, _ = _matrix_sqrt_psd(cov_r)
    _, inv_sqrt_g = _matrix_sqrt_psd(cov_g)
    t = (sqrt_r @ inv_sqrt_g).float()
    gc = g - mu_g.float()[..., None, :]
    out = gc @ t.transpose(-1, -2) + mu_r.float()[..., None, :]
    return out.reshape(generated.shape)
