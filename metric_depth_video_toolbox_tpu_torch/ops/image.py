"""Image-space ops (PyTorch port of the parts of ``ops/image.py`` that the
stereo infill mask, the basic and the causal infill use): bilinear resize,
bilinear sampling at float coordinates, separable Gaussian filters, masked
blur, 2D filtering, morphology and the two-scale diffusion inpaint; and
the side rescale of a frame size.

Images are channels-last at the public functions, (..., H, W, C), like the
JAX package (a 2D tensor is one (H, W) plane); the morphology works on
(..., H, W) masks and the internal filters on (..., H, W) planes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def resize(img, out_hw):
    """Bilinear resize of (..., H, W, C) float images (half-pixel
    centers). Shrinking antialiases, as ``jax.image.resize`` does."""
    *lead, h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return img
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = resize_nchw(x, (oh, ow))
    return y.permute(0, 2, 3, 1).reshape(*lead, oh, ow, c)


def resize_nchw(x, out_hw):
    """Bilinear resize of an (N, C, H, W) tensor, ``align_corners=False``,
    antialiased when either side shrinks (``jax.image.resize`` semantics).
    Computed in float32 and cast back to the input dtype."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == tuple(x.shape[-2:]):
        return x
    shrink = oh < x.shape[-2] or ow < x.shape[-1]
    y = F.interpolate(x.to(torch.float32), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.to(x.dtype)


def rescale_to_side(h, w, side_length, mode="max", multiple=1):
    """New (h, w) whose longest ("max") or shortest ("min") side is
    ``side_length``, each side then cut down to a multiple of
    ``multiple`` (a ViT's patch)."""
    scale = side_length / (max(h, w) if mode == "max" else min(h, w))
    nh, nw = int(h * scale), int(w * scale)
    if multiple > 1:
        nh -= nh % multiple
        nw -= nw % multiple
    return nh, nw


def bilinear_sample(img, xy, fill=0.0):
    """Sample (..., H, W, C) at float pixel coordinates xy (..., H', W',
    2), one image per leading index; taps outside the image read
    ``fill``. The cv2.remap replacement of drift correction."""
    h, w = img.shape[-3:-1]
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    lead, c = img.shape[:-3], img.shape[-1]
    flat = img.reshape(lead + (h * w, c))

    def tap(yi, xi):
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(
            lead + (-1, 1))
        v = torch.gather(flat, -2, idx.expand(lead + (idx.shape[-2], c)))
        v = v.reshape(yi.shape + (c,))
        return torch.where(ok[..., None], v, torch.full_like(v, fill))

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def gaussian_kernel_1d(ksize, sigma=0.0, device=None):
    """cv2.getGaussianKernel-compatible: sigma<=0 -> 0.3*((k-1)*0.5-1)+0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float32, device=device) \
        - (ksize - 1) / 2.0
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def _sep_filter_chw(x, k1):
    """Separable zero-padded filter over the last two axes, as a sum of
    shifted copies in tap order (the JAX package's arithmetic order)."""
    k = k1.shape[0]
    r = k // 2
    for axis in (x.ndim - 2, x.ndim - 1):
        pad = [0, 0] * x.ndim          # F.pad lists the last axis first
        slot = 2 * (x.ndim - 1 - axis)
        pad[slot], pad[slot + 1] = r, k - 1 - r
        xp = F.pad(x, pad)
        n = x.shape[axis]
        acc = None
        for i in range(k):
            term = k1[i] * xp.narrow(axis, i, n)
            acc = term if acc is None else acc + term
        x = acc
    return x


def _channels_last(img):
    """(..., H, W, C) or an (H, W) plane -> (float32 (..., C, H, W),
    function taking such a result back to the input's layout)."""
    if img.ndim == 2:
        return img.to(torch.float32)[None], lambda y: y[0]
    return (img.to(torch.float32).movedim(-1, -3),
            lambda y: y.movedim(-3, -1))


def _round_like(out, img):
    """Integer inputs come back rounded (half to even) and clipped to
    [0, 255] in their own dtype, as in the JAX package."""
    if img.dtype.is_floating_point:
        return out
    return torch.clamp(torch.round(out), 0, 255).to(img.dtype)


def gaussian_blur(img, ksize, sigma=0.0):
    """Separable Gaussian blur with a zero border of (..., H, W, C) or
    (H, W), float or uint8."""
    x, back = _channels_last(img)
    out = back(_sep_filter_chw(x, gaussian_kernel_1d(ksize, sigma,
                                                     device=img.device)))
    return _round_like(out, img)


def filter2d(img, kernel):
    """(..., H, W, C) or (H, W) cross-correlated with a (kh, kw) kernel,
    zero border, the window's centre at ((kh - 1) // 2, (kw - 1) // 2)
    (XLA's "SAME" padding). float32 out."""
    x, back = _channels_last(img)
    kh, kw = kernel.shape
    lead = x.shape[:-2]
    planes = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    top, left = (kh - 1) // 2, (kw - 1) // 2
    planes = F.pad(planes, (left, kw - 1 - left, top, kh - 1 - top))
    out = F.conv2d(planes, kernel.to(device=planes.device,
                                     dtype=torch.float32).reshape(1, 1, kh, kw))
    return back(out.reshape(lead + out.shape[-2:]))


def _window_reduce(m, ksize, fill, largest):
    """Max (or min) over a ksize x ksize window of (..., H, W) float32
    planes, padded with ``fill``; the window's centre at ksize // 2, so an
    even window reaches one pixel further up and left."""
    lead = m.shape[:-2]
    planes = m.reshape((-1, 1) + tuple(m.shape[-2:]))
    lo, hi = ksize // 2, ksize - 1 - ksize // 2
    planes = F.pad(planes, (lo, hi, lo, hi), value=fill)
    if not largest:
        planes = -planes
    out = F.max_pool2d(planes, ksize, stride=1)
    if not largest:
        out = -out
    return out.reshape(lead + out.shape[-2:])


def _morph(mask, ksize, iterations, largest):
    m = mask.to(torch.float32)
    for _ in range(iterations):
        m = _window_reduce(m, ksize, -math.inf if largest else math.inf,
                           largest)
    return m > 0.5 if mask.dtype == torch.bool else m.to(mask.dtype)


def dilate(mask, ksize=3, iterations=1):
    """Dilation of (..., H, W) binary or float masks with a square
    structuring element."""
    return _morph(mask, ksize, iterations, True)


def erode(mask, ksize=3, iterations=1):
    """Erosion of (..., H, W) masks, the dual of :func:`dilate`."""
    return _morph(mask, ksize, iterations, False)


def masked_blur(img, ksize=6, sigma=0.0, valid_mask=None):
    """Gaussian blur of (..., H, W, C) that treats invalid pixels as
    transparent (weights renormalize over valid pixels); holes stay 0."""
    imf = img.to(torch.float32)
    if valid_mask is None:
        valid_mask = torch.any(imf != 0, dim=-1)
    v = valid_mask.to(torch.float32)
    g1 = gaussian_kernel_1d(ksize, sigma, device=img.device)
    num = _sep_filter_chw((imf * v[..., None]).movedim(-1, -3), g1)
    num = num.movedim(-3, -1)
    den = _sep_filter_chw(v, g1)
    safe = torch.where(den == 0, torch.ones_like(den), den)
    out = num / safe[..., None]
    out = torch.where((den == 0)[..., None], torch.zeros_like(out), out)
    return torch.where(valid_mask[..., None], out, torch.zeros_like(out))


def inpaint_diffusion(img, hole_mask, iterations=64, ksize=3):
    """Fill holes of (..., H, W, C) by iterated masked neighborhood
    averaging: each iteration fills the hole pixels that have a valid
    neighbor with the Gaussian-weighted mean of their valid neighbors."""
    imf = img.to(torch.float32)
    valid = (~hole_mask).to(torch.float32)
    g1 = gaussian_kernel_1d(ksize, 0.0, device=img.device)
    cur = (imf * valid[..., None]).movedim(-1, -3)
    v = valid
    for _ in range(iterations):
        num = _sep_filter_chw(cur * v[..., None, :, :], g1)
        den = _sep_filter_chw(v, g1)
        cand = num / torch.where(den == 0, torch.ones_like(den),
                                 den)[..., None, :, :]
        newly = (v == 0) & (den > 0)
        cur = torch.where(newly[..., None, :, :], cand, cur)
        v = torch.where(newly, torch.ones_like(v), v)
    return cur.movedim(-3, -1)


def _refine_inpaint(img, hole_mask, iterations):
    """Jacobi smoothing of the hole region of (..., H, W, C) against its
    boundary."""
    g1 = gaussian_kernel_1d(3, 0.0, device=img.device)
    m = hole_mask[..., None, :, :]
    cur = img.movedim(-1, -3)
    for _ in range(iterations):
        cur = torch.where(m, _sep_filter_chw(cur, g1), cur)
    return cur.movedim(-3, -1)


def inpaint_diffusion_multiscale(img, hole_mask, coarse_iters=24,
                                 fine_iters=6, factor=4):
    """Two-scale diffusion inpaint of (..., H, W, C): fill at 1/factor
    resolution, upsample the fill into the holes, refine at full
    resolution."""
    imf = img.to(torch.float32)
    h, w = imf.shape[-3:-1]
    ch, cw = h // factor, w // factor
    small = resize(imf, (ch, cw))
    small_hole = resize(hole_mask.to(torch.float32)[..., None],
                        (ch, cw))[..., 0] > 0.5
    small_fill = inpaint_diffusion(small, small_hole,
                                   iterations=coarse_iters)
    up = resize(small_fill, (h, w))
    seeded = torch.where(hole_mask[..., None], up, imf)
    if fine_iters == 0:
        return seeded
    return _refine_inpaint(seeded, hole_mask, fine_iters)


def box_blur(img, ksize):
    """Box filter of (H, W[, C]) with a zero border (cv2.blur with
    BORDER_ISOLATED)."""
    squeeze = img.ndim == 2
    x = (img[..., None] if squeeze else img).to(torch.float32)
    x = x.permute(2, 0, 1)[:, None]
    k = torch.full((1, 1, ksize, ksize), 1.0 / (ksize * ksize),
                   dtype=torch.float32, device=img.device)
    pad = (ksize - 1) // 2
    out = F.conv2d(F.pad(x, (pad, ksize - 1 - pad, pad, ksize - 1 - pad)),
                   k)[:, 0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out
