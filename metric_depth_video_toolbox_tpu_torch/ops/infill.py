"""Disocclusion infill ops (PyTorch port of ``ops/infill.py``), batched
over frames: the normal-guided march that fills holes, the lower-side
marking of disocclusion edges, the blur under a mask, and linear
histogram matching.

The marches run over worklists of the pixels that march (``torch.nonzero``
in raster order, frame by frame), every one of them: the JAX package caps
its worklist at a static ``max_holes`` / ``max_marks`` (1 << 16) and
leaves the pixels past the cap unmarched; the port accepts the keyword and
ignores it. Below the cap both give the same result bit for bit.
"""

from __future__ import annotations

import torch

from metric_depth_video_toolbox_tpu_torch.ops import image as im

# marches test whether any ray is still alive (a host sync) once per this
# many steps; the steps in between change nothing once none is
SYNC_EVERY = 16


def _unit_dirs(xy):
    """(..., 2) float32 -> (unit directions, norm > 1e-6), with the JAX
    package's arithmetic (norm = sqrt(x*x + y*y), divided by max(norm,
    1e-6))."""
    norms = torch.sqrt(torch.sum(xy * xy, dim=-1, keepdim=True))
    return xy / torch.clamp(norms, min=1e-6), norms[..., 0] > 1e-6


class _Worklist:
    """The marching pixels of a batch of (H, W) frames: flat index into
    the batch, their x, y and unit direction; ``pos(t)`` rounds the
    position t steps along the ray (half to even) and ``sample`` reads a
    flag there."""

    def __init__(self, active, dirs):
        b, self.h, self.w = active.shape
        frame, flat = torch.nonzero(active.reshape(b, -1), as_tuple=True)
        self.base = frame * (self.h * self.w)
        self.px = (flat % self.w).to(torch.float32)
        self.py = (flat // self.w).to(torch.float32)
        self.index = self.base + flat
        d = dirs.reshape(-1, 2)[self.index]
        self.dx, self.dy = d[:, 0].contiguous(), d[:, 1].contiguous()

    def keep(self, sel):
        for name in ("base", "px", "py", "index", "dx", "dy"):
            setattr(self, name, getattr(self, name)[sel])

    def pos(self, t):
        return (torch.round(self.px + self.dx * t).to(torch.int32),
                torch.round(self.py + self.dy * t).to(torch.int32))

    def sample(self, flag, xi, yi):
        """(flag at (xi, yi) where inside, False outside; inside)."""
        inb = (xi >= 0) & (xi < self.w) & (yi >= 0) & (yi < self.h)
        flat = (self.base + torch.clamp(yi, 0, self.h - 1) * self.w
                + torch.clamp(xi, 0, self.w - 1))
        return flag[flat] & inb, inb


def _march(work, state, max_steps, step):
    """Run ``step(t)``, which updates ``state``, for t = 1 .. max_steps,
    testing for a live ray once per SYNC_EVERY steps; dead rays are
    dropped from the worklist (and from every tensor of ``state``) when
    they are at least half of it."""
    for t in range(1, max_steps + 1):
        if (t - 1) % SYNC_EVERY == 0:
            alive = state["alive"]
            n = int(alive.sum())
            if n == 0:
                return
            if 2 * n <= alive.numel():
                sel = torch.nonzero(alive, as_tuple=True)[0]
                work.keep(sel)
                for key in state:
                    state[key] = state[key][sel]
        step(float(t))


def normal_march_infill(color, hole_mask, normal_map, max_steps=400,
                        max_holes=None):
    """Fill holes by marching along the XY of each hole pixel's normal
    until the ray leaves the hole, then copy the color found there,
    preferring the pixel 2, then 1 step past the exit (the JAX package's
    ``normal_march_infill``).

    color (..., H, W, C) float or uint8; hole_mask (..., H, W) bool;
    normal_map (..., H, W, 3) float, signed. Pixels whose normal is
    exactly (0, 1, 0) (green-coded: no normal) or has no XY length do not
    march. ``max_holes`` is ignored: every hole marches.
    """
    del max_holes
    lead = hole_mask.shape[:-2]
    h, w = hole_mask.shape[-2:]
    hole = hole_mask.reshape(-1, h, w)
    normal = normal_map.reshape(-1, h, w, 3)
    dirs, has_dir = _unit_dirs(normal[..., :2].to(torch.float32))
    green = torch.tensor([0.0, 1.0, 0.0], dtype=normal.dtype,
                         device=normal.device)
    green = torch.all(normal == green, dim=-1)
    work = _Worklist(hole & has_dir & ~green, dirs)
    hole_flat = hole.reshape(-1)
    n = work.index.numel()
    zero = torch.zeros(n, dtype=torch.int32, device=hole.device)
    st = {"item": torch.arange(n, device=hole.device),
          "alive": torch.ones(n, dtype=torch.bool, device=hole.device)}
    st["hole0"], st["inb0"] = work.sample(hole_flat, *work.pos(1.0))
    st["hole1"], st["inb1"] = work.sample(hole_flat, *work.pos(2.0))
    hit_x, hit_y = zero.clone(), zero.clone()
    found = torch.zeros(n, dtype=torch.bool, device=hole.device)

    def step(t):
        xi, yi = work.pos(t)
        exits = st["alive"] & st["inb0"] & ~st["hole0"]
        # the source: t + 2 past the exit if it lies outside the hole, else
        # t + 1, else t
        x1, y1 = work.pos(t + 1.0)
        b1 = st["inb1"] & ~st["hole1"]
        bx = torch.where(b1, x1, xi)
        by = torch.where(b1, y1, yi)
        x2, y2 = work.pos(t + 2.0)
        hole2, inb2 = work.sample(hole_flat, x2, y2)
        b2 = inb2 & ~hole2
        bx = torch.where(b2, x2, bx)
        by = torch.where(b2, y2, by)
        item = st["item"]
        hit_x[item] = torch.where(exits, bx, hit_x[item])
        hit_y[item] = torch.where(exits, by, hit_y[item])
        found[item] = found[item] | exits
        st["alive"] = st["alive"] & st["inb0"] & ~exits
        st["hole0"], st["inb0"] = st["hole1"], st["inb1"]
        st["hole1"], st["inb1"] = hole2, inb2

    index = work.index                 # before the march compacts it
    base = work.base
    _march(work, st, max_steps, step)
    c = color.shape[-1]
    flat_color = color.reshape(-1, c)
    src = (base + torch.clamp(hit_y, 0, h - 1) * w
           + torch.clamp(hit_x, 0, w - 1))
    out = flat_color.clone()
    out[index] = torch.where(found[:, None], flat_color[src],
                             flat_color[index])
    return out.reshape(lead + (h, w, c))


def mark_lower_side(normals_rgb_u8, max_steps=30, max_marks=None):
    """From infill-mask frames (..., H, W, 3) uint8 (normals encoded as
    RGB, 0 = no data), march along each encoded normal until the ray
    leaves the marked region and mark the last pixel inside it blue
    (0, 0, 255): the background side of every disocclusion edge. Returns
    uint8 frames of the input's shape. ``max_marks`` is ignored."""
    del max_marks
    lead = normals_rgb_u8.shape[:-3]
    h, w = normals_rgb_u8.shape[-3:-1]
    orig = normals_rgb_u8.reshape(-1, h, w, 3)
    valid = torch.any(orig != 0, dim=-1)
    dirs, has_dir = _unit_dirs(
        (orig[..., :2].to(torch.float32) / 255.0) * 2.0 - 1.0)
    work = _Worklist(valid & has_dir, dirs)
    valid_flat = valid.reshape(-1)
    n = work.index.numel()
    dev = orig.device
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    res_x, res_y = zero.clone(), zero.clone()
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    st = {"item": torch.arange(n, device=dev),
          "alive": torch.ones(n, dtype=torch.bool, device=dev)}

    def step(t):
        xi, yi = work.pos(t)
        vhere, inb = work.sample(valid_flat, xi, yi)
        bg_hit = st["alive"] & inb & ~vhere
        # the previous step's position, still inside the region
        xb, yb = work.pos(t - 1.0)
        item = st["item"]
        res_x[item] = torch.where(bg_hit, xb, res_x[item])
        res_y[item] = torch.where(bg_hit, yb, res_y[item])
        found[item] = found[item] | bg_hit
        st["alive"] = st["alive"] & inb & ~bg_hit

    base = work.base
    _march(work, st, max_steps - 1, step)
    total = orig.shape[0] * h * w
    out = torch.zeros((total + 1, 3), dtype=torch.uint8, device=dev)
    flat = torch.where(found, base + res_y * w + res_x,
                       torch.full_like(base, total))
    out[flat] = torch.tensor([0, 0, 255], dtype=torch.uint8, device=dev)
    return out[:-1].reshape(lead + (h, w, 3))


def blur_under_mask(img, mask, ksize=9, sigma=0.0):
    """Blend (..., H, W, C) images with their Gaussian blur, weighted by
    the blurred (..., H, W) mask (float alpha in [0, 1] allowed): the halo
    smoother below disocclusion lower edges. Integer images come back
    rounded and clipped in their dtype."""
    alpha = im.gaussian_blur(mask.to(torch.float32)[..., None], ksize,
                             sigma)
    blurred = im.gaussian_blur(img.to(torch.float32), ksize, sigma)
    out = img.to(torch.float32) * (1 - alpha) + blurred * alpha
    if img.dtype.is_floating_point:
        return out
    return torch.clamp(torch.round(out), 0, 255).to(img.dtype)


def _matrix_sqrt_psd(a, eps=1e-8):
    """(..., 3, 3) symmetric PSD -> (sqrt(a), inverse sqrt(a)), through
    the eigendecomposition with eigenvalues clamped at ``eps``."""
    vals, vecs = torch.linalg.eigh(a)
    vals = torch.clamp(vals, min=eps)
    vt = vecs.transpose(-1, -2)
    return ((vecs * torch.sqrt(vals)[..., None, :]) @ vt,
            (vecs / torch.sqrt(vals)[..., None, :]) @ vt)


def halo_blend(frames_u8, masks_rgb_u8):
    """The lower-edge halo blend of (B, H, W, 3) uint8 frames by their
    infill-mask frames: the background side of each disocclusion edge
    (:func:`mark_lower_side`), dilated 5 x 5, blends each frame with its
    7 x 7 blur (:func:`blur_under_mask`). -> (B, H, W, 3) uint8."""
    lower = mark_lower_side(masks_rgb_u8)
    lm = im.dilate((lower[..., 2] == 255).to(torch.float32), ksize=5)
    return blur_under_mask(frames_u8, lm, ksize=7)


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
