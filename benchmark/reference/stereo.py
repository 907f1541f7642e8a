"""The plain reference of the stereo stage: the movie's stereo step (the
depth codec, the disparity sweep as a per-plane PyTorch loop, the edge
anchors and the infill mask) in plain float32 PyTorch.

A frozen copy of the arithmetic of the port's ``ops/codec.py``,
``ops/geometry.py``, ``ops/rasterize.py`` (the sweep path),
``ops/warp_sweep.py`` (the plain sweep), ``ops/image.py`` (the infill
mask's diffusion and blur) and ``pipeline/stereo.py`` (``stereo_frame`` with
the sweep warp and two eyes), cut to what the movie's configuration runs:
``remove_edges``, ``place_edge_points``, ``make_infill_mask``, a
convergence depth, the sweep at P planes, identity camera transforms. It
imports nothing of the port.

``round_depth_to``: the control. The decoded depth is rounded to that
dtype before the warp (bfloat16: the precision below the stage's float32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

FULL_SCALE = float(255 ** 4)
INF_DEPTH = 3.0e38
LANE = 128
BLOCK_ROWS = 64
MARGIN = 4


class StereoSettings(NamedTuple):
    """The movie's stereo configuration, as far as the reference needs it."""
    max_depth: float = 100.0
    pupillary_distance_m: float = 0.063
    num_planes: int = 128
    master_xfov: float = 45.0
    inpaint_iters: int = 48


# -- the depth codec (bit16 linear) ------------------------------------------

def encode_depth_frame(depth, max_depth):
    """depth (..., H, W) meters -> RGB uint8 (..., H, W, 3)."""
    d = depth.to(torch.float32)
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    d = torch.clamp(d, 0.0, float(max_depth))
    c = torch.tensor(FULL_SCALE / float(max_depth) / 65536.0,
                     dtype=torch.float32, device=d.device)
    scaled = d * c
    hi = torch.clamp(torch.floor(scaled), 0.0, 65535.0)
    lo = torch.clamp(torch.floor((scaled - hi) * 65536.0), 0.0, 65535.0)
    code = (hi.to(torch.int64) << 16) | lo.to(torch.int64)
    msb = (code >> 24) & 0xFF
    b2 = (code >> 16) & 0xFF
    return torch.stack([msb, msb, b2], dim=-1).to(torch.uint8)


def decode_depth_frame(rgb, max_depth):
    rgb = rgb.to(torch.int64)
    code = (rgb[..., 0] << 24) | (rgb[..., 2] << 16)
    multi = torch.tensor(float(max_depth) / FULL_SCALE, dtype=torch.float32,
                         device=code.device)
    return code.to(torch.float32) * multi


# -- cameras -----------------------------------------------------------------

def camera_matrix(width, height, xfov_deg):
    """3x3 float32 intrinsics from the horizontal FOV, square pixels, the
    principal point at the centre; float32 arithmetic on the CPU."""
    f = torch.tensor(xfov_deg, dtype=torch.float32)
    fx = width / (2.0 * torch.tan(torch.deg2rad(f) / 2.0))
    k = torch.zeros((3, 3), dtype=torch.float32)
    k[0, 0] = fx
    k[1, 1] = fx
    k[0, 2] = width / 2.0
    k[1, 2] = height / 2.0
    k[2, 2] = 1.0
    return k


def _pixel_grid(h, w, device):
    x = torch.arange(w, dtype=torch.float32, device=device)
    y = torch.arange(h, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    return gx, gy


def _intrinsics(k):
    return (k[..., 0, 0, None, None], k[..., 1, 1, None, None],
            k[..., 0, 2, None, None], k[..., 1, 2, None, None])


def unproject_depth(depth, k):
    h, w = depth.shape[-2:]
    x, y = _pixel_grid(h, w, depth.device)
    fx, fy, cx, cy = _intrinsics(k)
    z = depth.to(torch.float32)
    return torch.stack([(x - cx) * z / fx, (y - cy) * z / fy, z], dim=-1)


def normals_from_depth(depth, k):
    h, w = depth.shape[-2:]
    x, y = _pixel_grid(h, w, depth.device)
    fx, fy, cx, cy = _intrinsics(k)
    z = depth.to(torch.float32)
    p = torch.stack([(x - cx) / fx * z, (cy - y) / fy * z, z], dim=-1)
    p_x1 = torch.cat([p[..., :, 1:, :], p[..., :, -1:, :]], dim=-2)
    p_y1 = torch.cat([p[..., 1:, :, :], p[..., -1:, :, :]], dim=-3)
    n = torch.linalg.cross(p_x1 - p, p_y1 - p, dim=-1)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-8)
    return n * torch.tensor([1.0, -1.0, -1.0], dtype=n.dtype, device=n.device)


def rotation_y(a):
    c, s = torch.cos(a), torch.sin(a)
    m = torch.zeros(a.shape + (4, 4), dtype=torch.float32, device=a.device)
    m[..., 0, 0] = c
    m[..., 0, 2] = s
    m[..., 1, 1] = 1.0
    m[..., 2, 0] = -s
    m[..., 2, 2] = c
    m[..., 3, 3] = 1.0
    return m


def translation_x(x):
    m = torch.eye(4, dtype=torch.float32, device=x.device).expand(
        x.shape + (4, 4)).clone()
    m[..., 0, 3] = x
    m[..., 1, 3] = 0.0
    m[..., 2, 3] = 0.0
    return m


# -- the sweep warp ------------------------------------------------------------

def _cell_corners(a):
    a01 = torch.cat([a[..., :, 1:, :], a[..., :, -1:, :]], dim=-2)
    a10 = torch.cat([a[..., 1:, :, :], a[..., -1:, :, :]], dim=-3)
    a11 = torch.cat([a01[..., 1:, :, :], a01[..., -1:, :, :]], dim=-3)
    return a, a01, a10, a11


def cell_edge_mask(points_cam, angle_threshold_deg=89.0):
    p00, p01, p10, p11 = _cell_corners(points_cam)
    n1 = torch.linalg.cross(p10 - p00, p01 - p00, dim=-1)
    n2 = torch.linalg.cross(p01 - p11, p10 - p11, dim=-1)
    view = -((p00 + p01 + p10 + p11) * 0.25)
    cos_t = math.cos(math.radians(angle_threshold_deg))
    view_norm = torch.linalg.vector_norm(view, dim=-1)

    def bad(n):
        nn_ = torch.linalg.vector_norm(n, dim=-1)
        cosang = torch.abs(torch.sum(n * view, dim=-1)) / (
            nn_ * view_norm + 1e-12)
        return (cosang < cos_t) & (nn_ > 1e-12)

    return bad(n1) | bad(n2)


def _plane_set(depth_rot, fx, tx, num_planes, max_disparity, conv_inv_z,
               min_depth, tol_scale):
    dev = depth_rot.device
    inside = depth_rot > min_depth
    inf = torch.full_like(depth_rot, math.inf)
    z_near = torch.clamp(torch.where(inside, depth_rot, inf).amin((1, 2)),
                         min=min_depth)
    z_far = torch.maximum(torch.where(inside, depth_rot, -inf).amax((1, 2)),
                          z_near * 1.001)
    inv_near = 1.0 / z_near
    inv_far = 1.0 / z_far
    d_inv = (inv_near - inv_far) / (num_planes - 1)
    ids = torch.arange(num_planes, dtype=torch.float32, device=dev)
    plane_z = 1.0 / (inv_near[:, None] - d_inv[:, None] * ids[None])
    plane_tol = tol_scale * plane_z * plane_z * d_inv[:, None] + 1e-4
    conv = torch.as_tensor(conv_inv_z, dtype=torch.float32, device=dev)
    conv = conv.reshape(-1, 1) if conv.ndim else conv
    disp = -fx[:, None] * tx[:, None] * (1.0 / plane_z - conv)
    disp = torch.clamp(disp, -(max_disparity - 2.0), max_disparity - 2.0)
    disp_floor = torch.floor(disp)
    return (inv_near, d_inv, plane_z, plane_tol,
            disp_floor.to(torch.int32), disp - disp_floor)


def _plane_activity(depth, inv_near, d_inv, num_planes):
    b, h, w = depth.shape
    ntiles = -(-h // BLOCK_ROWS)
    d = F.pad(depth, (0, 0, 0, ntiles * BLOCK_ROWS - h))
    valid = d > 1e-3
    inv = torch.where(valid, 1.0 / torch.clamp(d, min=1e-6),
                      torch.zeros_like(d))
    q = torch.round((inv_near[:, None, None] - inv) / d_inv[:, None, None])
    q = torch.where(valid, q, torch.zeros_like(q))
    bins = torch.clamp(q, 0, num_planes - 1).to(torch.int64)
    tile = torch.arange(ntiles * BLOCK_ROWS, device=depth.device) // BLOCK_ROWS
    batch = torch.arange(b, device=depth.device)
    slot = ((batch[:, None, None] * ntiles + tile[None, :, None])
            * num_planes + bins)
    counts = torch.bincount(slot[valid], minlength=b * ntiles * num_planes)
    act = (counts > 0).to(torch.int32).reshape(b, ntiles, num_planes)
    out = act.clone()
    for s in range(1, MARGIN + 1):
        out[..., :-s] |= act[..., s:]
        out[..., s:] |= act[..., :-s]
    return out


def _blend(a, b, f):
    """(1 - f) * a + f * b rounded as one fused multiply-add."""
    return ((1.0 - f).double() * a.double() + (f * b).double()).float()


def _sweep(depth_pad, color_pad, disp_int, disp_frac, plane_z, plane_tol,
           num_planes, pad_left, active):
    """Front to back over the planes: the first plane whose shifted depth
    lies within its tolerance writes depth and colour."""
    b, h, wp = depth_pad.shape
    c = color_pad.shape[1]
    w = wp - (2 * pad_left + 2 * LANE)
    dev = depth_pad.device
    row_tile = torch.arange(h, device=dev) // BLOCK_ROWS
    x = torch.arange(w, device=dev)
    best_z = torch.full((b, h, w), INF_DEPTH, dtype=torch.float32,
                        device=dev)
    color = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    found = torch.zeros((b, h, w), dtype=torch.bool, device=dev)

    def sample(src, idx):
        inside = (idx >= 0) & (idx < wp)
        idx = idx.clamp(0, wp - 1)
        shape = src.shape[:-1] + (w,)
        view = (b,) + (1,) * (src.ndim - 2) + (w,)
        val = torch.gather(src, -1, idx.reshape(view).expand(shape))
        return torch.where(inside.reshape(view), val, torch.zeros_like(val))

    for p in range(num_planes):
        s = x[None, :] + (disp_int[:, p].to(torch.int64) + pad_left)[:, None]
        f = disp_frac[:, p, None, None]
        d = _blend(sample(depth_pad, s), sample(depth_pad, s + 1), f)
        act = (active[:, row_tile, p] > 0)[:, :, None]
        ok = ((torch.abs(d - plane_z[:, p, None, None])
               < plane_tol[:, p, None, None])
              & (d > 1e-3) & ~found & act)
        best_z = torch.where(ok, d, best_z)
        pay = _blend(sample(color_pad, s), sample(color_pad, s + 1),
                     f[:, None]).permute(0, 2, 3, 1)
        color = torch.where(ok[..., None], pay, color)
        found = found | ok
    return best_z, color, found


def sweep_warp(depth, color, k, transform, num_planes, remove_edges,
               conv_inv_z, edge=None, max_disparity=256, min_depth=1e-2,
               tol_scale=1.6):
    """-> (color, depth, mask, edge_mask) of the stereo sweep of an eye
    shift (``transform``: a translation along x)."""
    b, h, w = depth.shape
    dev = depth.device
    depth = depth.to(torch.float32)
    if edge is None:
        if remove_edges:
            edge = cell_edge_mask(unproject_depth(depth, k))
        else:
            edge = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    valid_src = depth > min_depth
    # the convergence is a shift of the planes, so no rotation to remove
    depth_rot = torch.where(edge | ~valid_src, torch.zeros_like(depth), depth)
    color_rot = color.to(torch.float32)
    inv_near, d_inv, plane_z, plane_tol, disp_int, disp_frac = _plane_set(
        depth_rot, k[:, 0, 0], transform[:, 0, 3], num_planes, max_disparity,
        conv_inv_z, min_depth, tol_scale)
    pad_left = ((max_disparity + LANE - 1) // LANE) * LANE
    pads = (pad_left, pad_left + 2 * LANE)
    active = _plane_activity(depth_rot, inv_near, d_inv, num_planes)
    best_z, out_color, found = _sweep(
        F.pad(depth_rot, pads),
        F.pad(color_rot.permute(0, 3, 1, 2), pads).contiguous(),
        disp_int, disp_frac, plane_z, plane_tol, num_planes, pad_left,
        active)
    return (out_color,
            torch.where(found, best_z, torch.full_like(best_z, INF_DEPTH)),
            found, edge & valid_src)


# -- the infill mask's diffusion and blur --------------------------------------

def _resize(img, out_hw):
    """Bilinear (..., H, W, C), half-pixel centres, antialiased when it
    shrinks."""
    *lead, h, w, c = img.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return img
    x = img.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    shrink = oh < h or ow < w
    y = F.interpolate(x.to(torch.float32), size=(oh, ow), mode="bilinear",
                      align_corners=False, antialias=shrink).to(x.dtype)
    return y.permute(0, 2, 3, 1).reshape(*lead, oh, ow, c)


def _gaussian_kernel_1d(ksize, device):
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = torch.arange(ksize, dtype=torch.float32, device=device) \
        - (ksize - 1) / 2.0
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def _sep_filter(x, k1):
    k = k1.shape[0]
    r = k // 2
    for axis in (x.ndim - 2, x.ndim - 1):
        pad = [0, 0] * x.ndim
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


def _masked_blur(img, ksize, valid_mask):
    imf = img.to(torch.float32)
    v = valid_mask.to(torch.float32)
    g1 = _gaussian_kernel_1d(ksize, img.device)
    num = _sep_filter((imf * v[..., None]).movedim(-1, -3), g1)
    num = num.movedim(-3, -1)
    den = _sep_filter(v, g1)
    safe = torch.where(den == 0, torch.ones_like(den), den)
    out = num / safe[..., None]
    out = torch.where((den == 0)[..., None], torch.zeros_like(out), out)
    return torch.where(valid_mask[..., None], out, torch.zeros_like(out))


def _inpaint_diffusion(img, hole_mask, iterations):
    imf = img.to(torch.float32)
    valid = (~hole_mask).to(torch.float32)
    g1 = _gaussian_kernel_1d(3, img.device)
    cur = (imf * valid[..., None]).movedim(-1, -3)
    v = valid
    for _ in range(iterations):
        num = _sep_filter(cur * v[..., None, :, :], g1)
        den = _sep_filter(v, g1)
        cand = num / torch.where(den == 0, torch.ones_like(den),
                                 den)[..., None, :, :]
        newly = (v == 0) & (den > 0)
        cur = torch.where(newly[..., None, :, :], cand, cur)
        v = torch.where(newly, torch.ones_like(v), v)
    return cur.movedim(-3, -1)


def _inpaint_multiscale(img, hole_mask, coarse_iters, fine_iters, factor):
    imf = img.to(torch.float32)
    h, w = imf.shape[-3:-1]
    ch, cw = h // factor, w // factor
    small = _resize(imf, (ch, cw))
    small_hole = _resize(hole_mask.to(torch.float32)[..., None],
                         (ch, cw))[..., 0] > 0.5
    small_fill = _inpaint_diffusion(small, small_hole, coarse_iters)
    up = _resize(small_fill, (h, w))
    seeded = torch.where(hole_mask[..., None], up, imf)
    g1 = _gaussian_kernel_1d(3, img.device)
    m = hole_mask[..., None, :, :]
    cur = seeded.movedim(-1, -3)
    for _ in range(fine_iters):
        cur = torch.where(m, _sep_filter(cur, g1), cur)
    return cur.movedim(-3, -1)


def _border_default_normals(mask_img, hole):
    h, w = hole.shape[-2:]
    dev = hole.device
    col = torch.arange(w, device=dev)[None, :]
    row = torch.arange(h, device=dev)[:, None]

    def vec(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    out = mask_img
    for where, n in (((col == 0) & hole, vec([1.0, 0.5, 0.5])),
                     ((col == w - 1) & hole, vec([0.0, 0.5, 0.5])),
                     ((row == 0) & hole, vec([0.5, 0.5, 0.0])),
                     ((row == h - 1) & hole, vec([0.5, 0.5, 1.0]))):
        out = torch.where(where[..., None], n, out)
    return out


def _normalized(n):
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-8)


# -- the eyes ----------------------------------------------------------------------

def _render_eyes(depth, color, k, eye_shift_m, conv_angle, st, edge,
                 normals):
    """Both eyes of a batch as one batch of frames x eyes: the sweep, the
    edge anchors from a second sweep at P / 4, the infill mask."""
    dev = depth.device
    sign = torch.where(eye_shift_m < 0, -1.0, 1.0)
    shift = translation_x(-eye_shift_m)
    m_eye = shift @ rotation_y(sign * conv_angle)
    conv_inv_z = torch.tan(conv_angle) / (st.pupillary_distance_m / 2.0)
    normals_t = torch.einsum("nij,nhwj->nhwi", m_eye[:, :3, :3], normals)
    color_out, _, found, edge_mask = sweep_warp(
        depth, color, k, shift, st.num_planes, True, conv_inv_z, edge=edge)
    hole = ~found
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    image = torch.where(hole[..., None], zero, color_out)
    green = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    mask_img = torch.where(hole[..., None], green, zero)

    a_color, _, a_found, _ = sweep_warp(
        torch.where(edge_mask, depth, zero),
        torch.cat([color, (normals_t + 1.0) / 2.0], dim=-1), k, shift,
        max(st.num_planes // 4, 8), False, conv_inv_z)
    a_n = _normalized(a_color[..., 3:] * 2.0 - 1.0)
    write = (a_found & hole)[..., None]
    image = torch.where(write, a_color[..., :3], image)
    mask_img = torch.where(write, (a_n + 1.0) / 2.0, mask_img)

    mask_img = _border_default_normals(mask_img, hole)
    is_green = torch.all(mask_img == green, dim=-1)
    is_black = torch.all(mask_img == 0.0, dim=-1)
    filled = _inpaint_multiscale(mask_img, is_green | is_black,
                                 st.inpaint_iters // 3, 2, 8)
    mask_img = torch.where(is_green[..., None], filled, mask_img)
    keep = ~torch.all(mask_img == 0.0, dim=-1)
    mask_img = _masked_blur(mask_img, 5, keep)
    mask_img = torch.where(hole[..., None], mask_img, zero)
    return image, mask_img


def _to_u8(x):
    return (x * 255).to(torch.uint8)


@torch.no_grad()
def render_sbs(depth_m, color_u8, xfovs, conv_depths, st=StereoSettings(),
               round_depth_to=None):
    """The stereo step of frames whose metric depth is given.

    depth_m (B, H, W) float32 meters and color_u8 (B, H, W, 3) on the
    device; xfovs, conv_depths: (B,) host floats. -> (SBS image, infill
    mask), each (B, H, 2 W, 3) uint8 on the device."""
    b, h, w = depth_m.shape
    dev = depth_m.device
    ks = torch.stack([camera_matrix(w, h, float(xf)) for xf in xfovs]).to(dev)
    scales = [1.0 / (math.tan(math.radians(st.master_xfov / 2))
                     / math.tan(math.radians(float(xf) / 2)))
              for xf in xfovs]
    scale = torch.tensor(scales, dtype=torch.float32, device=dev)
    depth = decode_depth_frame(encode_depth_frame(depth_m, st.max_depth),
                               st.max_depth) * scale[:, None, None]
    if round_depth_to is not None:
        depth = depth.to(round_depth_to).to(torch.float32)
    colf = color_u8.to(torch.float32) / 255.0
    conv_d = torch.tensor([float(c) for c in conv_depths],
                          dtype=torch.float32, device=dev) * scale
    conv = torch.where(conv_d > 0, torch.atan2(
        torch.full_like(conv_d, st.pupillary_distance_m / 2.0), conv_d),
        torch.zeros_like(conv_d))
    half = st.pupillary_distance_m / 2.0
    edge = cell_edge_mask(unproject_depth(depth, ks))
    normals = normals_from_depth(depth, ks)

    def twice(x):
        return torch.cat([x, x])

    shift = torch.cat([torch.full((b,), -half, device=dev),
                       torch.full((b,), half, device=dev)])
    img, mask_img = _render_eyes(twice(depth), twice(colf), twice(ks), shift,
                                 twice(conv), st, twice(edge), twice(normals))
    image = torch.cat([_to_u8(img[:b]), _to_u8(img[b:])], dim=2)
    mask = torch.cat([_to_u8(mask_img[:b]), _to_u8(mask_img[b:])], dim=2)
    return image, mask
