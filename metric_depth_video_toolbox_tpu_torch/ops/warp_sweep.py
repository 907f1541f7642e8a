"""Disparity-sweep stereo warp (port of ``ops/warp_pallas.py`` B1, B2).

:func:`disparity_sweep` launches the hand-written CUDA kernel
``csrc/disparity_sweep.cu`` on CUDA tensors and runs
:func:`disparity_sweep_plain`, the same function as a per-plane PyTorch
loop, on CPU tensors. :func:`disparity_sweep_dual` (the fused main +
edge-anchor sweep) does the same with ``csrc/disparity_sweep_dual.cu`` and
:func:`disparity_sweep_dual_plain`. Both kernels run on one sweep core,
``csrc/sweep_sm90.cuh``, which rejects most planes with an exact float32
pre-test before the float64 blend; :func:`sweep_pretest` is that
predicate's twin. There is no fallback between a kernel and its plain
version: a CUDA tensor launches the kernel or raises.

Every argument carries a leading batch axis (frames x eyes); the plane
vectors and the activity bitmaps are per batch element.
"""

from __future__ import annotations

import ctypes
import threading

import torch

INF_DEPTH = 3.0e38
LANE = 128
BLOCK_ROWS = 64   # the JAX kernel's row tile; the activity bitmap's unit
DUAL_BLOCK_ROWS = 32   # the JAX dual kernel's row tile, its bitmaps' unit
MARGIN = 4        # planes of dilation in the bitmap: tolerance + lerp
# the sweep core's pre-test: the margin around its float32 estimate of the
# blend, relative to max(|a|, |b|), and the absolute slack of its
# thresholds (csrc/sweep_sm90.cuh kPreMargin, kPreSlack)
PRETEST_MARGIN = 2.0 ** -19
PRETEST_SLACK = 2.0 ** -120

# kernel launches by wrapper name; each wrapper adds one per launch
LAUNCHES = {"disparity_sweep": 0, "disparity_sweep_dual": 0}
_LOCK = threading.Lock()   # the library's typing and the launch counts


def pad_widths(width, max_disparity):
    """(pad_left, pad_right) of the padded source rows."""
    pad_left = ((max_disparity + LANE - 1) // LANE) * LANE
    return pad_left, pad_left + 2 * LANE


def plane_activity(depth, inv_near, d_inv, num_planes,
                   block_rows=BLOCK_ROWS):
    """Per-(row-tile, plane) activity bitmap for the sweep.

    depth (B, H, W); inv_near, d_inv (B,). A plane is active in a
    ``block_rows``-row tile when some valid source depth of the tile
    buckets into it (uniform inverse depth bins), dilated by MARGIN planes.
    -> (B, ntiles, P) int32, equal to the JAX package's bit-packed
    formulation.
    """
    b, h, w = depth.shape
    ntiles = -(-h // block_rows)
    d = torch.nn.functional.pad(depth, (0, 0, 0, ntiles * block_rows - h))
    valid = d > 1e-3
    inv = torch.where(valid, 1.0 / torch.clamp(d, min=1e-6),
                      torch.zeros_like(d))
    q = torch.round((inv_near[:, None, None] - inv) / d_inv[:, None, None])
    q = torch.where(valid, q, torch.zeros_like(q))
    bins = torch.clamp(q, 0, num_planes - 1).to(torch.int64)
    tile = torch.arange(ntiles * block_rows, device=depth.device) \
        // block_rows
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


def _check_args(depth_pad, color_pad, disp_int, disp_frac, plane_z,
                plane_tol, num_planes, active, block_rows=BLOCK_ROWS):
    if depth_pad.ndim != 3 or color_pad.ndim != 4:
        raise ValueError("depth_pad must be (B, H, WP) and color_pad "
                         "(B, C, H, WP)")
    b, h, wp = depth_pad.shape
    if color_pad.shape[0] != b or color_pad.shape[2:] != (h, wp):
        raise ValueError(f"color_pad {tuple(color_pad.shape)} does not "
                         f"match depth_pad {tuple(depth_pad.shape)}")
    ntiles = -(-h // block_rows)
    want = {"disp_int": (disp_int, torch.int32, (b, num_planes)),
            "disp_frac": (disp_frac, torch.float32, (b, num_planes)),
            "plane_z": (plane_z, torch.float32, (b, num_planes)),
            "plane_tol": (plane_tol, torch.float32, (b, num_planes)),
            "active": (active, torch.int32, (b, ntiles, num_planes)),
            "depth_pad": (depth_pad, torch.float32, (b, h, wp)),
            "color_pad": (color_pad, torch.float32, tuple(color_pad.shape))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return b, h, wp, color_pad.shape[1], ntiles


def disparity_sweep_plain(depth_pad, color_pad, disp_int, disp_frac, plane_z,
                          plane_tol, num_planes, pad_left, active=None,
                          block_rows=BLOCK_ROWS):
    """The sweep as a per-plane PyTorch loop (the kernel's plain version).

    Same arguments and results as :func:`disparity_sweep` (``block_rows``:
    the rows per tile of ``active``); every blend (:func:`blend`) and test
    is the kernel's arithmetic in separate elementwise ops, so on the card
    it equals the kernel bit for bit."""
    b, h, wp = depth_pad.shape
    c = color_pad.shape[1]
    w = wp - (2 * pad_left + 2 * LANE)
    dev = depth_pad.device
    if active is None:
        active = torch.ones((b, -(-h // block_rows), num_planes),
                            dtype=torch.int32, device=dev)
    row_tile = torch.arange(h, device=dev) // block_rows
    x = torch.arange(w, device=dev)
    best_z = torch.full((b, h, w), INF_DEPTH, dtype=torch.float32,
                        device=dev)
    color = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    found = torch.zeros((b, h, w), dtype=torch.bool, device=dev)

    def sample(src, idx):
        """src (..., WP) read at idx (B, W), zero outside [0, WP)."""
        inside = (idx >= 0) & (idx < wp)
        idx = idx.clamp(0, wp - 1)
        shape = src.shape[:-1] + (w,)
        view = (b,) + (1,) * (src.ndim - 2) + (w,)
        val = torch.gather(src, -1, idx.reshape(view).expand(shape))
        return torch.where(inside.reshape(view), val, torch.zeros_like(val))

    for p in range(num_planes):
        s = x[None, :] + (disp_int[:, p].to(torch.int64) + pad_left)[:, None]
        f = disp_frac[:, p, None, None]
        d = blend(sample(depth_pad, s), sample(depth_pad, s + 1), f)
        act = (active[:, row_tile, p] > 0)[:, :, None]
        ok = ((torch.abs(d - plane_z[:, p, None, None])
               < plane_tol[:, p, None, None])
              & (d > 1e-3) & ~found & act)
        best_z = torch.where(ok, d, best_z)
        pay = blend(sample(color_pad, s), sample(color_pad, s + 1),
                    f[:, None]).permute(0, 2, 3, 1)
        color = torch.where(ok[..., None], pay, color)
        found = found | ok
    return best_z, color, found


def blend(a, b, f):
    """(1 - f) * a + f * b, float32, rounded as one fused multiply-add
    fma(1 - f, a, f * b) -- the rounding XLA gives the JAX kernel's lerp.
    The product (1 - f) * a of two float32 values is exact in float64, so
    the float64 sum rounded to float32 is the fused result (barring double
    rounding, at most once in ~2^29). The CUDA kernel evaluates the same
    float64 expression, so the two agree bit for bit."""
    return ((1.0 - f).double() * a.double() + (f * b).double()).float()


def _add_directed(x, y, up):
    """float32 x + y rounded toward +inf (``up``) or x - y toward -inf, as
    CUDA's __fadd_ru / __fsub_rd: the float64 sum and its TwoSum error
    decide which float32 neighbour of the exact value is taken."""
    xd, yd = x.double(), (y if up else -y).double()
    s = xd + yd
    bb = s - xd
    err = (xd - (s - bb)) + (yd - bb)
    f = s.float()
    fd = f.double()
    if up:
        move = (fd < s) | ((fd == s) & (err > 0))
        return torch.where(move, torch.nextafter(
            f, torch.full_like(f, float("inf"))), f)
    move = (fd > s) | ((fd == s) & (err < 0))
    return torch.where(move, torch.nextafter(
        f, torch.full_like(f, -float("inf"))), f)


def pretest_bounds(f, z, tol):
    """Per plane (hiZ, lowZ) of the sweep core's pre-test: (z + tol rounded
    up) + 2^-120 rounded up, and max(z - tol rounded down, 1e-3) - 2^-120
    rounded down; +inf and -inf (never reject) where f is outside [0, 1] or
    NaN. All float32."""
    unit = (f >= 0) & (f <= 1)
    inf = torch.full_like(z, float("inf"))
    slack = torch.full_like(z, PRETEST_SLACK)
    hiz = _add_directed(_add_directed(z, tol, True), slack, True)
    lowz = _add_directed(torch.fmax(_add_directed(z, tol, False),
                                    torch.full_like(z, 1e-3)), slack, False)
    return torch.where(unit, hiz, inf), torch.where(unit, lowz, -inf)


def _fma32(x, y, z):
    """x * y + z on float32 tensors rounded once, as CUDA's __fmaf_rn: the
    product is exact in float64; the float64 sum and its TwoSum error
    decide the rounding where the sum is a tie between two float32s."""
    p, zd = x.double() * y.double(), z.double()
    s = p + zd
    bb = s - p
    err = (p - (s - bb)) + (zd - bb)
    f = s.float()
    inf = torch.full_like(f, float("inf"))
    lo = torch.where(f.double() <= s, f, torch.nextafter(f, -inf))
    hi = torch.nextafter(lo, inf)
    tie = (s - lo.double()) == (hi.double() - s)
    return torch.where(tie & (err > 0), hi,
                       torch.where(tie & (err < 0), lo, f))


def _blend_bounds(a, b, f, margin=PRETEST_MARGIN):
    """The sweep core's bounds [lo, hi] on blend(a, b, f), f in [0, 1]:
    est = fma(f, b - a, a), then fma(-/+margin, max(|a|, |b|), est)."""
    est = _fma32(f, b - a, a)
    m = torch.fmax(a.abs(), b.abs())
    return (_fma32(torch.full_like(m, -margin), m, est),
            _fma32(torch.full_like(m, margin), m, est))


def sweep_pretest(a, b, f, z, tol, margin=PRETEST_MARGIN):
    """The sweep core's float32 pre-test (csrc/sweep_sm90.cuh ``may_hit``):
    False only where ``blend(a, b, f)`` cannot pass the plane's test
    |d - z| < tol and d > 1e-3, so the kernel skips the float64 blend
    there. The estimate fma(f, b - a, a) and its bounds fma(-/+margin,
    max(|a|, |b|), estimate) are rounded as the kernel rounds them. All
    arguments float32 and broadcastable; ``margin`` as the kernel's (other
    values for tests of the bound)."""
    hiz, lowz = pretest_bounds(f, z, tol)
    lo, hi = _blend_bounds(a, b, f, margin)
    return ~((lo >= hiz) | (hi <= lowz))


def disparity_sweep(depth_pad, color_pad, disp_int, disp_frac, plane_z,
                    plane_tol, num_planes, pad_left, active=None):
    """Run the plane sweep.

    depth_pad: (B, H, W + pads) f32 rotation-neutralized source depth,
               zero-padded (pad_left left, pad_left + 256 right).
    color_pad: (B, C, H, W + pads) f32 channel-planar padded payload.
    disp_int/disp_frac: (B, P) i32/f32 per-plane disparity.
    plane_z/plane_tol: (B, P) f32 plane depth and tolerance.
    active: optional (B, ntiles, P) int32 from :func:`plane_activity`.

    Returns (best_z (B, H, W), color (B, H, W, C), found (B, H, W) bool).
    CPU tensors run :func:`disparity_sweep_plain`; CUDA tensors launch
    the kernel (and count the launch in ``LAUNCHES``).
    """
    tensors = [depth_pad, color_pad, disp_int, disp_frac, plane_z,
               plane_tol] + ([active] if active is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"arguments on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return disparity_sweep_plain(depth_pad, color_pad, disp_int,
                                     disp_frac, plane_z, plane_tol,
                                     num_planes, pad_left, active)
    if dev.type != "cuda":
        raise ValueError(f"disparity_sweep runs on cuda or cpu, not {dev}")
    if active is None:
        active = torch.ones((depth_pad.shape[0],
                             -(-depth_pad.shape[1] // BLOCK_ROWS),
                             num_planes), dtype=torch.int32, device=dev)
    b, h, wp, c, ntiles = _check_args(depth_pad, color_pad, disp_int,
                                      disp_frac, plane_z, plane_tol,
                                      num_planes, active)
    w = wp - (2 * pad_left + 2 * LANE)
    if w <= 0:
        raise ValueError(f"padded width {wp} leaves no image columns")
    args = [t.contiguous() for t in (depth_pad, color_pad, disp_int,
                                     disp_frac, plane_z, plane_tol, active)]
    out_z = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    out_color = torch.empty((b, h, w, c), dtype=torch.float32, device=dev)
    found = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().mdvt_disparity_sweep(
            *[t.data_ptr() for t in args], out_z.data_ptr(),
            out_color.data_ptr(), found.data_ptr(), b, h, w, wp, c,
            num_planes, pad_left, ntiles, BLOCK_ROWS, stream)
    if rc != 0:
        raise RuntimeError(f"disparity_sweep kernel launch failed: CUDA "
                           f"error {rc} (error 1: rows of {wp} columns do "
                           f"not fit in a block's shared memory)")
    _count("disparity_sweep")
    return out_z, out_color, found


def disparity_sweep_dual_plain(depth_pad, edepth_pad, shared_pad, extra_pad,
                               disp_int, disp_frac, plane_z, plane_tol,
                               active_main, active_edge, num_planes,
                               pad_left):
    """The fused sweep's plain version: the two streams share planes and
    disparities and nothing else, so it is :func:`disparity_sweep_plain`
    once per stream over bitmaps of DUAL_BLOCK_ROWS-row tiles, the main
    stream carrying the shared payload and the edge stream the shared and
    the extra one. Same arguments and results as
    :func:`disparity_sweep_dual`."""
    n_shared = shared_pad.shape[1]
    best_z, main_color, found = disparity_sweep_plain(
        depth_pad, shared_pad, disp_int, disp_frac, plane_z, plane_tol,
        num_planes, pad_left, active_main, block_rows=DUAL_BLOCK_ROWS)
    _, edge_pay, efound = disparity_sweep_plain(
        edepth_pad, torch.cat([shared_pad, extra_pad], dim=1), disp_int,
        disp_frac, plane_z, plane_tol, num_planes, pad_left, active_edge,
        block_rows=DUAL_BLOCK_ROWS)
    return (best_z, main_color, found, edge_pay[..., :n_shared].contiguous(),
            edge_pay[..., n_shared:].contiguous(), efound)


def disparity_sweep_dual(depth_pad, edepth_pad, shared_pad, extra_pad,
                         disp_int, disp_frac, plane_z, plane_tol,
                         active_main, active_edge, num_planes, pad_left):
    """Run the fused main + edge-anchor plane sweep.

    depth_pad:  (B, H, W + pads) f32 main (edge-culled) source depth,
                0 = invalid, padded as for :func:`disparity_sweep`.
    edepth_pad: (B, H, W + pads) f32 edge-only source depth, 0 = invalid.
    shared_pad: (B, S, H, W + pads) f32 payload of both surfaces (color).
    extra_pad:  (B, E, H, W + pads) f32 payload of the edge surface only
                (encoded normals).
    disp_int/disp_frac, plane_z/plane_tol: (B, P), one plane set for both.
    active_main/active_edge: (B, ntiles, P) int32 from
                :func:`plane_activity` with ``block_rows=DUAL_BLOCK_ROWS``.

    Returns (best_z (B, H, W), main_color (B, H, W, S), main_found bool,
    edge_color (B, H, W, S), edge_extra (B, H, W, E), edge_found bool);
    best_z is INF_DEPTH where the main surface has no hit. CPU tensors run
    :func:`disparity_sweep_dual_plain`; CUDA tensors launch the kernel (and
    count the launch in ``LAUNCHES``).
    """
    tensors = [depth_pad, edepth_pad, shared_pad, extra_pad, disp_int,
               disp_frac, plane_z, plane_tol, active_main, active_edge]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"arguments on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return disparity_sweep_dual_plain(*tensors, num_planes, pad_left)
    if dev.type != "cuda":
        raise ValueError(f"disparity_sweep_dual runs on cuda or cpu, not "
                         f"{dev}")
    if extra_pad.ndim != 4 or extra_pad.dtype != torch.float32 \
            or extra_pad.shape[0] != depth_pad.shape[0] \
            or extra_pad.shape[2:] != depth_pad.shape[1:]:
        raise ValueError(f"extra_pad {extra_pad.dtype} "
                         f"{tuple(extra_pad.shape)} does not match "
                         f"depth_pad {tuple(depth_pad.shape)}")
    for name, t, like in (("edepth_pad", edepth_pad, depth_pad),
                          ("active_edge", active_edge, active_main)):
        if t.dtype != like.dtype or t.shape != like.shape:
            raise ValueError(f"{name}: expected {like.dtype} "
                             f"{tuple(like.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    b, h, wp, s, ntiles = _check_args(
        depth_pad, shared_pad, disp_int, disp_frac, plane_z, plane_tol,
        num_planes, active_main, block_rows=DUAL_BLOCK_ROWS)
    e = extra_pad.shape[1]
    w = wp - (2 * pad_left + 2 * LANE)
    if w <= 0:
        raise ValueError(f"padded width {wp} leaves no image columns")
    args = [t.contiguous() for t in tensors]
    f32 = {"dtype": torch.float32, "device": dev}
    out_z = torch.empty((b, h, w), **f32)
    main_color = torch.empty((b, h, w, s), **f32)
    found = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    edge_color = torch.empty((b, h, w, s), **f32)
    edge_extra = torch.empty((b, h, w, e), **f32)
    efound = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    outs = (out_z, main_color, found, edge_color, edge_extra, efound)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library("disparity_sweep_dual").mdvt_disparity_sweep_dual(
            *[t.data_ptr() for t in args], *[t.data_ptr() for t in outs],
            b, h, w, wp, s, e, num_planes, pad_left, ntiles,
            DUAL_BLOCK_ROWS, stream)
    if rc != 0:
        raise RuntimeError(f"disparity_sweep_dual kernel launch failed: "
                           f"CUDA error {rc} (error 1: rows of {wp} columns "
                           f"do not fit in a block's shared memory)")
    _count("disparity_sweep_dual")
    return outs


# pointer and int argument counts of each kernel's C function (a stream
# pointer follows the ints)
_SIGNATURES = {"disparity_sweep": (10, 9), "disparity_sweep_dual": (16, 10)}


def _library(name="disparity_sweep"):
    """The kernel's library, its C function typed on first use (under a
    lock: the movie's scene renders launch from worker threads)."""
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    with _LOCK:
        lib = cuda_build.load(name)
        fn = getattr(lib, f"mdvt_{name}")
        if fn.restype is not ctypes.c_int or not fn.argtypes:
            pointers, ints = _SIGNATURES[name]
            fn.argtypes = ([ctypes.c_void_p] * pointers
                           + [ctypes.c_int] * ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _count(name):
    with _LOCK:
        LAUNCHES[name] += 1
