"""The port's disparity sweep against the JAX package's Pallas kernel (run
in interpret mode, as the JAX package's own tests run it on the CPU).

The plain version rounds the lerp as XLA does (one fused multiply-add,
see ``warp_sweep.blend``), so the two agree bit for bit: ``found``, best
z and payload are held equal. ``stereo_sweep_warp`` computes its plane set
with ops that round differently in XLA and PyTorch (1/z, tan): there
``found`` is held equal, z within 1e-5 relative and payload within 1e-6
absolute. The fused main + anchor sweep (``disparity_sweep_dual``) is held
the same way against its Pallas kernel in interpret mode. On the card the
kernels equal their plain versions bit for bit (tests/test_torch_gpu.py).
The CUDA sweep core skips the float64 blend where a float32 pre-test
proves a plane cannot hit; ``warp_sweep.sweep_pretest`` twins that
predicate, and the tests at the end hold it sound on adversarial draws."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
import jax.numpy as jnp

from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.ops import rasterize as jras
from metric_depth_video_toolbox_tpu.ops import warp_pallas as wp
from metric_depth_video_toolbox_tpu_torch.ops import geometry as tgeo
from metric_depth_video_toolbox_tpu_torch.ops import rasterize as tras
from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws
from port_helpers import _one_torch_thread  # noqa: F401


def T(a):
    """numpy -> torch with a leading batch axis of 1."""
    return torch.from_numpy(np.array(a))[None]


def piecewise_scene(rng, h, w):
    yy = np.linspace(0, 1, h)[:, None]
    depth = np.tile(3 + 20 * yy, (1, w)).astype(np.float32)
    depth[h // 5:3 * h // 5, w // 8:w // 3] = 2.5
    depth[2 * h // 5:9 * h // 10, w // 2:5 * w // 6] = 7.0
    depth *= 1 + 0.01 * rng.standard_normal((h, w)).astype(np.float32)
    return depth


def sweep_planes(depth, num_planes, fx_tx=15.75, conv=0.0):
    zn, zf = depth.min(), depth.max()
    inv_near = np.float32(1 / zn)
    d_inv = np.float32((1 / zn - 1 / zf) / (num_planes - 1))
    pz = (1 / (inv_near - d_inv * np.arange(num_planes, dtype=np.float32))
          ).astype(np.float32)
    tol = (1.6 * pz * pz * d_inv + 1e-4).astype(np.float32)
    disp = np.clip(-fx_tx * (1 / pz - conv), -254, 254).astype(np.float32)
    di = np.floor(disp).astype(np.int32)
    df = (disp - np.floor(disp)).astype(np.float32)
    return inv_near, d_inv, pz, tol, di, df


def run_both(dpad, cpad, di, df, pz, tol, num_planes, pad_l, active=None):
    want = wp.disparity_sweep(
        jnp.asarray(dpad), jnp.asarray(cpad), jnp.asarray(di),
        jnp.asarray(df), jnp.asarray(pz), jnp.asarray(tol),
        num_planes=num_planes, pad_left=pad_l, interpret=True,
        active=None if active is None else jnp.asarray(active))
    got = ws.disparity_sweep(T(dpad), T(cpad), T(di), T(df), T(pz), T(tol),
                             num_planes, pad_l,
                             None if active is None else T(active))
    return [np.asarray(a) for a in want], [a[0].numpy() for a in got]


def assert_sweeps_agree(want, got):
    (bz, col, found), (bz2, col2, found2) = want, got
    np.testing.assert_array_equal(found2, found)
    np.testing.assert_array_equal(bz2, np.where(found, bz, ws.INF_DEPTH))
    np.testing.assert_array_equal(col2, col)


def test_pad_widths_match():
    for w, md in [(64, 128), (1920, 256), (100, 300)]:
        assert ws.pad_widths(w, md) == wp.pad_widths(w, md)


@pytest.mark.parametrize("num_planes", [32, 128])
def test_plane_activity_bit_equal(num_planes):
    rng = np.random.default_rng(num_planes)
    depth = piecewise_scene(rng, 150, 96)
    depth[:7, :5] = 0.0                       # invalid pixels
    inv_near, d_inv = sweep_planes(depth[depth > 0], num_planes)[:2]
    want = np.asarray(wp.plane_activity(jnp.asarray(depth), inv_near,
                                        d_inv, num_planes))
    got = ws.plane_activity(T(depth), torch.tensor([inv_near]),
                            torch.tensor([d_inv]), num_planes)[0].numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_plane_activity_all_invalid_is_empty():
    depth = torch.zeros(2, 70, 40)
    act = ws.plane_activity(depth, torch.full((2,), 0.0),
                            torch.full((2,), 0.0), 16)
    assert act.shape == (2, 2, 16) and int(act.sum()) == 0


def test_disparity_sweep_constant_depth_shift():
    h, w = 16, 256
    depth = np.full((h, w), 4.0, np.float32)
    color = np.zeros((3, h, w), np.float32)
    color[0] = np.linspace(0, 1, w)[None, :]
    pad_l, pad_r = wp.pad_widths(w, 128)
    dpad = np.pad(depth, ((0, 0), (pad_l, pad_r)))
    cpad = np.pad(color, ((0, 0), (0, 0), (pad_l, pad_r)))
    args = (dpad, cpad, np.asarray([10], np.int32),
            np.asarray([0.25], np.float32), np.asarray([4.0], np.float32),
            np.asarray([0.5], np.float32), 1, pad_l)
    want, got = run_both(*args)
    assert_sweeps_agree(want, got)
    xs = np.arange(0, w - 12)
    assert got[2][:, : w - 12].all() and not got[2][:, -2:].any()
    np.testing.assert_allclose(got[1][5, xs, 0], (xs + 10.25) / (w - 1),
                               atol=1e-3)


def test_disparity_sweep_front_plane_wins():
    h, w = 8, 128
    depth = np.full((h, w), 8.0, np.float32)
    depth[:, 40:80] = 2.0
    color = np.ones((3, h, w), np.float32)
    pad_l, pad_r = wp.pad_widths(w, 128)
    dpad = np.pad(depth, ((0, 0), (pad_l, pad_r)))
    cpad = np.pad(color, ((0, 0), (0, 0), (pad_l, pad_r)))
    want, got = run_both(dpad, cpad, np.asarray([0, 0], np.int32),
                         np.asarray([0.0, 0.0], np.float32),
                         np.asarray([2.0, 8.0], np.float32),
                         np.asarray([0.3, 0.3], np.float32), 2, pad_l)
    assert_sweeps_agree(want, got)
    assert np.allclose(got[0][:, 45:75], 2.0, atol=0.05)
    assert got[2].all()


@pytest.mark.parametrize("n_chan,num_planes", [(3, 128), (6, 32)])
def test_disparity_sweep_piecewise_scene_with_bitmap(n_chan, num_planes):
    """The main (P=128, 3 channels) and anchor (P=32, 6 channels) sweeps
    of the stereo step on a piecewise-smooth scene, activity bitmap on."""
    rng = np.random.default_rng(7)
    h, w = 96, 200
    depth = piecewise_scene(rng, h, w)
    inv_near, d_inv, pz, tol, di, df = sweep_planes(depth, num_planes,
                                                    conv=0.1)
    pad_l, pad_r = wp.pad_widths(w, 256)
    dpad = np.pad(depth, ((0, 0), (pad_l, pad_r)))
    cpad = np.pad(rng.random((n_chan, h, w), np.float32),
                  ((0, 0), (0, 0), (pad_l, pad_r)))
    active = np.asarray(wp.plane_activity(jnp.asarray(depth), inv_near,
                                          d_inv, num_planes))
    assert 0 < active.mean() < 1
    want, got = run_both(dpad, cpad, di, df, pz, tol, num_planes, pad_l,
                         active)
    assert_sweeps_agree(want, got)
    assert got[2].mean() > 0.9


def test_disparity_sweep_batch_elements_independent():
    """Per-element plane vectors: a batch of two equals two calls."""
    rng = np.random.default_rng(8)
    h, w, p = 40, 64, 16
    pad_l, pad_r = ws.pad_widths(w, 128)
    outs = []
    args = []
    for i in range(2):
        depth = piecewise_scene(rng, h, w) * (1 + i)
        _, _, pz, tol, di, df = sweep_planes(depth, p, fx_tx=8.0 * (i + 1))
        dpad = np.pad(depth, ((0, 0), (pad_l, pad_r)))
        cpad = np.pad(rng.random((3, h, w), np.float32),
                      ((0, 0), (0, 0), (pad_l, pad_r)))
        args.append([dpad, cpad, di, df, pz, tol])
        outs.append(ws.disparity_sweep(*[T(a) for a in args[-1]], p, pad_l))
    stacked = [torch.from_numpy(np.stack([args[0][k], args[1][k]]))
               for k in range(6)]
    both = ws.disparity_sweep(*stacked, p, pad_l)
    for i in range(2):
        for k in range(3):
            assert torch.equal(both[k][i], outs[i][k][0])


@pytest.mark.parametrize("rotate", [False, True])
def test_stereo_sweep_warp_matches_jax(rotate):
    """neutralize_rotation False (HIT convergence) and True (toe-in)."""
    rng = np.random.default_rng(2)
    h, w = 64, 192
    k = np.asarray(jgeo.camera_matrix_from_fov(w, h, xfov_deg=60.0),
                   np.float32)
    depth = piecewise_scene(rng, h, w) + 1.0
    color = rng.random((h, w, 3), np.float32)
    if rotate:
        m = np.asarray(jgeo.rotation_y(np.radians(1.0))
                       @ jgeo.translation_matrix(0.0315, 0., 0.), np.float32)
    else:
        m = np.asarray(jgeo.translation_matrix(-0.0315, 0., 0.), np.float32)
    conv = 0.0 if rotate else 0.2
    want = jras.stereo_sweep_warp(
        jnp.asarray(depth), jnp.asarray(color), jnp.asarray(k),
        jnp.asarray(m), num_planes=128, neutralize_rotation=rotate,
        conv_inv_z=conv, interpret=True)
    got = tras.stereo_sweep_warp(T(depth), T(color), T(k), T(m),
                                 num_planes=128, neutralize_rotation=rotate,
                                 conv_inv_z=conv)
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask[0].numpy(), mask)
    np.testing.assert_array_equal(got.edge_mask[0].numpy(),
                                  np.asarray(want.edge_mask))
    assert mask.mean() > 0.9 and np.asarray(want.edge_mask).any()
    np.testing.assert_allclose(got.depth[0].numpy()[mask],
                               np.asarray(want.depth)[mask], rtol=1e-5)
    np.testing.assert_allclose(got.color[0].numpy(), np.asarray(want.color),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("dual", [False, True])
def test_stereo_sweep_warp_honours_edge_angle(dual):
    """``edge_angle_deg`` reaches the edge cull of both warps (the single
    one used to ignore it): at 60 degrees the culled mask equals
    ``cell_edge_mask`` at 60 and holds more pixels than at the default."""
    rng = np.random.default_rng(8)
    h, w = 32, 192
    k = T(np.asarray(jgeo.camera_matrix_from_fov(w, h, xfov_deg=60.0),
                     np.float32))
    depth = T(piecewise_scene(rng, h, w) + 1.0)
    color = T(rng.random((h, w, 3), np.float32))
    m = T(np.asarray(jgeo.translation_matrix(-0.0315, 0., 0.), np.float32))

    def edge_mask(**kw):
        if dual:
            return tras.stereo_sweep_warp_dual(
                depth, color, color, k, m, num_planes=16, **kw)[0].edge_mask
        return tras.stereo_sweep_warp(depth, color, k, m, num_planes=16,
                                      **kw).edge_mask
    want = tras.cell_edge_mask(tgeo.unproject_depth(depth, k), 60.0)
    steep = edge_mask(edge_angle_deg=60.0)
    assert torch.equal(steep, want)
    assert steep.sum() > edge_mask().sum() > 0


def test_stereo_sweep_warp_identity():
    h, w = 32, 192
    k = torch.from_numpy(np.asarray(
        jgeo.camera_matrix_from_fov(w, h, xfov_deg=60.0)))[None]
    depth = torch.full((1, h, w), 5.0)
    color = torch.zeros(1, h, w, 3)
    color[..., 1] = torch.linspace(0, 1, h)[:, None]
    res = tras.stereo_sweep_warp(depth, color, k, torch.eye(4)[None],
                                 num_planes=32, remove_edges=False,
                                 neutralize_rotation=False)
    mask = res.mask[0]
    assert mask.float().mean() > 0.99
    assert (res.depth[0][mask] - 5.0).abs().max() < 0.2
    assert (res.color[0, ..., 1][mask] - color[0, ..., 1][mask]).abs() \
        .max() < 0.02


# the scenes of the JAX package's test_dual_sweep_* cases: (h, w, far depth,
# slab depth, slab columns)
DUAL_SCENES = {"two_call": (48, 256, 8.0, 2.5, (90, 150)),
               "anchor_seeds": (64, 256, 12.0, 2.0, (100, 160)),
               "rotation": (48, 256, 10.0, 3.0, (120, 170))}


def slab_scene(name):
    h, w, far, near, (c0, c1) = DUAL_SCENES[name]
    depth = np.full((h, w), far, np.float32)
    depth[:, c0:c1] = near
    return depth


@pytest.mark.parametrize("scene,n_shared,n_extra,num_planes", [
    ("two_call", 3, 3, 32), ("anchor_seeds", 3, 3, 24),
    ("rotation", 1, 2, 16)])
def test_disparity_sweep_dual_bit_equal(scene, n_shared, n_extra,
                                        num_planes):
    """The fused sweep's plain version equals the Pallas dual kernel
    (interpret mode) bit for bit on all six outputs: the slab scenes of
    the JAX package's dual-sweep tests with 1% grain, the two columns
    beside each depth step as the edge stream, both 32-row bitmaps on; and
    its main surface equals the single sweep's on the main stream."""
    rng = np.random.default_rng(num_planes)
    depth = slab_scene(scene)
    depth *= 1 + 0.01 * rng.standard_normal(depth.shape).astype(np.float32)
    h, w = depth.shape
    step = np.zeros((h, w), bool)
    step[:, 1:] = np.abs(depth[:, 1:] - depth[:, :-1]) > 1.0
    step[:, :-1] |= step[:, 1:].copy()
    main = np.where(step, 0, depth).astype(np.float32)
    edge = np.where(step, depth, 0).astype(np.float32)
    inv_near, d_inv, pz, tol, di, df = sweep_planes(main[main > 0],
                                                    num_planes, conv=0.1)
    pad_l, pad_r = wp.pad_widths(w, 256)
    pads = ((0, 0), (pad_l, pad_r))
    shared = np.pad(rng.random((n_shared, h, w), np.float32), ((0, 0),) + pads)
    extra = np.pad(rng.random((n_extra, h, w), np.float32), ((0, 0),) + pads)
    acts = [np.asarray(wp.plane_activity(jnp.asarray(d), inv_near, d_inv,
                                         num_planes, block_rows=32))
            for d in (main, edge)]
    for d, a in zip((main, edge), acts):
        got_act = ws.plane_activity(
            T(d), torch.tensor([inv_near]), torch.tensor([d_inv]),
            num_planes, block_rows=ws.DUAL_BLOCK_ROWS)[0].numpy()
        np.testing.assert_array_equal(got_act, a)
    assert 0 < acts[1].mean() <= acts[0].mean() < 1
    args = (np.pad(main, pads), np.pad(edge, pads), shared, extra, di, df, pz,
            tol, acts[0], acts[1])
    want = wp.disparity_sweep_dual(*[jnp.asarray(a) for a in args],
                                   num_planes=num_planes, pad_left=pad_l,
                                   block_rows=32, interpret=True)
    before = dict(ws.LAUNCHES)
    got = ws.disparity_sweep_dual(*[T(a) for a in args], num_planes, pad_l)
    assert ws.LAUNCHES == before                  # plain version, no launch
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w_))
    assert got[2].float().mean() > 0.8 and got[5].any()
    single = ws.disparity_sweep(
        T(args[0]), T(shared), T(di), T(df), T(pz), T(tol), num_planes, pad_l,
        ws.plane_activity(T(main), torch.tensor([inv_near]),
                          torch.tensor([d_inv]), num_planes))
    for g, s_ in zip(got[:3], single):
        assert torch.equal(g, s_)


@pytest.mark.parametrize("scene,rotate", [("two_call", False),
                                          ("rotation", True)])
def test_stereo_sweep_warp_dual_matches_jax(scene, rotate):
    """``stereo_sweep_warp_dual`` against the JAX package's (Pallas kernel
    in interpret mode) on its own dual-sweep scenes: masks equal, depth
    within 1e-5 relative, payloads within 1e-6 absolute (the plane set's
    1/z and the rotation resample round differently in XLA and PyTorch);
    and the port's main surface equals its single sweep's bit for bit."""
    rng = np.random.default_rng(3)
    depth = slab_scene(scene)
    h, w = depth.shape
    k = np.asarray(jgeo.camera_matrix_from_fov(w, h, xfov_deg=60.0),
                   np.float32)
    color = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    extra = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    if rotate:
        m = np.asarray(jgeo.rotation_y(np.radians(1.0))
                       @ jgeo.translation_matrix(0.05, 0., 0.), np.float32)
    else:
        m = np.eye(4, dtype=np.float32)
        m[0, 3] = 0.1
    want = jras.stereo_sweep_warp_dual(
        jnp.asarray(depth), jnp.asarray(color), jnp.asarray(extra),
        jnp.asarray(k), jnp.asarray(m), num_planes=24,
        neutralize_rotation=rotate, interpret=True)
    got = tras.stereo_sweep_warp_dual(T(depth), T(color), T(extra), T(k),
                                      T(m), num_planes=24,
                                      neutralize_rotation=rotate)
    mask = np.asarray(want[0].mask)
    np.testing.assert_array_equal(got[0].mask[0].numpy(), mask)
    np.testing.assert_array_equal(got[0].edge_mask[0].numpy(),
                                  np.asarray(want[0].edge_mask))
    np.testing.assert_array_equal(got[3][0].numpy(), np.asarray(want[3]))
    assert mask.mean() > 0.8 and np.asarray(want[3]).any()
    np.testing.assert_allclose(got[0].depth[0].numpy()[mask],
                               np.asarray(want[0].depth)[mask], rtol=1e-5)
    for g, w_ in ((got[0].color, want[0].color), (got[1], want[1]),
                  (got[2], want[2])):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w_), atol=1e-6,
                                   rtol=0)
    single = tras.stereo_sweep_warp(T(depth), T(color), T(k), T(m),
                                    num_planes=24, neutralize_rotation=rotate)
    for name in ("color", "depth", "mask", "edge_mask"):
        assert torch.equal(getattr(got[0], name), getattr(single, name))


def test_sweep_wrapper_rejects_other_devices():
    z = torch.zeros(1, 2, 300)
    args = [z, torch.zeros(1, 3, 2, 300), torch.zeros(1, 1, dtype=torch.int32),
            torch.zeros(1, 1), torch.ones(1, 1), torch.ones(1, 1)]
    with pytest.raises(ValueError, match="several devices"):
        ws.disparity_sweep(z.to("meta"), *args[1:], 1, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ws.disparity_sweep(*[a.to("meta") for a in args], 1, 0)
    before = ws.LAUNCHES["disparity_sweep"]
    ws.disparity_sweep(*args, 1, 0)
    assert ws.LAUNCHES["disparity_sweep"] == before   # plain, no launch


# --- the sweep core's float32 pre-test (csrc/sweep_sm90.cuh ``may_hit``) --

def real_hit(a, b, f, z, tol):
    """The sweep's plane test on float32 tensors, as the kernels run it."""
    d = ws.blend(a, b, f)
    return (torch.abs(d - z) < tol) & (d > 1e-3), d


def adversarial_draws(rng, n):
    """Seeded float32 draws at the pre-test's edges: f at 0, 2^-24,
    1 - 2^-24 and 1; a = b; a or b = 0; values near 1e-3; z placed at the
    blended value or one float away and tol exactly at |d - z| or one float
    above it."""
    f32 = np.float32
    mag = np.exp(rng.uniform(np.log(1e-5), np.log(1e3), n)).astype(f32)
    a = mag
    b = (mag * (1 + rng.uniform(-1e-6, 1e-6, n))).astype(f32)
    kind = rng.integers(0, 6, n)
    b = np.where(kind == 0, a, b)                               # a = b
    b = np.where(kind == 1, f32(0), b)                          # b = 0
    a = np.where(kind == 2, f32(0), a)                          # a = 0
    near = (1e-3 * (1 + rng.uniform(-1e-5, 1e-5, n))).astype(f32)
    a = np.where(kind == 3, near, a)                            # 1e-3 edge
    b = np.where(kind == 3, near, b)
    b = np.where(kind == 4, (a * f32(0.5)).astype(f32), b)      # a != b
    b = np.where(kind == 5, (a * f32(37.0)).astype(f32), b)     # b >> a
    edges = np.array([0, 2 ** -24, 1 - 2 ** -24, 1, 0.5], f32)
    f = np.where(rng.random(n) < 0.5, edges[rng.integers(0, 5, n)],
                 rng.random(n).astype(f32)).astype(f32)
    a, b, f = (torch.from_numpy(np.ascontiguousarray(v)) for v in (a, b, f))
    d = ws.blend(a, b, f)
    step = torch.from_numpy(rng.integers(-2, 3, n)).float()
    z = torch.where(step == 0, d, torch.nextafter(d, d + step))
    gap = torch.abs(d - z)
    tol = torch.where(torch.from_numpy(rng.random(n) < 0.5), gap,
                      torch.nextafter(gap, torch.full_like(gap, 1.0)))
    return a, b, f, z, tol


def test_pretest_never_rejects_a_hit_adversarial():
    """On seeded draws at every edge of the bound (1.2 million), a plane
    the real test accepts always passes the pre-test; the float32 estimate
    fma(f, b - a, a) differs from the blend on many of them, and with no margin the same
    draws contain accepted planes that the pre-test would reject, so the
    draws reach the bound."""
    rng = np.random.default_rng(2024)
    a, b, f, z, tol = adversarial_draws(rng, 1_200_000)
    hit, d = real_hit(a, b, f, z, tol)
    assert int(hit.sum()) > 100_000
    assert not (hit & ~ws.sweep_pretest(a, b, f, z, tol)).any()
    est = ws._fma32(f, b - a, a)
    assert int((est != d).sum()) > 50_000
    unsafe = hit & ~ws.sweep_pretest(a, b, f, z, tol, margin=0.0)
    assert int(unsafe.sum()) > 10


def test_pretest_rejects_most_far_planes():
    """Planes far from the sample are rejected without the blend."""
    a = torch.tensor([4.0, 4.0, 4.0, 1e-4, 4.0])
    b = torch.tensor([4.1, 4.1, 4.1, 2e-4, 4.1])
    f = torch.tensor([0.3, 0.3, 0.3, 0.3, 1.5])
    z = torch.tensor([9.0, 1.0, 4.05, 4.05, 9.0])
    tol = torch.tensor([0.5, 0.5, 0.5, 0.5, 0.5])
    got = ws.sweep_pretest(a, b, f, z, tol)
    # far behind, far in front, near, below 1e-3, f outside [0, 1]
    assert got.tolist() == [False, False, True, False, True]


def test_pretest_bounds_round_outward():
    """The directed additions give the least float32 >= z + tol and the
    greatest float32 <= z - tol, exactly (rational arithmetic); hiZ lies
    above z + tol and lowZ below max(z - tol, 1e-3)."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    z = np.concatenate([rng.uniform(0.5, 60, 300),
                        [1.0, 1.0, 3e38, 1e-30]]).astype(np.float32)
    tol = np.concatenate([np.exp(rng.uniform(-40, 1, 300)),
                          [1e-20, 2 ** -24, 3e38, 1e-38]]).astype(np.float32)
    zt, tt = torch.from_numpy(z), torch.from_numpy(tol)
    up = ws._add_directed(zt, tt, True).numpy()
    low = ws._add_directed(zt, tt, False).numpy()

    def q(v):
        return Fraction(float(v))

    for zi, ti, h, lo in zip(z, tol, up, low):
        above, below = q(zi) + q(ti), q(zi) - q(ti)
        prev = np.nextafter(h, np.float32(-np.inf))
        assert (np.isinf(h) and above > q(prev)) or q(h) >= above > q(prev)
        assert q(lo) <= below < q(np.nextafter(lo, np.float32(np.inf)))
    hiz, lowz = ws.pretest_bounds(torch.full_like(zt, 0.5), zt, tt)
    assert (hiz.numpy()[np.isfinite(up)] > up[np.isfinite(up)]).all()
    assert (lowz.numpy() < np.maximum(low, np.float32(1e-3))).all()


def test_fma32_rounds_once():
    """The twin of CUDA's fmaf equals the exactly rounded x * y + z
    (rational arithmetic), ties included."""
    from fractions import Fraction

    rng = np.random.default_rng(11)
    x = rng.uniform(-4, 4, 2000).astype(np.float32)
    y = rng.uniform(-4, 4, 2000).astype(np.float32)
    z = rng.uniform(-4, 4, 2000).astype(np.float32)
    # ties: x * y + z exactly halfway between two float32s
    x[:500], y[:500] = np.float32(1.0), np.float32(2.0 ** -24)
    z[:500] = np.float32(1.0) + np.arange(500, dtype=np.float32) * \
        np.float32(2.0 ** -23)
    got = ws._fma32(*(torch.from_numpy(v) for v in (x, y, z))).numpy()
    for xi, yi, zi, g in zip(x, y, z, got):
        exact = Fraction(float(xi)) * Fraction(float(yi)) + Fraction(float(zi))
        below = np.nextafter(g, np.float32(-np.inf))
        above = np.nextafter(g, np.float32(np.inf))
        dist = abs(Fraction(float(g)) - exact)
        assert dist <= abs(Fraction(float(below)) - exact)
        assert dist <= abs(Fraction(float(above)) - exact)
        if dist == abs(Fraction(float(above)) - exact) or \
                dist == abs(Fraction(float(below)) - exact):
            assert int(g.view(np.int32)) % 2 == 0   # ties to even


def test_pretest_bounds_disabled_outside_unit_f():
    f = torch.tensor([-0.25, 1.25, float("nan"), 0.0, 1.0])
    z, tol = torch.full((5,), 4.0), torch.full((5,), 0.5)
    hiz, lowz = ws.pretest_bounds(f, z, tol)
    assert hiz[:3].isinf().all() and (hiz[:3] > 0).all()
    assert lowz[:3].isinf().all() and (lowz[:3] < 0).all()
    assert hiz[3:].tolist() == [float(np.nextafter(np.float32(4.5),
                                                   np.float32(9)))] * 2
    assert lowz[3:].tolist() == [float(np.nextafter(np.float32(3.5),
                                                    np.float32(0)))] * 2


@settings(max_examples=400, deadline=None, derandomize=True,
          database=None)
@given(a=st.floats(0, 1e4, width=32), b=st.floats(0, 1e4, width=32),
       f=st.one_of(st.sampled_from([0.0, 2.0 ** -24, 1 - 2.0 ** -24, 1.0]),
                   st.floats(0, 1, width=32)),
       shift=st.integers(-3, 3), widen=st.booleans(),
       same=st.booleans())
def test_pretest_never_rejects_a_hit_hypothesis(a, b, f, shift, widen, same):
    """For any samples, fraction and a plane placed at the blended value
    (or a few floats off) with tol exactly at the gap (or one float above),
    a plane the real test accepts passes the pre-test."""
    a, b, f = (torch.tensor([v], dtype=torch.float32)
               for v in (a, a if same else b, f))
    d = ws.blend(a, b, f)
    z = d
    for _ in range(abs(shift)):
        z = torch.nextafter(z, z + shift)
    gap = torch.abs(d - z)
    tol = torch.nextafter(gap, gap + 1) if widen else gap
    hit, _ = real_hit(a, b, f, z, tol)
    assert not bool((hit & ~ws.sweep_pretest(a, b, f, z, tol)).any())
