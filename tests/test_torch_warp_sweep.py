"""The port's disparity sweep against the JAX package's Pallas kernel (run
in interpret mode, as the JAX package's own tests run it on the CPU).

The plain version rounds the lerp as XLA does (one fused multiply-add,
see ``warp_sweep.blend``), so the two agree bit for bit: ``found``, best
z and payload are held equal. ``stereo_sweep_warp`` computes its plane set
with ops that round differently in XLA and PyTorch (1/z, tan): there
``found`` is held equal, z within 1e-5 relative and payload within 1e-6
absolute. On the card the kernel equals the plain version bit for bit
(tests/test_torch_gpu.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.ops import rasterize as jras
from metric_depth_video_toolbox_tpu.ops import warp_pallas as wp
from metric_depth_video_toolbox_tpu_torch.ops import rasterize as tras
from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws


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
