"""The port's scatter z-buffer warps (``forward_warp``, ``splat_points``,
``warp_pixel_ids`` / ``remap_ids_to_img``), ``plane_sweep_warp``, the
geometry helpers they use, the voxel reductions and the point-cloud files,
against the JAX package, op by op on the CPU.

``forward_warp``, ``splat_points`` and the pixel ids are held bit for bit:
z-buffer, mask, payload and ids. The candidates' arithmetic follows the
JAX package's order, and among the samples within the tie tolerance of a
slot's nearest depth both packages let the last one in candidate order
write the payload (XLA's scatter on the CPU writes in order; the port
takes the highest candidate position with a second "amax" scatter).
A batch past the z-buffer's byte budget runs in passes of whole images,
which must give the one pass's result bit for bit.

``plane_sweep_warp``'s JAX sweep runs inside ``lax.scan``, whose body XLA
compiles and fuses (fused multiply-adds), so there only the hit mask and
the edge mask are held bit for bit; color within 2e-5 absolute on [0, 1]
data and depth within 5e-5 relative (measured: 7.2e-6 and 1.2e-5). A
transform's inverse (``jnp.linalg.inv`` against ``torch.linalg.inv``) also
differs in the last bits unless it is a pure translation. Its passes of
whole images are held bit for bit against one pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.io import pointcloud as jpc
from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.ops import rasterize as jras
from metric_depth_video_toolbox_tpu.ops import voxel as jvox
from metric_depth_video_toolbox_tpu_torch.io import pointcloud as tpc
from metric_depth_video_toolbox_tpu_torch.ops import geometry as tgeo
from metric_depth_video_toolbox_tpu_torch.ops import rasterize as tras
from metric_depth_video_toolbox_tpu_torch.ops import voxel as tvox
from port_helpers import _one_torch_thread  # noqa: F401

H, W = 48, 64


def T(a):
    """numpy -> torch with a leading batch axis of 1."""
    return torch.from_numpy(np.array(a))[None]


def scene(seed, h=H, w=W):
    """A ground ramp, two slabs (occluders), 1% depth grain, random
    colors in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h)[:, None]
    depth = np.tile(4 + 30 * yy, (1, w)).astype(np.float32)
    depth[10:30, 10:30] = 2.0
    depth[25:45, 35:55] = 6.5
    depth *= 1 + 0.01 * rng.standard_normal((h, w)).astype(np.float32)
    return depth, rng.random((h, w, 3)).astype(np.float32)


def rigid(seed):
    """A small seeded camera motion: yaw, then a translation."""
    rng = np.random.default_rng(seed + 100)
    a = rng.normal(size=3) * 0.05
    return (np.asarray(jgeo.rotation_y(a[0]))
            @ np.asarray(jgeo.translation_matrix(a[1], a[2], 0.02))).astype(
                np.float32)


def camera(w=W, h=H, fov=60.0):
    return np.asarray(jgeo.camera_matrix_from_fov(w, h, xfov_deg=fov),
                      np.float32)


def assert_warp_equal(got, want):
    for name in ("depth", "mask", "color", "edge_mask"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# (subsample, output size and render camera, remove_edges)
WARPS = [(2, None, True), (1, (36, 40), True), (3, None, False)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sub,out,edges", WARPS)
def test_forward_warp_matches_jax(seed, sub, out, edges):
    depth, color = scene(seed)
    k, m = camera(), rigid(seed)
    rk = k if out is None else camera(out[1], out[0], 70.0)
    out = out or (H, W)
    want = jras.forward_warp(jnp.asarray(depth), jnp.asarray(color),
                             jnp.asarray(k), jnp.asarray(rk), jnp.asarray(m),
                             out, subsample=sub, remove_edges=edges)
    got = tras.forward_warp(T(depth), T(color), T(k), T(rk), T(m), out,
                            subsample=sub, remove_edges=edges)
    assert 0.5 < float(got.mask.float().mean()) < 1.0
    assert_warp_equal(got, want)


def test_forward_warp_batch_equals_each_image():
    """One batch of images with their own cameras and transforms through
    the one scatter equals each image alone (no slot crosses images)."""
    scenes = [scene(s) for s in range(3)]
    ks = [camera(fov=f) for f in (50.0, 60.0, 75.0)]
    ms = [rigid(s) for s in range(3)]
    got = tras.forward_warp(stack([d for d, _ in scenes]),
                            stack([c for _, c in scenes]), stack(ks),
                            stack(ks), stack(ms), (H, W))
    for i, (d, c) in enumerate(scenes):
        one = tras.forward_warp(T(d), T(c), T(ks[i]), T(ks[i]), T(ms[i]),
                                (H, W))
        for a, b in zip(got, one):
            assert torch.equal(a[i], b[0])


def stack(xs):
    return torch.from_numpy(np.stack(xs))


@pytest.mark.parametrize("images_per_pass", [1, 2, 3])
def test_forward_warp_in_passes_equals_one_pass(monkeypatch,
                                                images_per_pass):
    """A byte budget that fits only ``images_per_pass`` images splits a
    batch of 5 into passes; the result is the one pass's, bit for bit."""
    scenes = [scene(s) for s in range(5)]
    ks = [camera(fov=f) for f in (50.0, 60.0, 75.0, 60.0, 50.0)]
    args = (stack([d for d, _ in scenes]), stack([c for _, c in scenes]),
            stack(ks), stack(ks), stack([rigid(s) for s in range(5)]))
    want = tras.forward_warp(*args, (H, W), subsample=2)
    per_image = H * W * 4 * (64 + 8 * 3) + H * W * (16 + 4 * 3)
    monkeypatch.setattr(tras, "ZBUFFER_BYTES", per_image * images_per_pass)
    calls = []
    zbuffer = tras._zbuffer
    monkeypatch.setattr(tras, "_zbuffer",
                        lambda idx, *a: calls.append(len(idx))
                        or zbuffer(idx, *a))
    got = tras.forward_warp(*args, (H, W), subsample=2)
    assert calls == [min(images_per_pass, 5 - i)
                     for i in range(0, 5, images_per_pass)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("radius", [0, 1])
def test_splat_points_in_passes_equals_one_pass(monkeypatch, radius):
    rng = np.random.default_rng(radius)
    pts = rng.normal(size=(4, 600, 3)).astype(np.float32)
    pts[..., 2] = np.abs(pts[..., 2]) * 3 + 0.5
    pay = rng.random((4, 600, 5)).astype(np.float32)
    ks = torch.from_numpy(np.stack([camera(fov=f)
                                    for f in (50.0, 60.0, 75.0, 60.0)]))
    args = (torch.from_numpy(pts), torch.from_numpy(pay), ks)
    want = tras.splat_points(*args, (H, W), radius=radius)
    monkeypatch.setattr(tras, "ZBUFFER_BYTES", 1)
    got = tras.splat_points(*args, (H, W), radius=radius)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("radius", [0, 1])
def test_splat_points_matches_jax(seed, radius):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(600, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) * 3 + 0.5
    pts[::7, 2] = -1.0                     # behind the camera: never land
    pay = rng.random((600, 4)).astype(np.float32)
    k = camera()
    want = jras.splat_points(jnp.asarray(pts), jnp.asarray(pay),
                             jnp.asarray(k), (H, W), radius=radius)
    got = tras.splat_points(T(pts), T(pay), T(k), (H, W), radius=radius)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_planted_ties_take_the_last_writer():
    """Many candidates at one depth (and within the tie tolerance of it) on
    one slot: the port's payload is the JAX package's, the last candidate
    in order, for point splats (several copies of a slot, radius 1) and for
    a forward warp of a flat wall whose samples pile onto few pixels."""
    k = camera()
    n = 64
    pts = np.zeros((n, 3), np.float32)
    pts[:, 2] = 5.0
    pts[n // 2:, 2] = 5.0 + 1e-3           # inside the tolerance
    pts[:, 0] = np.repeat(np.linspace(-0.05, 0.05, 4), n // 4)
    pay = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    want = jras.splat_points(jnp.asarray(pts), jnp.asarray(pay),
                             jnp.asarray(k), (H, W), radius=1)
    got = tras.splat_points(T(pts), T(pay), T(k), (H, W), radius=1)
    img = got[0][0].numpy()
    assert len(np.unique(img[got[2][0].numpy()], axis=0)) > 1
    np.testing.assert_array_equal(img, np.asarray(want[0]))
    # radius 0 against a loop: per pixel, the last point within the
    # tolerance of the nearest one
    got = tras.splat_points(T(pts), T(pay), T(k), (H, W))[0][0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jras.splat_points(
        jnp.asarray(pts), jnp.asarray(pay), jnp.asarray(k), (H, W))[0]))
    u = np.round(pts[:, 0] / pts[:, 2] * k[0, 0] + k[0, 2]).astype(int)
    v = np.round(pts[:, 1] / pts[:, 2] * k[1, 1] + k[1, 2]).astype(int)
    for px in set(zip(u, v)):
        on = np.flatnonzero((u == px[0]) & (v == px[1]))
        zmin = pts[on, 2].min()
        last = on[pts[on, 2] <= zmin * np.float32(1.001) + np.float32(1e-3)]
        assert len(on) >= 16
        np.testing.assert_array_equal(got[px[1], px[0]], pay[last.max()])
    # a far, tilted wall squeezed into a quarter-size target
    depth = np.full((H, W), 30.0, np.float32)
    color = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    rk = camera(16, 12, 60.0)
    want = jras.forward_warp(jnp.asarray(depth), jnp.asarray(color),
                             jnp.asarray(k), jnp.asarray(rk), jnp.eye(4),
                             (12, 16), subsample=2)
    got = tras.forward_warp(T(depth), T(color), T(k), T(rk),
                            torch.eye(4)[None], (12, 16), subsample=2)
    assert_warp_equal(got, want)


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("motion", ["translation", "rigid"])
def test_plane_sweep_warp_matches_jax(seed, motion):
    depth, color = scene(seed)
    k = camera()
    m = (np.asarray(jgeo.translation_matrix(0.1, 0.0, 0.0), np.float32)
         if motion == "translation" else rigid(seed))
    want = jras.plane_sweep_warp(jnp.asarray(depth), jnp.asarray(color),
                                 jnp.asarray(k), jnp.asarray(k),
                                 jnp.asarray(m), (H, W), num_planes=40)
    got = tras.plane_sweep_warp(T(depth), T(color), T(k), T(k), T(m),
                                (H, W), num_planes=40)
    mask = np.asarray(want.mask)
    assert 0.8 < mask.mean() < 1.0
    np.testing.assert_array_equal(got.mask[0].numpy(), mask)
    np.testing.assert_array_equal(got.edge_mask[0].numpy(),
                                  np.asarray(want.edge_mask))
    np.testing.assert_allclose(got.color[0].numpy(), np.asarray(want.color),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.depth[0].numpy()[mask],
                               np.asarray(want.depth)[mask], rtol=5e-5)


def test_plane_sweep_warp_in_passes_equals_one_pass(monkeypatch):
    """A byte budget that fits one image a pass splits a batch of 3 with
    their own cameras and transforms into 3 passes; the result is the one
    pass's, bit for bit."""
    scenes = [scene(s) for s in range(3)]
    ks = stack([camera(fov=f) for f in (50.0, 60.0, 75.0)])
    args = (stack([d for d, _ in scenes]), stack([c for _, c in scenes]),
            ks, ks, stack([rigid(s) for s in range(3)]))
    want = tras.plane_sweep_warp(*args, (H, W), num_planes=24)
    monkeypatch.setattr(tras, "ZBUFFER_BYTES",
                        16 * H * W * tras.PLANE_SWEEP_BYTES)
    steps = []
    in_passes = tras._in_passes
    monkeypatch.setattr(tras, "_in_passes", lambda fn, step, *a: steps.append(
        step) or in_passes(fn, step, *a))
    got = tras.plane_sweep_warp(*args, (H, W), num_planes=24)
    assert steps == [1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("sub", [1, 2])
def test_pixel_ids_and_remap_match_jax(sub):
    depth, color = scene(4)
    k, m = camera(), rigid(4)
    want_ids, want_z = jras.warp_pixel_ids(jnp.asarray(depth), jnp.asarray(k),
                                           jnp.asarray(k), jnp.asarray(m),
                                           (H, W), subsample=sub)
    got_ids, got_z = tras.warp_pixel_ids(T(depth), T(k), T(k), T(m), (H, W),
                                         subsample=sub)
    np.testing.assert_array_equal(got_ids[0].numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_z[0].numpy(), np.asarray(want_z))
    assert (got_ids >= 0).float().mean() > 0.5
    # a second pass, back to the first camera, then chased to colors
    back_j, _ = jras.warp_pixel_ids(jnp.asarray(depth), jnp.asarray(k),
                                    jnp.asarray(k), jnp.eye(4), (H, W))
    back_t, _ = tras.warp_pixel_ids(T(depth), T(k), T(k), torch.eye(4)[None],
                                    (H, W))
    rgb = (color * 255).astype(np.uint8)
    want = jras.remap_ids_to_img(jnp.asarray(rgb), [want_ids, back_j],
                                 invalid_color=(0, 255, 0))
    got = tras.remap_ids_to_img(torch.from_numpy(rgb),
                                [got_ids[0], back_t[0]],
                                invalid_color=(0, 255, 0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _geometry_case(name, rng):
    k = camera()
    m = rigid(7)
    pts = (rng.normal(size=(5, 3)) + [0, 0, 4]).astype(np.float32)
    hw3 = rng.normal(size=(6, 8, 3)).astype(np.float32)
    if name == "fov_from_camera_matrix":
        kk = np.array(jgeo.camera_matrix_from_fov(W, H, xfov_deg=63.0,
                                                  yfov_deg=41.0))
        return (np.stack(jgeo.fov_from_camera_matrix(jnp.asarray(kk))),
                torch.stack(tgeo.fov_from_camera_matrix(torch.from_numpy(kk))))
    if name == "project_points":
        pts[2, 2] = 0.0                        # the epsilon guard
        uv, z = jgeo.project_points(jnp.asarray(pts), jnp.asarray(k))
        tuv, tz = tgeo.project_points(torch.from_numpy(pts),
                                      torch.from_numpy(k))
        return (np.concatenate([np.asarray(uv), np.asarray(z)[:, None]], 1),
                torch.cat([tuv, tz[:, None]], 1))
    if name == "transform_points":
        return (jgeo.transform_points(jnp.asarray(pts)[None],
                                      jnp.asarray(m))[0],
                tgeo.transform_points(torch.from_numpy(pts)[None],
                                      torch.from_numpy(m))[0])
    if name == "transform_depth_map":
        return (jgeo.transform_depth_map(jnp.asarray(hw3), jnp.asarray(m)),
                tgeo.transform_depth_map(torch.from_numpy(hw3),
                                         torch.from_numpy(m)))
    if name == "look_at":
        eye, target = [0.3, -0.2, 0.1], [0.0, 0.1, 5.0]
        return (jgeo.look_at(jnp.asarray(eye), jnp.asarray(target),
                             jnp.asarray([0.0, -1.0, 0.0])),
                tgeo.look_at(eye, target, [0.0, -1.0, 0.0]))
    return (jgeo.frustum_corners(jnp.asarray(k), W, H, near=0.2, far=9.0,
                                 cam_to_world=jnp.asarray(m)),
            tgeo.frustum_corners(torch.from_numpy(k), W, H, near=0.2,
                                 far=9.0, cam_to_world=torch.from_numpy(m)))


@pytest.mark.parametrize("name", ["fov_from_camera_matrix", "project_points",
                                  "transform_points", "transform_depth_map",
                                  "look_at", "frustum_corners"])
def test_geometry_helpers_match_jax(name):
    """Bit for bit, except ``look_at`` and ``frustum_corners`` (float32
    norms, cross products and the small einsum rounded in another order:
    within 2 ulp, 2.4e-7 relative; measured 1.1e-7)."""
    want, got = _geometry_case(name, np.random.default_rng(5))
    if name in ("look_at", "frustum_corners"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7,
                                   rtol=2.4e-7)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def cloud(seed, n=4000):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * [1.0, 0.5, 2.0] + [0, 0, 6]).astype(
        np.float32)
    return pts, rng.random((n, 3)).astype(np.float32)


@pytest.mark.parametrize("fn,size,behind", [
    ("voxel_downsample", 0.1, False),
    ("perspective_aware_downsample", 0.003, False),
    # points behind the camera warp to x/z ~ 1e6: voxel coordinates too
    # wide to pack into one int64, so the port sorts rows as JAX does
    ("perspective_aware_downsample", 0.01, True)])
def test_voxel_reductions_match_jax(fn, size, behind):
    pts, cols = cloud(1)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    if behind:
        pts[::97, 2] *= -1
    want = getattr(jvox, fn)(pts, cols, size)
    got = getattr(tvox, fn)(pts, cols, size)
    assert 10 < len(got[0]) < len(pts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("parts", ["points", "colors", "normals"])
def test_ply_files_match_the_jax_package(tmp_path, binary, parts):
    """Byte-identical PLY files; each package reads the other's."""
    pts, cols = cloud(2, 50)
    kw = {"colors": cols if parts != "points" else None,
          "normals": pts / np.linalg.norm(pts, axis=1, keepdims=True)
          if parts == "normals" else None, "binary": binary}
    a, b = str(tmp_path / "jax.ply"), str(tmp_path / "torch.ply")
    jpc.write_ply(a, pts, **kw)
    tpc.write_ply(b, pts, **kw)
    assert open(a, "rb").read() == open(b, "rb").read()
    for got, want in ((tpc.read_ply(a, return_normals=True),
                       jpc.read_ply(b, return_normals=True)),
                      (tpc.read_ply(b), jpc.read_ply(a))):
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


def test_obj_files_and_grid_faces_match_the_jax_package(tmp_path):
    keep = np.random.default_rng(6).random((5, 7)) > 0.2
    faces = tpc.grid_mesh_faces(5, 7, keep)
    np.testing.assert_array_equal(faces, jpc.grid_mesh_faces(5, 7, keep))
    np.testing.assert_array_equal(tpc.grid_mesh_faces(5, 7),
                                  jpc.grid_mesh_faces(5, 7))
    verts, cols = cloud(3, 35)
    for vc in (cols, None):
        a, b = str(tmp_path / "jax.obj"), str(tmp_path / "torch.obj")
        jpc.write_obj(a, verts, faces, vc)
        tpc.write_obj(b, verts, faces, vc)
        assert open(a, "rb").read() == open(b, "rb").read()
