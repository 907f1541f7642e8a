"""The DA3 part of the port against the JAX package, in float32 on the
CPU, with the same weights (drawn like ``model.init``'s from its shapes,
perturbed, carried across by ``models.from_jax``) and the same inputs
made from a numpy seed.

Tolerances:
- ViT features, DA3 depth and ray map: within 1e-4 of the largest value
  (measured ~3e-6). The port's ViT runs with ``attention_impl=
  "flash_packed"`` (token axis padded to 64, validity vector, packed
  attention through its plain version) against the Flax ViT's unpadded
  XLA attention, so this also shows that pads change nothing.
- ``w2c`` 2e-4 absolute and ``xfov_deg`` 2e-3 degrees on the model's ray
  maps (measured up to 6e-6 and 5e-5): the focal is a ratio of sums
  over the ray map and the rotation comes out of an SVD (LAPACK in both
  packages, but through different routines), which amplify the float32
  rounding of the rays; on a consistent synthetic ray map the two agree to
  1e-5.
- the solvers alone: 1e-5 absolute on well-conditioned random points.
- the engine (windows of 4 + 2 reference + 3 overlap frames; depth-scale
  stitch, Umeyama pose stitch, weld) on a 7-frame clip: depth within 1e-4
  of its largest value, ``c2w`` 1e-4 absolute on rotations and 1e-4 of the
  largest translation, ``xfov`` 2e-3 degrees (measured 4e-6, 1.5e-5, 4e-6,
  8e-5; each window multiplies the poses of the last, so the per-window
  error compounds).
- sidecar files: byte-equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.io import sidecar as jsidecar
from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu.models import da3 as jda3
from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.models import vit as jvit
from metric_depth_video_toolbox_tpu.ops import solvers as jsolvers
from metric_depth_video_toolbox_tpu_torch.io import sidecar as tsidecar
from metric_depth_video_toolbox_tpu_torch.models import da3 as tda3
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as tda
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import vit as tvit
from metric_depth_video_toolbox_tpu_torch.ops import attention_packed as apk
from metric_depth_video_toolbox_tpu_torch.ops import solvers as tsolvers
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import init_like

REL = 1e-4
HW = (28, 42)            # also the engine tests' working resolution
GRID = (2, 3)
N_TOK = GRID[0] * GRID[1] + 1


def f32(cfg, **vit_kw):
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32", **vit_kw),
        dpt=dataclasses.replace(cfg.dpt, dtype="float32"))


J_CFG = f32(jda3.DA3_TINY)
T_CFG = {impl: f32(tda3.DA3_TINY, attention_impl=impl)
         for impl in ("xla", "flash_packed")}


@functools.lru_cache(maxsize=None)
def _flax_params():
    """One tree for the Flax DA3 (with the ray embedding) at HW, drawn like
    its ``init`` from the shapes and perturbed so that biases and norms are
    not at their trivial values; every test takes its weights from this
    tree (their shapes do not depend on the number of views)."""
    return init_like(jda3.DA3(J_CFG), 5, jnp.zeros((2,) + HW + (3,)),
                     jnp.zeros((2,) + GRID + (3,)))


def flax_params(ray_embed):
    tree = dict(_flax_params()["params"])
    if not ray_embed:
        del tree["ray_embed"]
    return {"params": tree}


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


def T(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------- the ViT ----

@pytest.mark.parametrize("views,impl", [(3, "flash_packed"), (3, "xla"),
                                        (1, "flash_packed")])
def test_vit_cross_view_matches_flax(views, impl):
    """2 groups of ``views`` views: per-view blocks and cross-view blocks
    (1 and 3 of VIT_TINY's 4), with a conditioning tensor."""
    rng = np.random.default_rng(views)
    b = 2 * views
    x = rng.random((b,) + HW + (3,), np.float32)
    cond = 0.1 * rng.standard_normal((b,) + GRID + (64,)).astype(np.float32)
    assert tuple(J_CFG.vit.cross_view_indices) == (1, 3)
    jm = jvit.ViT(J_CFG.vit)
    params = {"params": flax_params(False)["params"]["backbone"]}
    want_feats, want_cls = jax.jit(
        lambda p, a, c: jm.apply(p, a, cond=c, view_group=views))(
            params, jnp.asarray(x), jnp.asarray(cond))
    tm = tvit.ViT(T_CFG[impl].vit, GRID[0] * GRID[1])
    from_jax.load_flax_params(tm, params)
    with torch.no_grad():
        feats, cls = tm(T(x), cond=T(cond), view_group=views)
    for g, w in zip(feats, want_feats):
        assert_close(g.numpy(), w)
    assert_close(cls.numpy(), want_cls)


def test_vit_view_group_changes_the_cross_view_blocks():
    """The views really mix: with ``view_group`` the features differ from
    the per-view forward, and a cfg without cross-view blocks ignores
    ``view_group``."""
    x = T(np.random.default_rng(0).random((3,) + HW + (3,), np.float32))
    gen = torch.Generator().manual_seed(0)
    tm = tvit.seeded_init(tvit.ViT(T_CFG["flash_packed"].vit, N_TOK - 1),
                          gen)
    with torch.no_grad():
        alone, _ = tm(x)
        mixed, _ = tm(x, view_group=3)
        plain = tvit.ViT(dataclasses.replace(T_CFG["xla"].vit,
                                             cross_view_indices=()),
                         N_TOK - 1)
        plain.load_state_dict(tm.state_dict())
        same, _ = plain(x, view_group=3)
    assert float((alone[-1] - mixed[-1]).abs().max()) > 1e-3
    for a, s in zip(alone, same):
        assert_close(s.numpy(), a.numpy())


def test_vit_pads_to_the_kernels_multiple(monkeypatch):
    """With ``flash_packed`` every attention goes through the packed
    wrapper with the token axis padded to PAD_MULTIPLE and the validity
    vector tiled per view in the cross-view blocks; with the default it is
    never called."""
    calls = []
    real = apk.packed_flash_attention

    def spy(qkv4, valid, heads, sm):
        calls.append((tuple(qkv4.shape), valid.clone()))
        return real(qkv4, valid, heads, sm)
    monkeypatch.setattr(apk, "packed_flash_attention", spy)
    x = T(np.random.default_rng(0).random((3,) + HW + (3,), np.float32))
    for impl, n_calls in (("flash_packed", 4), ("xla", 0), ("flash", 0)):
        calls.clear()
        cfg = dataclasses.replace(T_CFG["xla"].vit, attention_impl=impl)
        tm = tvit.seeded_init(tvit.ViT(cfg, N_TOK - 1),
                              torch.Generator().manual_seed(0))
        with torch.no_grad():
            tm(x, view_group=3)
        assert len(calls) == n_calls
    with torch.no_grad():
        tm = tvit.seeded_init(tvit.ViT(T_CFG["flash_packed"].vit,
                                       N_TOK - 1),
                              torch.Generator().manual_seed(0))
        tm(x, view_group=3)
    m = apk.PAD_MULTIPLE
    one = torch.arange(m) < N_TOK
    assert [c[0] for c in calls] == [(3, m, 12, 16), (1, 3 * m, 12, 16)] * 2
    assert torch.equal(calls[0][1], one)
    assert torch.equal(calls[1][1], one.repeat(3))
    with pytest.raises(ValueError, match="attention_impl"):
        dataclasses.replace(T_CFG["xla"].vit, attention_impl="cudnn")


def test_interpolate_pos_embed_matches():
    pos = np.random.default_rng(2).standard_normal((1, N_TOK, 8)).astype(
        np.float32)
    for dst in ((5, 7), (3, 2), GRID):
        want = jconvert.interpolate_pos_embed(pos, GRID, dst)
        got = tvit.interpolate_pos_embed(pos, GRID, dst)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)


# ------------------------------------------------------------- solvers ----

def points(seed, batch=()):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(batch + (20, 3)).astype(np.float32)
    ang = 0.7
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    dst = 1.7 * src @ rot.T + np.array([0.3, -2.0, 1.0], np.float32)
    dst += 0.05 * rng.standard_normal(dst.shape).astype(np.float32)
    w = rng.random(batch + (20,)).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("weighted", [False, True])
def test_least_squares_scale_matches(weighted):
    rng = np.random.default_rng(0)
    r = rng.random((3, 8, 9)).astype(np.float32)
    p = rng.random((3, 8, 9)).astype(np.float32)
    w = rng.random((3, 8, 9)).astype(np.float32) if weighted else None
    want = jsolvers.least_squares_scale(jnp.asarray(r), jnp.asarray(p),
                                        None if w is None else jnp.asarray(w))
    got = tsolvers.least_squares_scale(T(r), T(p),
                                       None if w is None else T(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(tsolvers.least_squares_scale(T(r), T(0 * p))) == 1.0


@pytest.mark.parametrize("batch,weighted,zero_centroid", [
    ((), False, False), ((), True, False), ((4,), False, True),
    ((2,), True, True)])
def test_rigid_transform_matches(batch, weighted, zero_centroid):
    src, dst, w = points(1, batch)
    w = w if weighted else None
    want = jsolvers.rigid_transform(
        jnp.asarray(src), jnp.asarray(dst),
        None if w is None else jnp.asarray(w), zero_centroid=zero_centroid)
    got = tsolvers.rigid_transform(T(src), T(dst),
                                   None if w is None else T(w),
                                   zero_centroid=zero_centroid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    rot = got[..., :3, :3]
    np.testing.assert_allclose((rot @ rot.transpose(-1, -2)).numpy(),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    assert torch.linalg.det(rot).min() > 0.99


def test_rigid_transform_reflection_stays_a_rotation():
    """Mirrored targets: the best orthogonal map is a reflection, and the
    solver must return the best proper rotation, as the JAX one does."""
    src, dst, _ = points(2)
    dst = dst * np.array([1, 1, -1], np.float32)
    want = jsolvers.rigid_transform(jnp.asarray(src), jnp.asarray(dst))
    got = tsolvers.rigid_transform(T(src), T(dst))
    assert torch.linalg.det(got[:3, :3]) > 0.99
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("batch,weighted", [((), False), ((3,), True)])
def test_umeyama_sim3_matches(batch, weighted):
    src, dst, w = points(3, batch)
    w = w if weighted else None
    want = jsolvers.umeyama_sim3(jnp.asarray(src), jnp.asarray(dst),
                                 None if w is None else jnp.asarray(w))
    got = tsolvers.umeyama_sim3(T(src), T(dst), None if w is None else T(w))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), 1.7, atol=0.05)


# ----------------------------------------------------- cameras, the model ----

def synthetic_rays(f_true=48.0, img_w=64.0, h=16, w=16):
    ang = np.radians([10.0, -20.0, 5.0])
    cx, cy, cz = np.cos(ang)
    sx, sy, sz = np.sin(ang)
    r_true = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
              @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
              @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
              ).astype(np.float32)
    c_true = np.array([0.5, -1.0, 2.0], np.float32)
    s = img_w / w
    uu = (np.arange(w) - (w - 1) / 2) * s
    vv = (np.arange(h) - (h - 1) / 2) * s
    g = np.stack(np.broadcast_arrays(uu[None, :] / f_true,
                                     vv[:, None] / f_true, np.float32(1.0)),
                 axis=-1)
    g = g / np.linalg.norm(g, axis=-1, keepdims=True)
    rays = np.concatenate([np.broadcast_to(c_true, (h, w, 3)),
                           np.einsum("ij,hwj->hwi", r_true, g)], axis=-1)
    return rays[None].astype(np.float32), r_true, c_true


def test_cameras_from_raymap_recovers_a_known_camera():
    rays, r_true, c_true = synthetic_rays()
    w2c, xfov = tda3.cameras_from_raymap(T(rays), 64.0)
    want_w2c, want_fov = jda3.cameras_from_raymap(jnp.asarray(rays), 64.0)
    np.testing.assert_allclose(w2c.numpy(), np.asarray(want_w2c), atol=1e-5)
    np.testing.assert_allclose(xfov.numpy(), np.asarray(want_fov), atol=1e-4)
    np.testing.assert_allclose(w2c[0, :3, :3].numpy(), r_true.T, atol=1e-4)
    np.testing.assert_allclose(w2c[0, :3, 3].numpy(), -r_true.T @ c_true,
                               atol=1e-3)
    np.testing.assert_allclose(
        float(xfov[0]), 2 * np.degrees(np.arctan2(32.0, 48.0)), atol=0.2)


def test_cameras_from_raymap_matches_on_noisy_rays():
    rays, _, _ = synthetic_rays()
    rng = np.random.default_rng(4)
    rays = np.repeat(rays, 3, 0) + 0.05 * rng.standard_normal(
        (3, 16, 16, 6)).astype(np.float32)
    w2c, xfov = tda3.cameras_from_raymap(T(rays), 64.0)
    want_w2c, want_fov = jda3.cameras_from_raymap(jnp.asarray(rays), 64.0)
    np.testing.assert_allclose(w2c.numpy(), np.asarray(want_w2c), atol=1e-5)
    np.testing.assert_allclose(xfov.numpy(), np.asarray(want_fov), atol=1e-3)


def test_patch_center_rays_match():
    for args in ((60.0, 3, 4), (47.5, 36, 64), (60.0, 4, 4, 35.0)):
        np.testing.assert_allclose(tda.patch_center_rays(*args),
                                   np.asarray(jda.patch_center_rays(*args)),
                                   atol=1e-7)


@pytest.mark.parametrize("views,rays,impl", [
    (1, False, "flash_packed"), (3, True, "flash_packed"),
    (3, False, "xla")])
def test_da3_forward_matches_flax(views, rays, impl):
    rng = np.random.default_rng(10 + views)
    x = rng.random((views,) + HW + (3,), np.float32)
    cam = np.stack([tda.patch_center_rays(50.0 + 3 * i, *GRID)
                    for i in range(views)]) if rays else None
    jm = jda3.DA3(J_CFG)
    jcam = None if cam is None else jnp.asarray(cam)
    params = flax_params(rays)
    want = jax.jit(lambda p, a: jm.apply(p, a, jcam))(params, jnp.asarray(x))
    tm = tda3.DA3(T_CFG[impl], HW, ray_cond=rays)
    from_jax.load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(T(x), None if cam is None else T(cam))
    assert set(got) == set(want)
    assert got["depth"].shape == (views,) + HW
    assert_close(got["depth"].numpy(), want["depth"])
    assert_close(got["rays"].numpy(), want["rays"])
    np.testing.assert_allclose(got["w2c"].numpy(), np.asarray(want["w2c"]),
                               atol=2e-4)
    np.testing.assert_allclose(got["xfov_deg"].numpy(),
                               np.asarray(want["xfov_deg"]), atol=2e-3)
    rot = got["w2c"][:, :3, :3]
    np.testing.assert_allclose((rot @ rot.transpose(1, 2)).numpy(),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-4)


def test_da3_without_ray_head():
    cfg = dataclasses.replace(T_CFG["xla"], ray_head=False)
    tm = tvit.seeded_init(tda3.DA3(cfg, HW),
                          torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = tm(torch.rand(2, *HW, 3,
                            generator=torch.Generator().manual_seed(1)))
    assert "rays" not in out
    assert torch.equal(out["w2c"], torch.eye(4).repeat(2, 1, 1))
    assert torch.equal(out["xfov_deg"], torch.full((2,), 50.0))


def test_da3_presets_match():
    for name in ("vitt", "vits", "vitb", "vitl", "vitg", "other"):
        j, t = jda3.preset(name), tda3.preset(name)
        for field in ("embed_dim", "depth", "num_heads", "patch_size",
                      "dtype", "attention_impl"):
            assert getattr(j.vit, field) == getattr(t.vit, field), field
        assert tuple(j.vit.cross_view_indices) == \
            tuple(t.vit.cross_view_indices)
        assert tuple(j.vit.out_indices) == tuple(t.vit.out_indices)
        assert dataclasses.asdict(j.dpt).items() >= {
            k: v for k, v in dataclasses.asdict(t.dpt).items()
            if k in dataclasses.asdict(j.dpt)}.items()
        assert (j.ray_head, j.max_depth) == (t.ray_head, t.max_depth)
    assert tda3.preset("vitl") is tda3.DA3_L
    assert tda3.DA3Engine(device="cpu").cfg is tda3.DA3_L


# ------------------------------------------------------------ the engine ----

T_FRAMES, FH, FW = 7, 40, 56
WINDOW = dict(images_per_batch=4, overlap=3, num_ref_frames=2, resolution=28)


def clip(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (FH // 4 + 2, FW // 4 + 2 * T_FRAMES, 3),
                        np.uint8)
    tex = np.kron(base, np.ones((4, 4, 1), np.uint8))
    return np.stack([tex[:FH, 2 * i:2 * i + FW] for i in range(T_FRAMES)])


def engines(impl="flash_packed", **kw):
    """-> (frames, the JAX engine's results, the port engine) with the
    same (perturbed) weights in both."""
    frames = clip()
    jeng = jda3.DA3Engine(cfg=J_CFG, **WINDOW, **kw)
    assert jeng._work_hw(FH, FW) == HW
    jeng._params = flax_params(bool(kw))
    want = jeng.infer_video(frames)
    teng = tda3.DA3Engine(cfg=T_CFG[impl], device="cpu",
                          params=from_jax.flax_to_state_dict(jeng._params),
                          **WINDOW, **kw)
    return frames, want, teng


def assert_engine_close(got, want):
    (d, c2w, fov), (wd, wc2w, wfov) = got, want
    assert d.shape == (T_FRAMES, FH, FW) and c2w.shape == (T_FRAMES, 4, 4)
    assert d.dtype == c2w.dtype == fov.dtype == np.float32
    assert_close(d, wd)
    np.testing.assert_allclose(c2w[:, :3, :3], wc2w[:, :3, :3], atol=1e-4)
    assert_close(c2w[:, :3, 3], wc2w[:, :3, 3])
    np.testing.assert_array_equal(c2w[:, 3], wc2w[:, 3])
    np.testing.assert_allclose(fov, wfov, atol=2e-3)


def test_da3_engine_windowed_matches_jax(monkeypatch):
    """7 frames in windows of 4 + 2 reference frames + 3 tail frames: four
    windows, so the depth-scale stitch, the Umeyama stitch (3 shared
    centers) and the weld all run."""
    frames, want, teng = engines("flash_packed")
    calls = []
    real = tsolvers.umeyama_sim3
    monkeypatch.setattr(tsolvers, "umeyama_sim3",
                        lambda *a: calls.append(1) or real(*a))
    got = teng.infer_video(frames)
    assert len(calls) == 3
    assert_engine_close(got, want)
    assert np.isfinite(got[0]).all() and got[0].max() > 0
    assert len(teng._models) == 1        # one model for every window


def test_da3_engine_known_fov_matches_jax():
    """Known intrinsics: the ray embedding conditions the backbone, and the
    given FOVs pass through verbatim."""
    fovs = [48.0, 52.0, 55.0, 60.0, 58.0, 51.0, 49.0]
    frames, want, teng = engines("xla", xfovs=fovs)
    got = teng.infer_video(frames)
    assert_engine_close(got, want)
    np.testing.assert_array_equal(got[2], np.asarray(fovs, np.float32))
    free = tda3.DA3Engine(cfg=T_CFG["xla"], device="cpu", **WINDOW)
    assert not np.allclose(free.infer_video(frames)[2], fovs)
    scalar = tda3.DA3Engine(cfg=T_CFG["xla"], device="cpu", yfov=40.0,
                            **WINDOW)
    want_x = np.degrees(2 * np.arctan(np.tan(np.radians(20.0)) * FW / FH))
    np.testing.assert_allclose(scalar.infer_video(frames)[2], want_x,
                               rtol=1e-6)


def test_da3_engine_short_clip_is_one_unwindowed_forward():
    frames = clip()[:3]
    eng = tda3.DA3Engine(cfg=T_CFG["xla"], device="cpu", **WINDOW)
    d, c2w, fov = eng.infer_video(frames)
    model = eng.model(eng._work_hw(FH, FW))
    with torch.no_grad():
        d1, w2c, fov1 = eng._run_window(model, torch.from_numpy(frames),
                                        None, (FH, FW),
                                        eng._work_hw(FH, FW))
    np.testing.assert_array_equal(d, d1.numpy())
    np.testing.assert_allclose(c2w, np.linalg.inv(w2c), atol=1e-6)
    np.testing.assert_array_equal(fov, fov1)


def test_da3_backbone_graft(tmp_path):
    """A ViT tree (bare, under ``backbone``, or under ``params``, or in a
    converted checkpoint file given by its path) replaces the backbone's
    weights, its position embedding resampled to the engine's grid; a tree
    of another width and a missing file are refused."""
    frames = clip()[:4]
    src = tda3.DA3Engine(cfg=T_CFG["xla"], device="cpu", rng_seed=3,
                         **WINDOW)
    tree_sd = src.model((28, 42)).backbone.state_dict()
    jm = jvit.ViT(J_CFG.vit)
    tree = init_like(jm, 9, jnp.zeros((1, 56, 56, 3)))["params"]
    assert tree["pos_embed"].shape == (1, 17, 64)
    outs = []
    path = str(tmp_path / "backbone.msgpack")
    jconvert.save_checkpoint(path, {"params": {"backbone": tree}})
    for source in (tree, {"backbone": tree}, {"params": {"backbone": tree}},
                   path):
        eng = tda3.DA3Engine(cfg=T_CFG["xla"], device="cpu", rng_seed=3,
                             backbone=source, **WINDOW)
        got = eng.model((28, 42)).backbone.state_dict()
        want = from_jax.flax_to_state_dict(tree)
        for key in want:
            if key != "pos_embed":
                assert torch.equal(got[key], want[key]), key
        np.testing.assert_allclose(
            got["pos_embed"].numpy(),
            np.asarray(jconvert.interpolate_pos_embed(
                tree["pos_embed"], (4, 4), (2, 3))), atol=1e-6)
        assert not torch.equal(got["block0.attn.qkv.weight"],
                               tree_sd["block0.attn.qkv.weight"])
        outs.append(eng.infer_video(frames)[0])
        assert np.isfinite(outs[-1]).all()
    for out in outs[1:]:
        np.testing.assert_array_equal(outs[0], out)
    bad = dict(tree, cls_token=np.zeros((1, 1, 999), np.float32))
    eng = tda3.DA3Engine(cfg=T_CFG["xla"], device="cpu", backbone=bad,
                         **WINDOW)
    with pytest.raises(ValueError, match="backbone shape mismatch"):
        eng.infer_video(frames)
    with pytest.raises(FileNotFoundError, match="dinov2.msgpack"):
        tda3.DA3Engine(cfg=T_CFG["xla"], device="cpu",
                       backbone=str(tmp_path / "dinov2.msgpack"))


def test_da3_graft_resamples_to_the_working_grid():
    """On a working grid that is not square (1080p at 504: 36 x 64) the
    JAX engine's graft resamples the position embedding to a square grid
    of as many patches (48 x 48), which scrambles the patch positions; the
    port resamples to 36 x 64, as DINOv2's own interpolation does. On the
    grids where the two agree (2 x 3 above) they are held equal."""
    work = (36 * 14, 64 * 14)
    tree = init_like(jvit.ViT(J_CFG.vit), 9, jnp.zeros((1, 56, 56, 3)))[
        "params"]
    eng = tda3.DA3Engine(cfg=T_CFG["xla"], device="cpu", backbone=tree,
                         **WINDOW)
    got = eng.model(work).backbone.pos_embed.detach().numpy()
    np.testing.assert_allclose(got, jconvert.interpolate_pos_embed(
        tree["pos_embed"], (4, 4), (36, 64)), atol=1e-6)
    jeng = jda3.DA3Engine(cfg=J_CFG)
    jeng._params = init_like(jda3.DA3(J_CFG), 1,
                             jnp.zeros((1,) + work + (3,)))
    jeng._graft_backbone(tree)
    np.testing.assert_allclose(
        np.asarray(jeng._params["params"]["backbone"]["pos_embed"]),
        jconvert.interpolate_pos_embed(tree["pos_embed"], (4, 4), (48, 48)),
        atol=1e-6)
    assert not np.allclose(got, np.asarray(
        jeng._params["params"]["backbone"]["pos_embed"]), atol=1e-3)


# ---------------------------------------------------- sidecars, the CLI ----

def test_sidecars_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    fovs = (40 + 30 * rng.random(9)).astype(np.float32)
    c2w = rng.standard_normal((9, 4, 4)).astype(np.float32)
    for name, jsave, tsave, tload, data in (
            ("xfovs", jsidecar.save_xfovs, tsidecar.save_xfovs,
             tsidecar.load_xfovs, fovs),
            ("transformations", jsidecar.save_transformations,
             tsidecar.save_transformations, tsidecar.load_transformations,
             c2w)):
        jp, tp = tmp_path / f"j_{name}.json", tmp_path / f"t_{name}.json"
        jsave(str(jp), data)
        tsave(str(tp), data)
        assert jp.read_bytes() == tp.read_bytes()
        np.testing.assert_array_equal(tload(str(tp)), data)


def test_da3_cli_flags_and_defaults_match(monkeypatch):
    """The port's ``da3`` parser has the JAX tool's flags and defaults."""
    import argparse

    from metric_depth_video_toolbox_tpu.cli import depth_engines as jcli
    from metric_depth_video_toolbox_tpu_torch.cli import depth_engines as tcli

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, argv=None):
        seen["parser"] = self
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        jcli.da3_main(["--color_video", "x.mp4"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)

    def spec(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.type,
                         a.choices and tuple(a.choices), a.required)
                for a in parser._actions if a.dest != "help"}
    assert spec(tcli.build_da3_parser()) == spec(seen["parser"])


def test_da3_cli_unported_options_raise(monkeypatch):
    """``--quantize int8``, which raised naming ROADMAP A13, reaches the
    engine: DA3_L's ViT with int8 matmuls (its numbers are held in
    test_torch_quant.py)."""
    from metric_depth_video_toolbox_tpu_torch.cli import depth_engines as tcli
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth

    built = []
    monkeypatch.setitem(tdepth._ENGINE_CLASSES, "da3",
                        lambda **kw: built.append(
                            tdepth.DA3PipelineEngine(**kw)))
    monkeypatch.setattr(tdepth, "ENGINES", {"da3": lambda *a, **kw: "o"})
    args = tcli.build_da3_parser().parse_args(
        ["--color_video", "x.mp4", "--quantize", "int8"])
    tcli.run_da3(args, device="cpu")
    cfg = built[0].engine.cfg
    assert cfg.vit.quant == "int8" and cfg.vit.embed_dim == 1024


@pytest.mark.parametrize("flag", ["--checkpoint", "--backbone_checkpoint"])
def test_da3_cli_checkpoint_flags_run(tmp_path, monkeypatch, flag):
    """The two checkpoint flags, which raised until checkpoints were read:
    ``--checkpoint`` is accepted and ignored (as by the JAX package's
    ``da3_main``), ``--backbone_checkpoint`` reaches the engine, which
    grafts the file's backbone."""
    from metric_depth_video_toolbox_tpu_torch.cli import depth_engines as tcli
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth

    path = str(tmp_path / "backbone.msgpack")
    tree = init_like(jvit.ViT(J_CFG.vit), 9, jnp.zeros((1, 56, 56, 3)))
    jconvert.save_checkpoint(path, tree)
    seen = []
    monkeypatch.setitem(tdepth.ENGINES, "da3", lambda v, engine, **kw: (
        seen.append(engine) or v + "_depth.mkv"))
    args = tcli.build_da3_parser().parse_args(
        ["--color_video", str(tmp_path / "x.mp4"), "--model_size", "vitt",
         "--da3_resolution", "28", flag, path])
    assert tcli.run_da3(args, device="cpu") == [args.color_video
                                                + "_depth.mkv"]
    eng = seen[0].engine
    if flag == "--checkpoint":
        assert eng._backbone is None
    else:
        got = eng.model((28, 42)).backbone.state_dict()["block0.mlp.fc1.bias"]
        np.testing.assert_array_equal(
            got.numpy(), tree["params"]["block0"]["mlp"]["fc1"]["bias"])


def test_da3_file_to_file_matches_jax(tmp_path, monkeypatch):
    """``mdvt-torch da3`` on a clip file: depth video and both sidecars,
    against the JAX package's ``run_da3`` with the same weights. The depth
    video's codes within one step on 99% of pixels; the sidecars to the
    engine's tolerances."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
    from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth

    frames = clip()
    jpath, tpath = str(tmp_path / "j.mkv"), str(tmp_path / "t.mkv")
    tvio.save_rgb_video(frames, jpath, 24)
    tvio.save_rgb_video(frames, tpath, 24)
    jeng = jdepth.DA3PipelineEngine(cfg=J_CFG, **WINDOW)
    jeng.engine._params = flax_params(False)
    want = jdepth.run_da3(jpath, engine=jeng)
    teng = tdepth.DA3PipelineEngine(
        cfg=T_CFG["flash_packed"], device="cpu",
        params=from_jax.flax_to_state_dict(jeng.engine._params), **WINDOW)
    got = tdepth.run_da3(tpath, engine=teng)
    assert got == tpath + "_depth.mkv"
    with tvio.VideoReader(got) as r:
        g = r.read_all().astype(np.int32)
    with tvio.VideoReader(want) as r:
        w = r.read_all().astype(np.int32)
    assert g.shape == w.shape == (T_FRAMES, FH, FW, 3)
    assert (np.abs(g - w).max(-1) <= 1).mean() >= 0.99
    np.testing.assert_allclose(
        tsidecar.load_xfovs(got + "_xfovs.json"),
        jsidecar.load_xfovs(want + "_xfovs.json"), atol=2e-3)
    gt = tsidecar.load_transformations(got + "_transformations.json")
    wt = jsidecar.load_transformations(want + "_transformations.json")
    np.testing.assert_allclose(gt, wt, atol=1e-4)

    # the command line, seeded weights, tiny preset, into --output_dir
    out_dir = tmp_path / "out"
    cpath = str(tmp_path / "c.mkv")
    tvio.save_rgb_video(frames, cpath, 24)
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    tmain.main(["da3", "--color_video", cpath, "--model_size", "vitt",
                "--da3_resolution", "28", "--images_per_batch", "4",
                "--batch_overlap", "3", "--nr_of_ref_frames", "2",
                "--xfov", "55", "--output_dir", str(out_dir)])
    names = sorted(p.name for p in out_dir.iterdir())
    assert names == ["c.mkv_depth.mkv", "c.mkv_depth.mkv_transformations.json",
                     "c.mkv_depth.mkv_xfovs.json"]
    np.testing.assert_array_equal(
        tsidecar.load_xfovs(str(out_dir / names[2])),
        np.full(T_FRAMES, 55.0, np.float32))
