"""The single-frame depth engines of the port against the JAX package's:
the geometry they reach (``ops/geometry.py``), the three stand-in heads of
``models/depth_anything.py``, ``SingleFrameEngine.infer_video`` for every
variant with ``--xfov`` on and off where the variant allows, and
``run_single_frame`` file to file with its ``_xfovs.json``.

Both packages run in float32 (``port_helpers.float32_presets``; the
``vitt`` preset is bfloat16, where the packages round at other places) on
the same Flax trees (``port_helpers.init_like``). The point-head variants
(MoGe, UniK3D) see their model's output mapped onto upstream-style pinhole
point maps (``port_helpers.upstream_style_point_maps``): on a random map
the focal / shift solve has no clear minimum and a float32 rounding picks
between candidates of equal cost. Tolerances:
- ``normalized_uv`` and the FOV / focal conversions within 1e-6
  relative; ``estimate_focal_from_points`` within 1e-5 relative;
  ``recover_focal_shift`` on point maps of a known pinhole: focal and
  shift within 1e-5 relative, rms within 1e-4 (measured ~1e-6);
- the stand-in models: outputs within 1e-4 of their largest magnitude
  (measured ~2e-6);
- the engines: depth within 1e-4 of its largest value, FOVs within
  1e-3 degrees (measured: depth ~2e-6 relative, FOVs ~3e-5 degrees);
- file to file: 16-bit depth codes within one step on every pixel and
  equal on 99% of them; the sidecar's FOVs within 1e-3 degrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as tda
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.ops import geometry as tgeo
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import (float32_presets, init_like,
                          upstream_style_point_maps)

T, H, W = 5, 48, 64
INPUT_SIZE = 42          # working resolution 42 x 56: the shrinking path


def clip():
    """A panning textured scene (uint8 frames)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 200, (H // 4 + 2, W // 4 + 2 * T, 3), np.uint8)
    tex = np.kron(base, np.ones((4, 4, 1), np.uint8))
    return np.stack([tex[:H, 2 * i:2 * i + W] for i in range(T)])


def pinhole_points(seed, h=24, w=40, focal=1.3, shift=2.0):
    """(2, h, w, 3) point maps of a pinhole at a normalized focal, z
    offset by -shift, with 1 cm noise, and (2, h, w) weights."""
    rng = np.random.default_rng(seed)
    uv = np.asarray(jgeo.normalized_uv(h, w))
    d = 3.0 + rng.random((2, h, w))
    pts = np.stack([uv[..., 0] * d / focal, uv[..., 1] * d / focal,
                    d - shift], -1)
    pts += 0.01 * rng.standard_normal(pts.shape)
    return pts.astype(np.float32), rng.random((2, h, w)).astype(np.float32)


# --- geometry -------------------------------------------------------------

@pytest.mark.parametrize("hw", [(24, 40), (37, 66), (1, 3)])
def test_normalized_uv_matches(hw):
    want = np.asarray(jgeo.normalized_uv(*hw))
    got = tgeo.normalized_uv(*hw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_estimate_focal_from_points_matches(weighted):
    pts, wts = pinhole_points(1)
    h, w = pts.shape[1:3]
    want = jax.vmap(lambda p, q: jgeo.estimate_focal_from_points(
        p, h, w, weights=q if weighted else None))(pts, wts)
    got = tgeo.estimate_focal_from_points(
        torch.from_numpy(pts), h, w,
        torch.from_numpy(wts) if weighted else None)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


@pytest.mark.parametrize("focal", [None, 1.25])
@pytest.mark.parametrize("weighted", [False, True])
def test_recover_focal_shift_matches(focal, weighted):
    pts, wts = pinhole_points(2)
    want = jax.jit(jax.vmap(lambda p, q: jgeo.recover_focal_shift(
        p, q if weighted else None, focal=focal)))(pts, wts)
    got = tgeo.recover_focal_shift(
        torch.from_numpy(pts), torch.from_numpy(wts) if weighted else None,
        focal=focal)
    for a, b, tol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol)
    if focal is None:     # the pinhole's focal and shift, recovered
        np.testing.assert_allclose(got[0].numpy(), 1.3, rtol=2e-2)
        np.testing.assert_allclose(got[1].numpy(), 2.0, rtol=2e-2)


def test_fov_focal_conversions_match():
    xfov = np.array([30.0, 60.0, 90.0, 120.0], np.float32)
    f = tgeo.normalized_focal_from_xfov(torch.from_numpy(xfov), 42, 56)
    np.testing.assert_allclose(
        f.numpy(), np.asarray(jgeo.normalized_focal_from_xfov(xfov, 42, 56)),
        rtol=1e-6)
    back = tgeo.xfov_from_normalized_focal(f, 42, 56).numpy()
    np.testing.assert_allclose(back, np.asarray(
        jgeo.xfov_from_normalized_focal(f.numpy(), 42, 56)), rtol=1e-6)
    np.testing.assert_allclose(back, xfov, rtol=1e-5)


# --- the stand-in heads ---------------------------------------------------

def _f32(cfg):
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        dpt=dataclasses.replace(cfg.dpt, dtype="float32"))


HEADS = {"k_condition": dict(k_condition=True),
         "fov_head": dict(fov_head=True),
         "point_head": dict(point_head=True)}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_stand_in_head_matches_flax(head):
    """DepthAnything with each optional head, on the same tree: ray
    conditioning through the ViT's ``cond``, the FOV head (25 + 90
    sigmoid), the raw point map and mask logit."""
    extra = dict(HEADS[head])
    base = _f32(jda.preset("vitt"))
    dpt = dict(n_out=4, head_act="none") if head == "point_head" else {}
    jcfg = dataclasses.replace(base, dpt=dataclasses.replace(base.dpt, **dpt),
                               **extra)
    tbase = _f32(tda.preset("vitt"))
    tcfg = dataclasses.replace(tbase,
                               dpt=dataclasses.replace(tbase.dpt, **dpt),
                               **extra)
    rng = np.random.default_rng(3)
    x = rng.random((2, 28, 42, 3)).astype(np.float32)
    rays = jda.patch_center_rays(70.0, 2, 3)[None].repeat(2, 0)
    args = (x, rays) if head != "point_head" else (x,)
    tree = init_like(jda.DepthAnything(jcfg), 0, *args)
    want = jda.DepthAnything(jcfg).apply(tree, *args)
    mod = from_jax.load_params(tda.DepthAnything(tcfg, (28, 42)), tree)
    with torch.no_grad():
        got = mod(*(torch.from_numpy(np.asarray(a)) for a in args))
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-4 * np.abs(b).max(), rtol=0)


# --- the engines ----------------------------------------------------------

VARIANTS = [("da", None), ("unidepth", 60.0), ("unik3d", None),
            ("unik3d", 60.0), ("moge", None), ("moge", 60.0),
            ("depthpro", None), ("depthpro", 60.0)]


@pytest.fixture(scope="module")
def patched():
    """float32 presets and upstream-style point maps in both packages."""
    with pytest.MonkeyPatch.context() as mp:
        float32_presets(mp, jda, tda)
        upstream_style_point_maps(mp, jdepth, tdepth)
        yield


def engine_pair(variant, xfov, **kw):
    """(JAX engine, port engine) of one variant on one stand-in tree."""
    kw = dict(size="vitt", input_size=INPUT_SIZE, variant=variant,
              xfov=xfov, **kw)
    jeng = jdepth.SingleFrameEngine(data_parallel=False, **kw)
    work = jda.working_resolution(H, W, INPUT_SIZE, 14)
    grid = (1, work[0] // 14, work[1] // 14, 3)
    x = jnp.zeros((1,) + work + (3,))
    cond = jeng.cfg.k_condition or jeng.cfg.fov_head
    tree = init_like(jeng.model, 0, *((x, jnp.zeros(grid)) if cond else (x,)))
    jeng._params = tree
    return jeng, tdepth.SingleFrameEngine(params=tree, device="cpu", **kw)


@pytest.mark.parametrize("variant,xfov", VARIANTS)
def test_infer_video_matches_jax(patched, variant, xfov):
    jeng, teng = engine_pair(variant, xfov)
    frames = clip()
    want_d, want_f = jeng.infer_video(frames, batch=4, return_fov=True)
    got_d, got_f = teng.infer_video(frames, batch=4, return_fov=True)
    assert got_d.shape == want_d.shape == (T, H, W)
    assert got_d.dtype == np.float32 and np.isfinite(got_d).all()
    np.testing.assert_allclose(got_d, want_d,
                               atol=1e-4 * np.abs(want_d).max(), rtol=0)
    assert (got_f is None) == (want_f is None)
    if want_f is not None:
        np.testing.assert_allclose(got_f, want_f, atol=1e-3, rtol=0)
    if variant == "moge":
        assert 0 < (want_d == 100.0).mean() < 1     # sky -> max_depth


def test_unidepth_needs_xfov_and_unported_options_raise():
    """unidepth raises without a FOV; ``data_parallel=True``, which raised
    naming ROADMAP A16, builds no frame mesh on one device."""
    with pytest.raises(ValueError, match="xfov"):
        tdepth.SingleFrameEngine(variant="unidepth", device="cpu")
    assert tdepth.SingleFrameEngine(data_parallel=True,
                                    device="cpu")._mesh is None


def test_run_single_frame_file_to_file(patched, tmp_path):
    """unik3d (the movie's FOV pass) through both packages' runners:
    the depth video and the estimated per-frame FOVs."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    jeng, teng = engine_pair("unik3d", None)
    outs = {}
    for name, mod, eng in (("jax", jdepth, jeng), ("torch", tdepth, teng)):
        path = str(tmp_path / f"{name}.mkv")
        tvio.save_rgb_video(clip(), path, 24)
        outs[name] = mod.run_single_frame(path, engine=eng, save_xfovs=True)
    codes = {}
    for name, out in outs.items():
        with tvio.VideoReader(out) as r:
            rgb = r.read_all().astype(np.int64)
        codes[name] = rgb[..., 0] * 256 + rgb[..., 2]
    diff = np.abs(codes["torch"] - codes["jax"])
    assert codes["torch"].shape == (T, H, W)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    fovs = {name: sidecar.load_xfovs(out + "_xfovs.json").tolist()
            for name, out in outs.items()}
    assert len(fovs["torch"]) == T
    np.testing.assert_allclose(fovs["torch"], fovs["jax"], atol=1e-3)


def test_run_single_frame_sidecar_without_estimate(tmp_path):
    """A variant that estimates no FOV writes ``xfov`` (or 50) for every
    frame, as the JAX package does."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    path = str(tmp_path / "c.mkv")
    tvio.save_rgb_video(clip()[:2], path, 24)
    eng = tdepth.SingleFrameEngine(size="vitt", input_size=28,
                                   device="cpu")
    out = tdepth.run_single_frame(path, engine=eng, save_xfovs=True)
    assert sidecar.load_xfovs(out + "_xfovs.json").tolist() == [
        50.0, 50.0]
