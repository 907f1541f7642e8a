"""The port's diffusion depth engines (``pipeline/depth.py``:
``DepthCrafterEngine``, ``GeometryCrafterEngine``; GeometryCrafter's
point-map VAE in ``models/svd.py``) against the JAX package, on one shared
Flax tree (drawn with numpy from ``jax.eval_shape``) and the noise the JAX
engine draws (``PRNGKey(rng_seed)`` split once before every window), fed to
the port's engine.

Tolerances, float32 throughout: the point-map VAE's encode and decode within
1e-5 of the largest output (float32 sums in other orders); the engines'
metric depth within 1e-4 of the largest depth (the sampler's steps and the
metric fit compound the denoiser's rounding); depth videos written by the
CLIs within one 16-bit code (1.5 mm at 100 m), on at most 5% of the
pixels (a 1e-5 relative difference at 3 m flips about 2% of the codes).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.cli import depth_engines as jcli
from metric_depth_video_toolbox_tpu.models import svd as js
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu_torch.cli import depth_engines as tcli
from metric_depth_video_toolbox_tpu_torch.io import checkpoint as tckpt
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import svd as ts
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from port_helpers import _one_torch_thread  # noqa: F401
from test_torch_diffusion import assert_rel, flax_like

T, H, W = 6, 40, 56
WINDOW = 4
TOL = 1e-4
KEY = jax.random.PRNGKey(0)


def clip(seed=0):
    """(frames (T, H, W, 3) uint8, a smooth depth (T, H, W) in 1.5-4.5 m)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (T, H, W, 3), np.uint8)
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    depth = np.stack([3.0 + np.sin(3 * xx + 0.2 * t) * np.cos(2 * yy)
                      + 0.5 * rng.random((H, W)) for t in range(T)])
    return frames, depth.astype(np.float32)


def jax_noises(seed, n, shape):
    """The JAX engines' noise: one standard normal draw per window, each
    from a subkey split off ``PRNGKey(seed)`` before the window."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        out.append(torch.from_numpy(np.asarray(
            jax.random.normal(sub, shape, jnp.float32))))
    return out


def spread_decode(tree):
    """A ``VideoInpainter`` tree whose decoder's last convolution is 100x
    larger. Seeded weights decode a near-constant disparity (0.486-0.492
    here), on which DepthCrafter's metric fit, a 2x2 normal-equation solve,
    cancels in float32 in both packages (3% apart); a trained decoder's
    spread (0.34-0.69 with this tree) makes it well posed."""
    if "vae" in tree["params"]:
        rgb = tree["params"]["vae"]["to_rgb"]
        rgb["kernel"] = rgb["kernel"] * 100.0
    return tree


def assert_depth(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)


# ------------------------------------------------------ point-map VAE ----

@torch.no_grad()
def test_pmap_vae_encode_decode_match_flax():
    """PMAP_VAE_TINY: a point map in, its latent, and xyz + a mask logit
    (4 channels) out; the tree's config inferred alike."""
    x = np.random.default_rng(1).uniform(-1, 1, (3, 16, 24, 3)).astype(
        np.float32)
    jenc, jdec = js.SVDVAEEncoder(js.PMAP_VAE_TINY), js.SVDVAEDecoder(
        js.PMAP_VAE_TINY)
    etree = flax_like(jax.eval_shape(lambda: jenc.init(KEY, x)), 30)
    z = np.asarray(jax.jit(jenc.apply)(etree, x))
    dtree = flax_like(jax.eval_shape(lambda: jdec.init(KEY, z)), 31)
    out = np.asarray(jax.jit(jdec.apply)(dtree, z))
    tenc = from_jax.load_flax_params(ts.SVDVAEEncoder(ts.PMAP_VAE_TINY),
                                     etree).eval()
    tdec = from_jax.load_flax_params(ts.SVDVAEDecoder(ts.PMAP_VAE_TINY),
                                     dtree).eval()
    assert z.shape == (3, 2, 3, 4) and out.shape == (3, 16, 24, 4)
    assert_rel(tenc(torch.from_numpy(x)).numpy(), z, 1e-5)
    assert_rel(tdec(torch.from_numpy(z)).numpy(), out, 1e-5)
    tree = {"encoder": etree, "decoder": dtree}
    assert ts.vae_config_from_params(tree, "float32") == ts.PMAP_VAE_TINY
    assert js.vae_config_from_params(tree, "float32") == js.PMAP_VAE_TINY
    assert ts.PMAP_VAE == ts.SVDVAEConfig(out_channels=4)


# --------------------------------------------------------- DepthCrafter ----

# (JAX cfg, JAX VAE cfg, port cfg, port VAE cfg, work size, VAE factor)
DC_CASES = {
    "diffusion_tiny": (None, None, None, None, (64, 64), 8),
    "svd_tiny": (js.SVD_TINY, js.SVD_VAE_TINY, ts.SVD_TINY, ts.SVD_VAE_TINY,
                 (32, 32), 2)}


@functools.lru_cache(maxsize=None)
def depthcrafters(case):
    """(JAX engine, port engine on its tree, latent shape) of a DC_CASES
    entry: windows of 4 overlapping by 2, so a 6-frame clip runs two
    windows, stitched. One pair per case for the module (a JAX engine
    compiles its program once per instance)."""
    jcfg, jvae, tcfg, tvae, work, k = DC_CASES[case]
    kw = dict(window=WINDOW, overlap=2, work_hw=work)
    jeng = jdepth.DepthCrafterEngine(cfg=jcfg, vae_cfg=jvae, **kw)
    f = jnp.zeros((WINDOW,) + work + (3,))
    tree = spread_decode(flax_like(jax.eval_shape(lambda: jeng.model.init(
        KEY, f, f[..., 0])), 40))
    jeng._params = tree
    teng = tdepth.DepthCrafterEngine(cfg=tcfg, vae_cfg=tvae, params=tree,
                                     device="cpu", **kw)
    return jeng, teng, (WINDOW, work[0] // k, work[1] // k, 4)


@pytest.mark.parametrize("case,prompt", [
    ("diffusion_tiny", False), ("diffusion_tiny", True), ("svd_tiny", False),
    pytest.param("svd_tiny", True, marks=pytest.mark.slow)],
    ids=["diffusion_tiny-plain", "diffusion_tiny-prompted", "svd_tiny-plain",
         "svd_tiny-prompted"])
def test_depthcrafter_matches_jax(case, prompt):
    """Two stitched windows, re-metricized against the reference depth;
    ``prompted``: the reference's normalized inverse is the sampler's init
    latent."""
    jeng, teng, lat = depthcrafters(case)
    jeng.use_depth_prompting = teng.use_depth_prompting = prompt
    jeng._rng = jax.random.PRNGKey(0)
    frames, ref = clip()
    want = jeng.infer_video(frames, ref)
    got = teng.infer_video(frames, ref, noise=jax_noises(0, 2, lat))
    assert_depth(got, want)
    assert (got > 0).all() and got.max() <= 100.0


def test_reference_defaults_like_jax():
    """DepthCrafter: DIFFUSION_TINY by default, 1080p works at 448 x 768,
    a 40-frame clip runs one window of 110 frames (the last frame repeated);
    GeometryCrafter: xfov 60 when none is given."""
    from metric_depth_video_toolbox_tpu.models import diffusion as jd
    from metric_depth_video_toolbox_tpu_torch.models import diffusion as td

    jeng = jdepth.DepthCrafterEngine()
    teng = tdepth.DepthCrafterEngine(device="cpu")
    assert (jeng.cfg, teng.cfg) == (jd.DIFFUSION_TINY, td.DIFFUSION_TINY)
    assert teng._resolve_work_hw(1080, 1920) == jeng._resolve_work_hw(
        1080, 1920) == (448, 768)
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (40, 8, 8, 3), np.uint8)
    ref = rng.uniform(1, 5, (40, 8, 8)).astype(np.float32)
    seen = {"jax": [], "torch": []}

    def fake(name, to):
        def infer_window(f, r=None, noise=None):
            seen[name].append(f.copy())
            return to(np.ones(f.shape[:3], np.float32))
        return infer_window
    jeng.infer_window = fake("jax", jnp.asarray)
    teng.infer_window = fake("torch", torch.from_numpy)
    jeng.infer_video(frames, ref)
    teng.infer_video(frames, ref)
    want = frames[np.clip(np.arange(110), 0, 39)]
    for name in seen:
        assert len(seen[name]) == 1
        np.testing.assert_array_equal(seen[name][0], want)
    assert jdepth.GeometryCrafterEngine(xfov=None).xfov == 60.0
    assert tdepth.GeometryCrafterEngine(xfov=None, device="cpu").xfov == 60.0


# ------------------------------------------------------ GeometryCrafter ----

def pmap_vae_tree(seed):
    """A Flax tree of the point-map VAE at PMAP_VAE_TINY, in
    ``convert_svd_vae``'s layout."""
    x, z = jnp.zeros((2, 16, 16, 3)), jnp.zeros((2, 2, 2, 4))
    enc, dec = js.SVDVAEEncoder(js.PMAP_VAE_TINY), js.SVDVAEDecoder(
        js.PMAP_VAE_TINY)
    return {"encoder": flax_like(jax.eval_shape(lambda: enc.init(KEY, x)),
                                 seed),
            "decoder": flax_like(jax.eval_shape(lambda: dec.init(KEY, z)),
                                 seed + 1)}


@pytest.mark.parametrize("pmap", [False, True], ids=["shared_vae",
                                                     "pmap_vae"])
def test_geometrycrafter_matches_jax(pmap):
    """The prior's point maps (xfov 50) condition the denoiser; with the
    point-map VAE (DIFFUSION_TINY's 8x latents) or through the shared VAE
    (SVD_TINY); windows of 4 overlapping by 1 (two, stitched), then the
    median-ratio rescale to the prior."""
    if pmap:
        jcfg, jvae, tcfg, tvae, work, k = DC_CASES["diffusion_tiny"]
        pp = pmap_vae_tree(60)
        extra = ({"pmap_vae_params": pp, "pmap_vae_cfg": js.PMAP_VAE_TINY},
                 {"pmap_vae_params": pp, "pmap_vae_cfg": ts.PMAP_VAE_TINY})
    else:
        jcfg, jvae, tcfg, tvae, work, k = DC_CASES["svd_tiny"]
        extra = ({}, {})
    kw = dict(window=WINDOW, overlap=1, work_hw=work, xfov=50.0)
    jeng = jdepth.GeometryCrafterEngine(cfg=jcfg, vae_cfg=jvae, **kw,
                                        **extra[0])
    f = jnp.zeros((WINDOW,) + work + (3,))
    tree = flax_like(jax.eval_shape(lambda: jeng.model.init(
        KEY, f, f[..., 0], f)), 61)
    jeng._params = tree
    teng = tdepth.GeometryCrafterEngine(cfg=tcfg, vae_cfg=tvae, params=tree,
                                        device="cpu", **kw, **extra[1])
    assert (teng.pmap_enc is not None) == pmap
    frames, prior = clip(3)
    want = jeng.infer_video(frames, prior)
    got = teng.infer_video(frames, prior, noise=jax_noises(
        0, 2, (WINDOW, work[0] // k, work[1] // k, 4)))
    assert_depth(got, want)


# ------------------------------------------------ the CLIs, file to file ----

def _codes(path):
    with tvio.VideoReader(path) as r:
        rgb = r.read_all().astype(np.int64)
    return rgb[..., 0] * 256 + rgb[..., 2]


def assert_same_video(got, want):
    a, b = _codes(got), _codes(want)
    assert a.shape == b.shape == (T, H, W)
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() <= 0.05, (d.max(), (d > 0).mean())


def _inputs(tmp_path):
    """Each package's copy of the clip and its depth video."""
    frames, depth = clip(4)
    paths = {}
    for pkg in ("jax", "torch"):
        os.makedirs(tmp_path / pkg)
        c = str(tmp_path / pkg / "c.mkv")
        tvio.save_rgb_video(frames, c, 24)
        tvio.save_depth_video(depth, c + "_ref.mkv", 24, 100.0)
        paths[pkg] = c
    return paths


def _share(monkeypatch, name, tree, lat, n_windows, built, **fixed):
    """Both packages' ``name`` engines on ``tree`` (and the keywords
    ``fixed``), the port's fed the JAX engine's noise; the keywords each
    package passes are kept in ``built``."""
    jcls, tcls = jdepth._ENGINE_CLASSES[name], tdepth._ENGINE_CLASSES[name]

    def jmake(**kw):
        built.append(("jax", dict(kw)))
        return jcls(params=tree, **dict(kw, **fixed))

    class Port(tcls):
        def __init__(self, **kw):
            built.append(("torch", dict(kw)))
            super().__init__(params=tree, **dict(kw, **fixed))

        def infer_video(self, frames, ref, noise=None):
            return super().infer_video(frames, ref, noise=jax_noises(
                0, n_windows, lat))
    monkeypatch.setitem(jdepth._ENGINE_CLASSES, name, jmake)
    monkeypatch.setitem(tdepth._ENGINE_CLASSES, name, Port)


def test_depthcrafter_cli_matches_jax(tmp_path, monkeypatch):
    """``engine depthcrafter`` (DIFFUSION_TINY, --max_res 128 -> 64 x 128
    from the clip's aspect, --use_depth_prompting) through both CLIs."""
    pytest.importorskip("cv2")
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    paths = _inputs(tmp_path)
    f = jnp.zeros((WINDOW, 64, 128, 3))
    tree = spread_decode(flax_like(jax.eval_shape(
        lambda: jdepth.DepthCrafterEngine().model.init(KEY, f, f[..., 0])),
        70))
    built = []
    _share(monkeypatch, "depthcrafter", tree, (WINDOW, 8, 16, 4), 2, built)
    argv = ["--window", "4", "--overlap", "2", "--max_res", "128",
            "--use_depth_prompting"]
    for pkg, main in (("jax", jcli.depthcrafter_main),
                      ("torch", tcli.MAINS["depthcrafter"])):
        main(["--color_video", paths[pkg], "--depth_video",
              paths[pkg] + "_ref.mkv"] + argv)
    kws = [kw for _, kw in built]
    assert kws[1].pop("device", None) is None
    assert kws[0] == kws[1] and kws[0]["work_hw"] == (64, 128)
    assert_same_video(paths["torch"] + "_depth.mkv",
                      paths["jax"] + "_depth.mkv")


def test_geometrycrafter_cli_matches_jax(tmp_path, monkeypatch):
    """``engine geometrycrafter`` with a prior depth video and the median
    of --xfov_file, through both CLIs; --pmap_vae_checkpoint's file reaches
    the engine leaf for leaf."""
    pytest.importorskip("cv2")
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    from metric_depth_video_toolbox_tpu_torch.io import sidecar

    paths = _inputs(tmp_path)
    xfov_file = str(tmp_path / "xfovs.json")
    sidecar.save_xfovs(xfov_file, np.asarray([40.0, 70.0, 55.0, 50.0, 44.0,
                                              61.0], np.float32))
    f = jnp.zeros((WINDOW, 64, 64, 3))
    tree = spread_decode(flax_like(jax.eval_shape(
        lambda: jdepth.GeometryCrafterEngine().model.init(
            KEY, f, f[..., 0], f)), 71))
    built = []
    _share(monkeypatch, "geometrycrafter", tree, (WINDOW, 8, 8, 4), 2, built)
    argv = ["--window", "4", "--overlap", "1", "--max_res", "64",
            "--xfov_file", xfov_file]
    for pkg, main in (("jax", jcli.geometrycrafter_main),
                      ("torch", tcli.MAINS["geometrycrafter"])):
        main(["--color_video", paths[pkg], "--depth_video",
              paths[pkg] + "_ref.mkv"] + argv)
    kws = [kw for _, kw in built]
    assert kws[1].pop("device", None) is None
    assert kws[0] == kws[1] and kws[0]["xfov"] == 52.5
    assert_same_video(paths["torch"] + "_depth.mkv",
                      paths["jax"] + "_depth.mkv")
    # the point-map VAE's file
    pp = pmap_vae_tree(72)
    ckpt = str(tmp_path / "pmap.msgpack")
    tckpt.save_checkpoint(ckpt, pp)
    got = {}
    monkeypatch.setattr(tdepth, "run_batch",
                        lambda name, v, **kw: got.update(kw) or [])
    tcli.MAINS["geometrycrafter"](["--color_video", paths["torch"],
                                   "--pmap_vae_checkpoint", ckpt])
    loaded = got["pmap_vae_params"]
    for part in ("encoder", "decoder"):
        want = from_jax.flax_to_state_dict(pp[part])
        have = from_jax.flax_to_state_dict(loaded[part])
        assert sorted(want) == sorted(have)
        for key in want:
            assert torch.equal(want[key], have[key]), key
    assert ts.vae_config_from_params(loaded) == ts.SVDVAEConfig(
        block_out_channels=(32, 32, 32, 64), layers_per_block=1,
        out_channels=4)


# ------------------------------------------------------ the movie, step 2 ----

def _sf_tree(jeng):
    from metric_depth_video_toolbox_tpu.models import depth_anything as jda
    work = jda.working_resolution(H, W, 28, 14)
    x = jnp.zeros((1,) + work + (3,))
    grid = jnp.zeros((1, work[0] // 14, work[1] // 14, 3))
    cond = jeng.cfg.k_condition or jeng.cfg.fov_head
    from port_helpers import init_like
    return init_like(jeng.model, 0, *((x, grid) if cond else (x,)))


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["depthcrafter", "geometrycrafter"])
def test_movie_step2_diffusion_engines_match_jax(engine, tmp_path,
                                                 monkeypatch):
    """The movie's step 2: depthcrafter after a single-frame reference pass
    into ``<scene>_ref_depth.mkv`` (both packages' stand-ins at vitt, 28, on
    one tree), geometrycrafter on the prior of a MoGe single-frame engine
    (here, in both packages, one fixed depth: the MoGe engines are held
    against each other in test_torch_single_frame.py); the diffusion
    engines at their movie defaults (DIFFUSION_TINY) but for the window and
    the working size (windows of 4 overlapping by 2, at 64 x 64)."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.pipeline import movie as jmovie
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie as tmovie

    frames, prior = clip(5)
    sf_kw = dict(size="vitt", input_size=28)
    sf_tree = _sf_tree(jdepth.SingleFrameEngine(data_parallel=False,
                                                **sf_kw))
    variants = []
    for mod, extra in ((jdepth, {"data_parallel": False}), (tdepth, {})):
        cls = mod.SingleFrameEngine
        init = cls.__init__

        def patched(self, *a, _init=init, _extra=extra, **kw):
            variants.append((kw.get("variant", "da"), kw.get("size")))
            kw.update(sf_kw, params=sf_tree, **_extra)
            _init(self, *a, **kw)
        monkeypatch.setattr(cls, "__init__", patched)
        if engine == "geometrycrafter":
            monkeypatch.setattr(cls, "infer_video",
                                lambda self, f, **kw: prior[:len(f)])
    work = (64, 64)
    f = jnp.zeros((WINDOW,) + work + (3,))
    jcls = jdepth._ENGINE_CLASSES[engine]
    extra = (f,) if engine == "geometrycrafter" else ()
    tree = spread_decode(flax_like(jax.eval_shape(lambda: jcls().model.init(
        KEY, f, f[..., 0], *extra)), 80))
    built = []
    _share(monkeypatch, engine, tree, (WINDOW, 8, 8, 4), 2, built,
           window=WINDOW, overlap=2, work_hw=work)
    out = {}
    for pkg, movie in (("jax", jmovie), ("torch", tmovie)):
        root = str(tmp_path / pkg)
        os.makedirs(root)
        video = os.path.join(root, "scene_1.mkv")
        tvio.save_rgb_video(frames, video, 24)
        scenes = [{"Scene Number": "1", "finished": False,
                   "scene_video_file": video,
                   "depth_video_file": video + "_depth.mkv"}]
        kw = dict(engine=engine, engine_kwargs=dict(sf_kw))
        if pkg == "torch":
            kw["device"] = "cpu"
        movie.step2_estimate_depth(scenes, **kw)
        out[pkg] = video
        assert os.path.exists(video + "_ref_depth.mkv") == (
            engine == "depthcrafter")
    assert [name for name, _ in built] == ["jax", "torch"]
    # the reference pass gets the movie's engine keywords; the MoGe prior
    # none of them (run_batch hands them to the diffusion engine)
    assert variants == 2 * [("da", "vitt") if engine == "depthcrafter"
                            else ("moge", None)]
    assert_same_video(out["torch"] + "_depth.mkv", out["jax"] + "_depth.mkv")
