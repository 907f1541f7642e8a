"""The real graphs of the single-frame engines against the JAX package's:
``MoGeNet``, ``UniDepthNet``, ``UniK3DNet`` and ``DepthProNet`` on shared
Flax trees, their four converters on seeded upstream-layout state dicts,
and the engines switching onto the real graphs from a converted file
through ``mdvt-torch engine <name> --checkpoint``.

The upstream-layout state dicts are drawn (seeded) from
``chip_smoke.py``'s layout tables, ``moge_shapes``, ``unidepth_shapes``
and ``depthpro_hf_shapes`` (the last held here against the
``transformers`` DepthPro model's own state dict), so that the chip run
converts the same layouts at full width.

Tolerances:
- the models in float32: every output within 1e-4 of its largest
  magnitude (measured ~1e-6); in bfloat16 within 5e-2 (measured 1.7e-2:
  the packages round to bfloat16 at other places);
- converted trees: the same key paths, every leaf bit-equal, and the
  shapes of the JAX model's ``init``;
- file to file, float32, point maps mapped upstream-style
  (``port_helpers.upstream_style_point_maps``): 16-bit depth codes within
  one step everywhere and equal on 99% of pixels, FOVs within 1e-3
  degrees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.models import depthpro as jdp
from metric_depth_video_toolbox_tpu.models import moge as jmoge
from metric_depth_video_toolbox_tpu.models import unidepth as jud
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.models import convert as tconvert
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as tda
from metric_depth_video_toolbox_tpu_torch.models import depthpro as tdp
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import moge as tmoge
from metric_depth_video_toolbox_tpu_torch.models import unidepth as tud
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import (float32_presets, init_like,
                          upstream_style_point_maps)

HW = (28, 42)            # 2 x 3 patches of 14


def _dtype(cfg, dtype):
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype=dtype))


def _compare(got, want, tol):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=tol * np.abs(b).max(), rtol=0)


TOL = {"float32": 1e-4, "bfloat16": 5e-2}
RNG = np.random.default_rng(7)
IMAGES = RNG.random((2,) + HW + (3,)).astype(np.float32)
RAYS = jda.patch_center_rays(65.0, 2, 3)[None].repeat(2, 0)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_moge_matches_flax(dtype):
    jcfg, tcfg = _dtype(jmoge.MOGE_TINY, dtype), _dtype(tmoge.MOGE_TINY,
                                                        dtype)
    tree = init_like(jmoge.MoGeNet(jcfg), 0, IMAGES)
    want = jmoge.MoGeNet(jcfg).apply(tree, IMAGES)
    mod = from_jax.load_params(tmoge.MoGeNet(tcfg, HW), tree)
    with torch.no_grad():
        got = mod(torch.from_numpy(IMAGES))
    _compare(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("net,rays", [("UniDepthNet", False),
                                      ("UniDepthNet", True),
                                      ("UniK3DNet", False)])
def test_unidepth_family_matches_flax(net, rays, dtype):
    """UniDepth-V2 with its own camera's rays and with given rays (the
    engine's --xfov path), and UniK3D; depth, confidence, cam4 / points,
    confidence logit."""
    jcfg = _dtype(jud.UNIDEPTH_TINY, dtype)
    tcfg = _dtype(tud.UNIDEPTH_TINY, dtype)
    args = (IMAGES, RAYS) if rays else (IMAGES,)
    jnet = getattr(jud, net)(jcfg)
    tree = init_like(jnet, 0, *args)
    want = jnet.apply(tree, *args)
    mod = from_jax.load_params(getattr(tud, net)(tcfg, HW), tree)
    with torch.no_grad():
        got = mod(*(torch.from_numpy(a) for a in args))
    _compare(got, want, TOL[dtype])


def test_rsh_cart_matches():
    """Degree 8 (81 features, float32): within 1e-5 of the largest."""
    xyz = np.random.default_rng(1).standard_normal((64, 3))
    xyz = (xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)).astype(
        np.float32)
    want = np.asarray(jud.rsh_cart(jnp.asarray(xyz), 8))
    got = tud.rsh_cart(torch.from_numpy(xyz), 8).numpy()
    assert got.shape == (64, 81)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("use_fov", [True, False])
def test_depthpro_matches_flax(use_fov):
    """DEPTHPRO_TINY (float32) at 128 x 128: the 1 + 9 + 25 patch split of
    the production 1536 px working point, merge, fusion, FOV head."""
    jcfg = dataclasses.replace(jdp.DEPTHPRO_TINY, use_fov=use_fov)
    tcfg = dataclasses.replace(tdp.DEPTHPRO_TINY, use_fov=use_fov)
    x = np.random.default_rng(0).normal(0, 0.5, (2, 128, 128, 3)).astype(
        np.float32)
    tree = init_like(jdp.DepthProNet(jcfg), 0, x)
    want = jdp.DepthProNet(jcfg).apply(tree, x)
    mod = from_jax.load_params(tdp.DepthProNet(tcfg), tree)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert (got[1] is None) == (not use_fov)
    _compare([g for g in got if g is not None],
             [w for w in want if w is not None], 1e-4)


def test_depthpro_patch_arithmetic_matches():
    """The split and merge indices at the production ratios, bit for bit:
    35 patches of 384 from a 1536 image, each scale merged back with its
    padding, on an image of distinct values."""
    x = np.arange(1536 * 1536, dtype=np.float32).reshape(1, 1536, 1536, 1)
    for r, ov in zip((0.25, 0.5, 1.0), (0.0, 0.5, 0.25)):
        size = int(1536 * r)
        xs = x[:, :size, :size]
        want = np.asarray(jdp._split_patches(jnp.asarray(xs), 384, ov))
        got = tdp._split_patches(torch.from_numpy(xs), 384, ov).numpy()
        np.testing.assert_array_equal(got, want)
        pad = int(3 / r)
        np.testing.assert_array_equal(
            tdp._merge_patches(torch.from_numpy(got[:, ::16, ::16]), 1,
                               pad).numpy(),
            np.asarray(jdp._merge_patches(jnp.asarray(want[:, ::16, ::16]),
                                          1, pad)))
    assert tdp.working_size(tdp.DEPTHPRO_L) == jdp.working_size(
        jdp.DEPTHPRO_L) == 1536


# --- the converters ------------------------------------------------------

def assert_trees_equal(got, want, path=""):
    """Same key paths; leaves of the same dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


def upstream_sd(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: v.numpy() for k, v in chip_smoke.upstream_state_dict(
        shapes, gen, "cpu").items()}


def _shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


N_TOK = (HW[0] // 14) * (HW[1] // 14)
CONVERTERS = {
    "moge": (lambda: chip_smoke.moge_shapes(tmoge.MOGE_TINY, N_TOK),
             jmoge.MOGE_TINY, tmoge.MOGE_TINY,
             lambda c: jmoge.MoGeNet(c), (IMAGES,)),
    "unidepth": (lambda: chip_smoke.unidepth_shapes(tud.UNIDEPTH_TINY,
                                                    N_TOK),
                 jud.UNIDEPTH_TINY, tud.UNIDEPTH_TINY,
                 lambda c: jud.UniDepthNet(c), (IMAGES,)),
    "unik3d": (lambda: chip_smoke.unidepth_shapes(tud.UNIDEPTH_TINY, N_TOK,
                                                  "unik3d"),
               jud.UNIDEPTH_TINY, tud.UNIDEPTH_TINY,
               lambda c: jud.UniK3DNet(c), (IMAGES,)),
    "depthpro_hf": (lambda: chip_smoke.depthpro_hf_shapes(
        tdp.DEPTHPRO_TINY), jdp.DEPTHPRO_TINY, tdp.DEPTHPRO_TINY,
        lambda c: jdp.DepthProNet(c), (np.zeros((1, 128, 128, 3),
                                                np.float32),)),
}


@pytest.mark.parametrize("kind", sorted(CONVERTERS))
def test_converter_matches_jax(kind, tmp_path):
    """The port's converter and ``convert_torch_file`` dispatch give the
    JAX converter's tree, leaf for leaf, with the JAX model's shapes."""
    shapes, jcfg, tcfg, jmodel, args = CONVERTERS[kind]
    sd = upstream_sd(shapes(), 11)
    fn = f"convert_{kind}"
    want = getattr(jconvert, fn)(sd, jcfg)
    assert_trees_equal(getattr(tconvert, fn)(sd, tcfg), want)
    path = str(tmp_path / "upstream.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    assert_trees_equal(tconvert.convert_torch_file(path, kind, tcfg), want)
    assert _shapes(want) == _shapes(jax.eval_shape(
        lambda: jmodel(jcfg).init(jax.random.PRNGKey(0), *args)))


def test_depthpro_layout_table_matches_transformers():
    transformers = pytest.importorskip("transformers")
    dino = transformers.Dinov2Config(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
        image_size=32, patch_size=8)
    hf = transformers.DepthProForDepthEstimation(transformers.DepthProConfig(
        patch_size=32, intermediate_hook_ids=[3, 1],
        intermediate_feature_dims=[16, 16],
        scaled_images_ratios=[0.25, 0.5, 1.0],
        scaled_images_overlap_ratios=[0.0, 0.5, 0.25],
        scaled_images_feature_dims=[16, 16, 16], fusion_hidden_size=16,
        use_fov_model=True, image_model_config=dino,
        patch_model_config=dino, fov_model_config=dino))
    want = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    assert chip_smoke.depthpro_hf_shapes(tdp.DEPTHPRO_TINY) == want


# --- the engines on converted files ---------------------------------------

CLI = {"moge": [], "unidepth": ["--xfov", "60"], "unik3d": [],
       "depthpro": []}
KIND = {"moge": "moge", "unidepth": "unidepth", "unik3d": "unik3d",
        "depthpro": "depthpro_hf"}


@pytest.fixture
def float32_graphs(monkeypatch):
    """Both packages' tiny presets in float32, point maps upstream-style."""
    float32_presets(monkeypatch, jda, tda)
    upstream_style_point_maps(monkeypatch, jdepth, tdepth)
    for jm, tm, name in ((jmoge, tmoge, "MOGE_TINY"),
                         (jud, tud, "UNIDEPTH_TINY")):
        for mod in (jm, tm):
            monkeypatch.setattr(mod, name,
                                _dtype(getattr(mod, name), "float32"))


@pytest.mark.parametrize("name", sorted(CLI))
def test_engine_checkpoint_file_matches_jax(name, float32_graphs, tmp_path,
                                            monkeypatch):
    """``engine <name> --checkpoint`` on a file converted from a seeded
    upstream-layout state dict: the port's engine takes the real graph,
    and its depth video and FOVs match the JAX CLI's on the same file."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.cli import depth_engines as jcli
    from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    shapes, _, tcfg, _, _ = CONVERTERS[KIND[name]]
    ckpt = str(tmp_path / f"{name}.msgpack")
    tconvert.save_checkpoint(ckpt, getattr(tconvert, "convert_" + KIND[
        name])(upstream_sd(shapes(), 12), tcfg))
    frames = np.random.default_rng(5).integers(0, 255, (3,) + HW + (3,),
                                               np.uint8)
    graphs = []
    orig = tdepth.SingleFrameEngine.model
    monkeypatch.setattr(tdepth.SingleFrameEngine, "model",
                        lambda self, hw: graphs.append(self.graph) or
                        orig(self, hw))
    outs = {}
    for pkg in ("jax", "torch"):
        clip = str(tmp_path / pkg / "clip.mkv")
        tvio.save_rgb_video(frames, clip, 24)
        argv = ["--color_video", clip, "--checkpoint", ckpt,
                "--model_size", "vitt", "--input_size", str(HW[0])] + CLI[name]
        if pkg == "jax":
            outs[pkg] = getattr(jcli, f"{name}_main")(argv)[0]
        else:
            tmain.main(["engine", name] + argv)
            outs[pkg] = clip + "_depth.mkv"
    assert graphs[0][0] == name
    codes = {}
    for pkg, out in outs.items():
        with tvio.VideoReader(out) as r:
            rgb = r.read_all().astype(np.int64)
        codes[pkg] = rgb[..., 0] * 256 + rgb[..., 2]
    diff = np.abs(codes["torch"] - codes["jax"])
    assert codes["torch"].shape == (3,) + HW
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    if name != "unidepth":
        fovs = [sidecar.load_xfovs(o + "_xfovs.json")
                for o in (outs["torch"], outs["jax"])]
        np.testing.assert_allclose(fovs[0], fovs[1], atol=1e-3)
