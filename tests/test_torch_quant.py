"""``--quantize int8`` in the port (``ops/quant.py``,
``models/vit.py::QDense``, and the VDA, single-frame and DA3 engines)
against the JAX package's ``ops/quant.py`` and ``QDense``.

Tolerances: the int8 operands, their scales and the int32 accumulators
exact; ``int8_dense`` in float32 within 2 ulp of the largest output (the
scales' product rounds the same, the bias sum is one add); the quantized
ViT in float32 within 1e-3 of the largest output. A float32 difference in
an activation can move its int8 code by one step (1/127 of the token's
largest value) in a handful of elements, which the layers after it carry
on and the DPT head spreads over a patch: the single-frame and DA3
engines' depth within 2e-2 of the largest at any pixel and 1e-3 of it on
the mean (measured 7.7e-3 and 1.3e-4); DA3's rotations within 3e-2,
translations within 1e-2 of the largest and FOVs within 1 degree
(measured 1.4e-2, 4.5e-3 and 0.38 degrees: seeded weights' FOVs reach 157
degrees, where the focal solve is steep); the VDA metric depth, fitted to
a reference depth video, within 1e-3 relative where the fitted inverse
depth is not within 1% of the largest of zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import vit as jvit
from metric_depth_video_toolbox_tpu.ops import quant as jquant
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import vit as tvit
from metric_depth_video_toolbox_tpu_torch.ops import quant as tquant
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import init_like

REL = 1e-3


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, \
        np.abs(got - want).max() / scale


def assert_engine_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    d = np.abs(got - want) / np.abs(want).max()
    assert d.max() <= 2e-2 and d.mean() <= 1e-3, (d.max(), d.mean())


def test_quantize_symmetric_matches_jax_exactly():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 33)).astype(np.float32)
    x[1] = 0.0                                  # eps keeps the scale finite
    x[2, 3] = 1e6                               # one outlier per token
    for axis in (0, 1):
        wq, ws = jquant.quantize_symmetric(jnp.asarray(x), axis)
        gq, gs = tquant.quantize_symmetric(torch.from_numpy(x), axis)
        assert gq.dtype == torch.int8 and gs.dtype == torch.float32
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        assert gs.numpy().tobytes() == np.asarray(ws).tobytes()


@pytest.mark.parametrize("lead", [(40,), (3, 9)], ids=["2d", "3d"])
def test_int8_dense_matches_jax(lead):
    """Equal int32 accumulators (the port's plain int32 product on the CPU
    against XLA's int8 dot), and outputs within float32 rounding."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(lead + (64,)).astype(np.float32)
    kernel = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    qx, _ = jquant.quantize_symmetric(jnp.asarray(x), x.ndim - 1)
    qw, _ = jquant.quantize_symmetric(jnp.asarray(kernel), 0)
    want_acc = np.asarray(jax.lax.dot_general(
        qx, qw, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    tqx, _ = tquant.quantize_symmetric(torch.from_numpy(x).reshape(-1, 64),
                                       1)
    tqw, _ = tquant.quantize_symmetric(torch.from_numpy(kernel.T.copy()), 1)
    acc = tquant.int8_matmul(tqx, tqw.t())
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy().reshape(want_acc.shape),
                                  want_acc)
    want = np.asarray(jquant.int8_dense(jnp.asarray(x), jnp.asarray(kernel),
                                        jnp.asarray(bias), jnp.float32))
    got = tquant.int8_dense(torch.from_numpy(x),
                            torch.from_numpy(kernel.T.copy()),
                            torch.from_numpy(bias), torch.float32).numpy()
    assert got.shape == lead + (48,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * np.spacing(np.abs(want).max()))
    bf = tquant.int8_dense(torch.from_numpy(x),
                           torch.from_numpy(kernel.T.copy()),
                           torch.from_numpy(bias))
    assert bf.dtype == torch.bfloat16
    assert_close(bf.float().numpy(), want, 2 ** -7)


@torch.no_grad()
def test_quantized_vit_matches_flax_on_the_same_tree():
    """VIT_TINY in float32 with ``quant="int8"``: the blocks' Dense layers
    become QDense, the tree is the plain ViT's (it loads strictly into
    both), the features match the Flax QDense ViT."""
    jcfg = dataclasses.replace(jvit.VIT_TINY, dtype="float32", quant="int8")
    tcfg = dataclasses.replace(tvit.VIT_TINY, dtype="float32", quant="int8")
    x = np.random.default_rng(2).random((2, 28, 42, 3)).astype(np.float32)
    tree = init_like(jvit.ViT(dataclasses.replace(jcfg, quant=None)), 0,
                     jnp.asarray(x))
    feats, cls = jax.jit(jvit.ViT(jcfg).apply)(tree, x)
    model = from_jax.load_flax_params(tvit.ViT(tcfg, 6), tree).eval()
    assert isinstance(model.block0.attn.qkv, tvit.QDense)
    assert isinstance(model.block0.mlp.fc2, tvit.QDense)
    plain = from_jax.load_flax_params(tvit.ViT(dataclasses.replace(
        tcfg, quant=None), 6), tree)
    assert model.state_dict().keys() == plain.state_dict().keys()
    got, gcls = model(torch.from_numpy(x))
    for g, w in zip(got, feats):
        assert_close(g.numpy(), w)
    assert_close(gcls.numpy(), cls)


# ------------------------------------------------------------ engines ----

@pytest.mark.slow
def test_vda_engine_quantized_matches_jax():
    """VDAEngine(quantize="int8") at vitt in float32, made metric against
    a reference depth video: both packages on one tree."""
    from metric_depth_video_toolbox_tpu.models import depth_anything as jda
    from test_torch_depth_engine import ENGINE, REFERENCE, H, W, clip

    kw = dict(ENGINE, quantize="int8")
    jeng = jdepth.VDAEngine(data_parallel=False, **kw)
    assert jeng.cfg.vit.quant == "int8"
    jeng._ensure_params(jda.working_resolution(H, W, kw["input_size"], 14))
    teng = tdepth.VDAEngine(
        device="cpu", params=from_jax.flax_to_state_dict(jeng._params),
        anchor_params=from_jax.flax_to_state_dict(jeng._anchor_params), **kw)
    assert teng.cfg.vit.quant == "int8"
    frames = clip()
    want = jeng.infer_video(frames, reference_depth=REFERENCE)
    got = teng.infer_video(frames, reference_depth=REFERENCE)
    assert got.shape == want.shape and got.dtype == np.float32
    inv = 1.0 / np.maximum(want, 1e-6)
    ok = (want < 100.0) & (inv > 0.01 * inv.max())
    assert ok.mean() > 0.95
    np.testing.assert_allclose(got[ok], want[ok], rtol=REL)


def test_single_frame_engine_quantized_matches_jax(monkeypatch):
    """SingleFrameEngine(quantize="int8"): the stand-in at vitt in float32
    against the JAX engine on one tree; a tree of a real graph (MoGe,
    UniDepth, UniK3D, DepthPro) takes the int8 matmuls into that graph's
    ViT, as in the JAX engine."""
    from metric_depth_video_toolbox_tpu.models import depth_anything as jda
    from metric_depth_video_toolbox_tpu_torch.models import \
        depth_anything as tda
    from port_helpers import float32_presets
    from test_torch_single_frame import clip, engine_pair

    float32_presets(monkeypatch, jda, tda)
    jeng, teng = engine_pair("da", None, quantize="int8")
    assert teng.cfg.vit.quant == "int8" == jeng.cfg.vit.quant
    frames = clip()
    assert_engine_close(teng.infer_video(frames, batch=4),
                        jeng.infer_video(frames, batch=4))
    for variant, node, xfov in (("moge", ("head", "upsample0"), None),
                                ("unidepth", ("camera",), 60.0),
                                ("unik3d", ("angular",), None),
                                ("depthpro", ("patch_encoder",), None)):
        tree = {"params": {node[0]: {node[-1]: {}} if len(node) > 1
                           else {}}}
        eng = tdepth.SingleFrameEngine(size="vitt", variant=variant,
                                       xfov=xfov, params=tree,
                                       quantize="int8", device="cpu")
        assert eng.graph[0] == variant
        assert eng.graph[1].vit.quant == "int8"


def test_da3_engine_quantized_matches_jax():
    """DA3PipelineEngine(quantize="int8") at DA3_TINY in float32 over
    windows: depth, poses and FOVs."""
    from test_torch_da3 import J_CFG, T_CFG, WINDOW, clip, flax_params

    jeng = jdepth.DA3PipelineEngine(cfg=J_CFG, quantize="int8", **WINDOW)
    jeng.engine._params = flax_params(False)
    teng = tdepth.DA3PipelineEngine(
        cfg=T_CFG["xla"], quantize="int8", device="cpu",
        params=from_jax.flax_to_state_dict(jeng.engine._params), **WINDOW)
    assert teng.engine.cfg.vit.quant == "int8"
    frames = clip()
    wd, wc2w, wfov = jeng.engine.infer_video(frames)
    gd, gc2w, gfov = teng.engine.infer_video(frames)
    assert_engine_close(gd, wd)
    np.testing.assert_allclose(gc2w[:, :3, :3], wc2w[:, :3, :3], atol=3e-2)
    np.testing.assert_allclose(gc2w[:, :3, 3], wc2w[:, :3, 3],
                               atol=1e-2 * np.abs(wc2w[:, :3, 3]).max())
    np.testing.assert_allclose(gfov, wfov, atol=1.0)
