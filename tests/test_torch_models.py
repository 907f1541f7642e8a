"""The port's models against the JAX package's Flax models in float32, with
parameters drawn like ``model.init``'s from its shapes (perturbed so that
biases and norms are not at their trivial initial values) carried across
by ``models.from_jax``.

Tolerance: outputs within 1e-4 of the largest output magnitude
(measured: ~2e-6). ``_resize`` is held against ``jax.image.resize`` at the
shapes the engine uses, both directions, within 1e-5 absolute on [0, 1]
data (measured: 7.6e-6 downscaling 1080x1920 -> 518x924, where about 4
input pixels feed each output).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.models import dpt as jdpt
from metric_depth_video_toolbox_tpu.models import video_depth as jvd
from metric_depth_video_toolbox_tpu.models import vit as jvit
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as tda
from metric_depth_video_toolbox_tpu_torch.models import dpt as tdpt
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import video_depth as tvd
from metric_depth_video_toolbox_tpu_torch.models import vit as tvit
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import init_like

REL = 1e-4
HW = (42, 56)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


J_VIT, T_VIT = f32(jvit.VIT_TINY), f32(tvit.VIT_TINY)
J_DPT, T_DPT = f32(jdpt.DPT_TINY), f32(tdpt.DPT_TINY)


def init(model, seed, *inputs):
    """Flax-init-like parameters, perturbed (``port_helpers``)."""
    return init_like(model, seed, *inputs)


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= REL * scale, \
        np.abs(got - want).max() / scale


def frames(n, seed=0):
    return np.random.default_rng(seed).random((n,) + HW + (3,),
                                              np.float32)


VDA_J = jvd.VideoDepthConfig(vit=J_VIT, dpt=J_DPT, temporal_heads=2,
                             norm_groups=4, window=6)
VDA_T = tvd.VideoDepthConfig(vit=T_VIT, dpt=T_DPT, temporal_heads=2,
                             norm_groups=4, window=6)


def run_flax(model, seed, x):
    """(params, output, intermediates) of one jitted Flax apply; every
    submodule's output is captured, so each port module is held against
    its Flax counterpart on the Flax inputs it saw."""
    params = init(model, seed, jnp.asarray(x))
    out, state = jax.jit(
        lambda p, v: model.apply(p, v, capture_intermediates=True))(
            params, jnp.asarray(x))
    return params, out, state["intermediates"]


@pytest.fixture(scope="module")
def vda():
    x = frames(6, 3)
    return (x,) + run_flax(jvd.VideoDepthAnything(VDA_J), 3, x)


@pytest.fixture(scope="module")
def anything():
    x = frames(2, 4)
    cfg = jda.DepthAnythingConfig(vit=J_VIT, dpt=J_DPT, metric=True)
    return (x,) + run_flax(jda.DepthAnything(cfg), 4, x)


def sub(params, name):
    return {"params": params["params"][name]}


def as_torch(feats):
    return [torch.from_numpy(np.array(f)) for f in feats]


def test_vit_matches_flax(vda):
    x, params, _, inter = vda
    want_feats, want_cls = inter["backbone"]["__call__"][0]
    tm = tvit.ViT(T_VIT, (HW[0] // 14) * (HW[1] // 14))
    from_jax.load_flax_params(tm, sub(params, "backbone"))
    with torch.no_grad():
        feats, cls = tm(torch.from_numpy(x))
    assert len(feats) == len(want_feats) == 4
    for g, w in zip(feats, want_feats):
        assert_close(g.numpy(), w)
    assert_close(cls.numpy(), want_cls)


def test_dpt_head_temporal_matches_flax(vda):
    _, params, _, inter = vda
    feats = inter["backbone"]["__call__"][0][0]
    tm = tvd.DPTHeadTemporal(VDA_T)
    from_jax.load_flax_params(tm, sub(params, "head"))
    with torch.no_grad():
        got = tm(as_torch(feats))
    assert_close(got.numpy(), inter["head"]["__call__"][0])


def test_temporal_module_matches_flax(vda):
    _, params, _, inter = vda
    head = inter["head"]
    want = head["motion0"]["__call__"][0]
    # the motion module's input: the reassembled level-2 features
    y = np.array(head["project2"]["__call__"][0])
    tm = tvd.TemporalModule(J_DPT.out_channels[2], 2, 1, 4, torch.float32)
    from_jax.load_flax_params(tm, {"params": params["params"]["head"][
        "motion0"]})
    with torch.no_grad():
        got = tm(torch.from_numpy(y))
    assert_close(got.numpy(), want)


def test_video_depth_anything_matches_flax(vda):
    x, params, want, _ = vda
    tm = tvd.VideoDepthAnything(VDA_T, HW)
    from_jax.load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want)


def test_dpt_head_matches_flax(anything):
    _, params, _, inter = anything
    feats = inter["backbone"]["__call__"][0][0]
    tm = tdpt.DPTHead(T_DPT, 64)
    from_jax.load_flax_params(tm, sub(params, "head"))
    with torch.no_grad():
        got = tm(as_torch(feats))
    assert_close(got.numpy(), inter["head"]["__call__"][0])


@pytest.mark.parametrize("metric", [True, False])
def test_depth_anything_matches_flax(anything, metric):
    """metric: the relu head clipped to max_depth (the JAX forward);
    relative: the raw head output, which the JAX forward returns when
    ``metric=False``."""
    x, params, want, inter = anything
    if not metric:
        want = np.asarray(inter["head"]["__call__"][0])[..., 0]
    tcfg = tda.DepthAnythingConfig(vit=T_VIT, dpt=T_DPT, metric=metric)
    tm = tda.DepthAnything(tcfg, HW)
    from_jax.load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert_close(got.numpy(), want)


def test_working_resolution_matches():
    for h, w, s in [(1080, 1920, 518), (48, 64, 42), (720, 1280, 364)]:
        assert tda.working_resolution(h, w, s, 14) == \
            jda.working_resolution(h, w, s, 14)


def test_sinusoidal_pe_matches():
    np.testing.assert_array_equal(tvd._sinusoidal_pe(32, 64),
                                  jvd._sinusoidal_pe(32, 64))


@pytest.mark.parametrize("src,dst", [((1080, 1920), (518, 924)),
                                     ((518, 924), (1080, 1920)),
                                     ((37, 4), (74, 2))])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(6).random((1,) + src + (1,), np.float32)
    want = jax.image.resize(jnp.asarray(x), (1,) + dst + (1,), "bilinear")
    got = tdpt._resize(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_from_jax_layouts():
    params = {"params": {"d": {"kernel": np.arange(6.0).reshape(2, 3),
                               "bias": np.ones(3)},
                         "c": {"kernel": np.zeros((3, 3, 4, 5))},
                         "n": {"scale": np.ones(4)}}}
    sd = from_jax.flax_to_state_dict(params)
    assert sd["d.weight"].shape == (3, 2)
    assert sd["d.weight"][2, 1] == 5.0
    assert sd["c.weight"].shape == (5, 4, 3, 3)
    assert set(sd) == {"d.weight", "d.bias", "c.weight", "n.weight"}


def test_torch_resize_dpt_not_ported():
    with pytest.raises(NotImplementedError, match="A5"):
        tdpt.DPTHead(dataclasses.replace(T_DPT, torch_resize=True), 64)
