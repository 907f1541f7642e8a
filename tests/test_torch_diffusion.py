"""The port's SVD-class diffusion model (``models/diffusion.py``) and the
new leaves of ``models/from_jax.py`` against the JAX package.

Each module is held against its Flax twin on one shared parameter tree
(drawn with numpy from ``jax.eval_shape``; scales and biases perturbed so
that every leaf matters), every Flax ``apply`` jitted once per shape.

Tolerances: encode, decode and denoise within 1e-5 of the largest output
(float32 sums in other orders; measured <= 1e-6); ``edm_sigmas`` exact;
``sample`` fed the JAX noise within 1e-4 of the largest latent (two
Euler steps compound the denoiser's rounding); the ConvTranspose and
nearest-resize layouts within 1e-5 absolute on unit-scale data.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import diffusion as jd
from metric_depth_video_toolbox_tpu_torch.models import diffusion as td
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from port_helpers import _one_torch_thread  # noqa: F401

# a narrow four-level float32 config: spatial attention from level 1, an
# odd latent side (5 x 7), so the stride-2 'SAME' pads (1, 1) there and
# (0, 1) elsewhere, the up path resizes by nearest, and heads split 32-wide
FOUR_LEVEL = jd.DiffusionConfig(base_width=32, width_mults=(1, 2, 2, 2),
                                spatial_attn_min_level=1, num_steps=2,
                                dtype="float32")
CASES = {"tiny": (jd.DIFFUSION_TINY, (32, 48), False),
         "four_level_mono": (FOUR_LEVEL, (40, 56), True)}
T = 3


def flax_like(tree, seed):
    """numpy values for a Flax tree of shapes: LeCun-normal kernels,
    scales 1 + N(0, 0.1), biases and other leaves N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name == "scale":
            return 1 + 0.1 * rng.standard_normal(leaf.shape)
        if name in ("class_embedding", "position_embedding"):
            return rng.normal(0, 0.02, leaf.shape)
        return 0.1 * rng.standard_normal(leaf.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(draw(p, a), np.float32), tree)


def port_cfg(cfg):
    """The port's DiffusionConfig with the fields of a JAX one."""
    return td.DiffusionConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)})


def assert_rel(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.fixture(scope="module", params=sorted(CASES))
def inpainters(request):
    """(name, JAX VideoInpainter, its tree, the port's VideoInpainter on the
    same tree, working size)."""
    cfg, hw, mono = CASES[request.param]
    jm = jd.VideoInpainter(cfg)
    f = jnp.zeros((T,) + hw + (3,))
    tree = flax_like(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), f, f[..., 0], mono=f if mono else None)), 0)
    tm = td.VideoInpainter(port_cfg(cfg), mono=mono)
    from_jax.load_flax_params(tm, tree)
    return request.param, jm, tree, tm.eval(), hw


def _apply(jm, method):
    return jax.jit(lambda p, *a: jm.apply(p, *a, method=method))


@torch.no_grad()
def test_inpainter_matches_flax(inpainters):
    """encode, decode and the denoiser at a large and a small sigma."""
    name, jm, tree, tm, hw = inpainters
    rng = np.random.default_rng(1)
    x = rng.random((T,) + hw + (3,)).astype(np.float32)
    z = np.asarray(_apply(jm, jm.encode)(tree, x))
    assert_rel(tm.encode(torch.from_numpy(x)).numpy(), z, 1e-5)
    y = np.asarray(_apply(jm, jm.decode)(tree, z))
    assert_rel(tm.decode(torch.from_numpy(z)).numpy(), y, 1e-5)
    cc = 5 + (4 if name.endswith("mono") else 0)
    cond = rng.standard_normal(z.shape[:3] + (cc,)).astype(np.float32)
    den = jax.jit(lambda p, zz, s, c: jm.apply(p, zz, s, c,
                                               method=jm.denoise))
    for sigma in (80.0, 0.5):
        want = np.asarray(den(tree, z, jnp.float32(sigma), cond))
        got = tm.denoise(torch.from_numpy(z), torch.tensor(sigma),
                         torch.from_numpy(cond))
        assert_rel(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("num_steps", [1, 2, 5, 25])
@pytest.mark.parametrize("sigma_max", [80.0, 700.0])
def test_edm_sigmas_exact(num_steps, sigma_max):
    cfg = dataclasses.replace(jd.DIFFUSION_SVD, num_steps=num_steps,
                              sigma_max=sigma_max)
    want = np.asarray(jd.edm_sigmas(cfg))
    got = td.edm_sigmas(port_cfg(cfg)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@torch.no_grad()
def test_sample_matches_jax(inpainters):
    """The Euler sampler fed the JAX noise (and with an init prompt), on the
    inpainter's denoiser: within 1e-4 of the largest latent."""
    name, jm, tree, tm, hw = inpainters
    cfg = jm.cfg
    lat = (T, -(-hw[0] // 8), -(-hw[1] // 8), 4)
    rng = np.random.default_rng(2)
    cc = 5 + (4 if name.endswith("mono") else 0)
    cond = rng.standard_normal(lat[:3] + (cc,)).astype(np.float32)
    init = rng.standard_normal(lat).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, lat, jnp.float32))

    def unet(p, z, s, c):
        return jm.apply(p, z, s, c, method=jm.denoise)
    run = jax.jit(lambda p, c, i: jd.sample(unet, p, key, lat, cfg, c, i))
    for prompt in (None, init):
        want = np.asarray(run(tree, cond, prompt))
        got = td.sample(tm.denoise, torch.from_numpy(noise), tm.cfg,
                        torch.from_numpy(cond),
                        None if prompt is None else torch.from_numpy(prompt))
        assert_rel(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("hw", [(5, 6), (4, 7)])
def test_conv_transpose_layout_matches_flax(hw):
    """flax ConvTranspose (4, 4), stride 2, 'SAME' on odd and even sides
    equals the port's ConvTranspose (torch k=4, s=2, padding=1) with the
    kernel flipped by ``from_jax``."""
    x = np.random.default_rng(3).standard_normal((2,) + hw + (3,)).astype(
        np.float32)
    jm = nn.ConvTranspose(5, (4, 4), strides=(2, 2))
    tree = flax_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                    x)), 4)
    want = np.asarray(jm.apply(tree, x))
    tm = td.ConvTranspose(3, 5, torch.float32)
    from_jax.load_flax_params(tm, tree)
    with torch.no_grad():
        got = td.to_cl(tm(td.to_cf(torch.from_numpy(x)))).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 5)
    np.testing.assert_allclose(got, want, atol=1e-5)


@torch.no_grad()
def test_conv_transpose_mapped_as_conv_fails():
    """Without the module, a ConvTranspose kernel is read as a Conv kernel:
    the square ``vae.d3`` loads without an error and decodes wrong, and the
    non-square ``vae.d1`` does not load at all."""
    cfg = jd.DIFFUSION_TINY
    jm = jd.VideoInpainter(cfg)
    f = jnp.zeros((1, 16, 16, 3))
    tree = flax_like(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), f, f[..., 0])), 5)
    z = np.random.default_rng(6).standard_normal((1, 2, 2, 4)).astype(
        np.float32)
    want = np.asarray(_apply(jm, jm.decode)(tree, z))
    tm = td.VideoInpainter(port_cfg(cfg))
    good = from_jax.flax_to_state_dict(tree, tm)
    blind = from_jax.flax_to_state_dict(tree)
    assert blind["vae.d3.weight"].shape == good["vae.d3.weight"].shape
    with pytest.raises(RuntimeError, match="size mismatch"):
        tm.load_state_dict(blind, strict=True)
    blind.update({k: good[k] for k in good if not k.startswith("vae.d3.")})
    tm.load_state_dict(blind, strict=True)
    err = np.abs(tm.decode(torch.from_numpy(z)).numpy() - want).max()
    assert err > 1e-2, err
    tm.load_state_dict(good, strict=True)
    assert_rel(tm.decode(torch.from_numpy(z)).numpy(), want, 1e-5)


def test_attention_leaves_map_to_linear_layout():
    """MultiHeadDotProductAttention's DenseGeneral leaves: q/k/v (C, heads,
    hd) -> (heads*hd, C), out (heads, hd, C) -> (C, heads*hd), biases
    flattened; the mapped layer equals flax's."""
    x = np.random.default_rng(8).standard_normal((2, 7, 64)).astype(
        np.float32)
    jm = nn.MultiHeadDotProductAttention(num_heads=2)
    tree = flax_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                    x, x)), 9)
    sd = from_jax.flax_to_state_dict(tree)
    assert sd["query.weight"].shape == (64, 64)
    np.testing.assert_array_equal(
        sd["out.weight"].numpy(),
        tree["params"]["out"]["kernel"].reshape(64, 64).T)
    np.testing.assert_array_equal(
        sd["key.weight"].numpy(),
        tree["params"]["key"]["kernel"].reshape(64, 64).T)
    assert sd["value.bias"].shape == (64,)
    tm = td.MultiHeadAttention(64, 2, torch.float32)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert_rel(got, np.asarray(jm.apply(tree, x, x)), 1e-5)


@pytest.mark.parametrize("size,out", [((3, 5), (5, 9)), ((4, 4), (7, 8)),
                                      ((6, 7), (12, 14))])
def test_resize_nearest_matches_jax(size, out):
    x = np.random.default_rng(10).standard_normal((2, 3) + size).astype(
        np.float32)
    want = np.asarray(jax.image.resize(x, (2, 3) + out, "nearest"))
    got = td.resize_nearest(torch.from_numpy(x), out).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [6, 7, 8, 13])
def test_stride2_same_conv_matches_flax(size):
    """A stride-2 3x3 'SAME' conv pads (0, 1) on an even side and (1, 1) on
    an odd one, like lax."""
    x = np.random.default_rng(11).standard_normal((2, size, size + 1,
                                                   4)).astype(np.float32)
    jm = nn.Conv(6, (3, 3), strides=(2, 2))
    tree = flax_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                    x)), 12)
    tm = td.Conv(4, 6, 3, torch.float32, stride=2)
    from_jax.load_flax_params(tm, tree)
    with torch.no_grad():
        got = td.to_cl(tm(td.to_cf(torch.from_numpy(x)))).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(tree, x)),
                               atol=1e-5)


def test_seeded_weights_are_drawn_on_the_generator():
    """init_weights: the same seed gives the same weights; LeCun-normal
    scale, unit norm scales, zero biases."""
    def draw(seed):
        m = td.VideoInpainter(td.DIFFUSION_TINY)
        return td.init_weights(m, torch.Generator().manual_seed(seed))
    a, b, c = draw(0), draw(0), draw(1)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
        if va.ndim >= 2:
            assert not torch.equal(va, vc), k
    w = a.unet.down1_res.c1.weight
    assert abs(float(w.std()) * (w[0].numel() ** 0.5) - 1.0) < 0.05
    assert torch.all(a.unet.down1_res.n1.weight == 1)
    assert torch.all(a.unet.down1_res.c1.bias == 0)
