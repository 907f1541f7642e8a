"""The port's weight-exact StereoCrafter graph (``models/svd.py``) and CLIP
vision tower (``models/clip.py``) against the JAX package at SVD_TINY,
SVD_VAE_TINY and CLIP_TINY, each on one shared parameter tree (drawn with
numpy from ``jax.eval_shape``), every Flax ``apply`` jitted once.

Tolerance: 1e-5 of the largest output for every module (float32 sums in
other orders; measured <= 3e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import clip as jc
from metric_depth_video_toolbox_tpu.models import svd as js
from metric_depth_video_toolbox_tpu_torch.models import clip as tc
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import svd as ts
from port_helpers import _one_torch_thread  # noqa: F401
from test_torch_diffusion import assert_rel, flax_like

T, HW = 3, (32, 48)


def _apply(jm, method):
    return jax.jit(lambda p, *a: jm.apply(p, *a, method=method))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "mono"])
def inpainters(request):
    """(mono, JAX SVDInpainter at SVD_TINY / SVD_VAE_TINY, its tree, the
    port's on the same tree)."""
    mono = request.param
    jm = js.SVDInpainter(js.SVD_TINY, js.SVD_VAE_TINY)
    f = jnp.zeros((T,) + HW + (3,))
    tree = flax_like(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), f, f[..., 0], mono=f if mono else None)), 20)
    tm = ts.SVDInpainter(ts.SVD_TINY, ts.SVD_VAE_TINY, mono=mono)
    from_jax.load_flax_params(tm, tree)
    return mono, jm, tree, tm.eval()


@torch.no_grad()
def test_vae_encoder_and_decoder_match_flax(inpainters):
    _, jm, tree, tm = inpainters
    x = np.random.default_rng(21).random((T,) + HW + (3,)).astype(
        np.float32)
    z = np.asarray(_apply(jm, jm.encode)(tree, x))
    assert_rel(tm.encode(torch.from_numpy(x)).numpy(), z, 1e-5)
    # the raw temporal decoder and the clipped [0, 1] decode
    enc, dec = js.SVDVAEEncoder(js.SVD_VAE_TINY), js.SVDVAEDecoder(
        js.SVD_VAE_TINY)
    xe = 2 * x - 1
    assert_rel(tm.vae_encoder(torch.from_numpy(xe)).numpy(),
               jax.jit(enc.apply)({"params": tree["params"]["vae_encoder"]},
                                  xe), 1e-5)
    raw = np.asarray(jax.jit(dec.apply)(
        {"params": tree["params"]["vae_decoder"]}, z))
    assert_rel(tm.vae_decoder(torch.from_numpy(z)).numpy(), raw, 1e-5)
    y = np.asarray(_apply(jm, jm.decode)(tree, z))
    assert_rel(tm.decode(torch.from_numpy(z)).numpy(), y, 1e-5)


@torch.no_grad()
def test_unet_and_denoiser_match_flax(inpainters):
    """The raw SVDUNet on a CLIP-like context and its EDM wrapper
    (svd_denoise / SVDInpainter.denoise, with and without a context)."""
    mono, jm, tree, tm = inpainters
    rng = np.random.default_rng(22)
    lat = (T, HW[0] // 2, HW[1] // 2, 4)
    cin = 9 + (4 if mono else 0)
    x = rng.standard_normal(lat[:3] + (cin,)).astype(np.float32)
    ctx = rng.standard_normal((1, 1, 16)).astype(np.float32)
    ids = np.asarray([6.0, 127.0, 0.02], np.float32)
    uapply = jax.jit(js.SVDUNet(js.SVD_TINY).apply)
    uparams = {"params": tree["params"]["unet"]}
    want = np.asarray(uapply(uparams, x, jnp.float32(0.3), ctx, ids))
    got = tm.unet(torch.from_numpy(x), torch.tensor(0.3),
                  torch.from_numpy(ctx), torch.from_numpy(ids))
    assert_rel(got.numpy(), want, 1e-5)
    z = rng.standard_normal(lat).astype(np.float32)
    cond = x[..., 4:]
    want = np.asarray(js.svd_denoise(uapply, uparams, z, jnp.float32(2.0),
                                     ctx, ids, cond))
    got = ts.svd_denoise(tm.unet, torch.from_numpy(z), 2.0,
                         torch.from_numpy(ctx), torch.from_numpy(ids),
                         torch.from_numpy(cond))
    assert_rel(got.numpy(), want, 1e-5)
    den = jax.jit(lambda p, zz, s, c, cx: jm.apply(
        p, zz, s, c, cx, method=jm.denoise))
    # the JAX default context is zeros: one trace for both cases
    for sigma, context in ((700.0, None), (0.5, ctx)):
        want = np.asarray(den(tree, z, jnp.float32(sigma), cond,
                              np.zeros_like(ctx) if context is None
                              else context))
        got = tm.denoise(torch.from_numpy(z), torch.tensor(sigma),
                         torch.from_numpy(cond),
                         None if context is None else torch.from_numpy(ctx))
        assert_rel(got.numpy(), want, 1e-5)


def test_timesteps_embed_matches():
    t = np.asarray([0.0, 0.25, 3.0, 127.0], np.float32)
    for dim, flip in ((8, True), (7, True), (6, False)):
        want = np.asarray(js.timesteps_embed(jnp.asarray(t), dim, flip))
        got = ts.timesteps_embed(torch.from_numpy(t), dim, flip).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
@torch.no_grad()
def test_clip_tower_and_preprocess_match_flax(act):
    jcfg = dataclasses.replace(jc.CLIP_TINY, hidden_act=act)
    tcfg = dataclasses.replace(tc.CLIP_TINY, hidden_act=act)
    jm = jc.CLIPVisionTower(jcfg)
    tree = flax_like(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))), 23)
    tm = tc.CLIPVisionTower(tcfg)
    from_jax.load_flax_params(tm, tree)
    img = np.random.default_rng(24).random((2, 40, 56, 3)).astype(
        np.float32)
    pre = np.asarray(jc.preprocess(jnp.asarray(img), 32))
    assert_rel(tc.preprocess(torch.from_numpy(img), 32).numpy(), pre, 1e-5)
    want = np.asarray(jax.jit(jm.apply)(tree, pre))
    assert_rel(tm(torch.from_numpy(pre)).numpy(), want, 1e-5)
