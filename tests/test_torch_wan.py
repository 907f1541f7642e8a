"""The port's Wan models (``models/wan.py``) against the JAX package's Flax
models at WAN_TINY in float32, with parameters drawn like ``model.init``'s
from its shapes (perturbed so biases and norms leave their trivial values)
carried across by ``models.from_jax``.

Tolerance: 1e-4 of the largest output magnitude for the VAE, the DiT and
the sampler (measured ~1e-6: sums in other orders); the RoPE tables 1e-6
absolute; the timestep embedding 1e-4 absolute (XLA's and PyTorch's
float32 exp differ by an ulp in the frequencies, and angles up to 1000 rad
carry that ulp into cos and sin: measured 2.9e-5); the mask latent and
frame arithmetic exact. The streamed VAE is held against the JAX package's
FULL-video call over the segmentations of ``tests/test_wan_stream.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import wan as jw
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import wan as tw
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import init_like

REL = 1e-4
JCFG, TCFG = jw.WAN_TINY, tw.WAN_TINY


def init(model, seed, *inputs):
    """Flax-init-like parameters, perturbed (``port_helpers``)."""
    return init_like(model, seed, *inputs)


def assert_close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    err = np.abs(got - want).max() / scale
    assert err <= rel, err


def torch_model(cls, cfg, params):
    return from_jax.load_flax_params(cls(cfg), params).eval()


@pytest.fixture(scope="module")
def encoder():
    x = np.random.default_rng(0).uniform(-1, 1, (1, 37, 16, 32, 3)) \
        .astype(np.float32)          # 37 frames -> 10 latents
    enc = jw.WanVAEEncoder(JCFG.vae)
    params = init(enc, 0, jnp.asarray(x))
    want = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(x)))
    return x, want, torch_model(tw.WanVAEEncoder, TCFG.vae, params)


@pytest.fixture(scope="module")
def decoder():
    z = np.random.default_rng(1).standard_normal((1, 9, 2, 4, 16)) \
        .astype(np.float32)
    dec = jw.WanVAEDecoder(JCFG.vae)
    params = init(dec, 1, jnp.asarray(z))
    want = np.asarray(jax.jit(dec.apply)(params, jnp.asarray(z)))
    return z, want, torch_model(tw.WanVAEDecoder, TCFG.vae, params)


def stream(model, x, segs):
    cache, outs, s = None, [], 0
    with torch.no_grad():
        for n in segs:
            y, cache = model.stream(torch.from_numpy(x[:, s:s + n]), cache)
            outs.append(y)
            s += n
    return torch.cat(outs, dim=1).numpy()


@pytest.mark.parametrize("segs", [(37,), (12, 12, 13),
                                  (4, 4, 4, 4, 4, 4, 4, 4, 5), (36, 1)],
                         ids=str)
def test_encoder_matches_flax(encoder, segs):
    x, want, model = encoder
    assert want.shape == (1, 10, 2, 4, 16)
    assert_close(stream(model, x, segs), want)


@pytest.mark.parametrize("segs", [(9,), (3, 3, 3), (1,) * 9, (4, 5)],
                         ids=str)
def test_decoder_matches_flax(decoder, segs):
    z, want, model = decoder
    assert want.shape == (1, 33, 16, 32, 3)
    assert_close(stream(model, z, segs), want)


def test_full_call_equals_stream(encoder, decoder):
    x, _, enc = encoder
    z, _, dec = decoder
    with torch.no_grad():
        np.testing.assert_array_equal(enc(torch.from_numpy(x)).numpy(),
                                      stream(enc, x, (37,)))
        np.testing.assert_array_equal(dec(torch.from_numpy(z)).numpy(),
                                      stream(dec, z, (9,)))


@pytest.mark.parametrize("hd,t,h,w", [(128, 12, 30, 52), (12, 6, 2, 4),
                                      (64, 3, 5, 7)])
def test_rope_3d_matches(hd, t, h, w):
    jc, js = jw.rope_3d(hd, t, h, w)
    tc, ts = tw.rope_3d(hd, t, h, w)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


def test_apply_rope_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 60, 2, 12)).astype(np.float32)
    cos, sin = jw.rope_3d(12, 3, 4, 5)
    want = np.asarray(jw._apply_rope(jnp.asarray(x), cos, sin))
    got = tw._apply_rope(torch.from_numpy(x), *tw.rope_3d(12, 3, 4, 5))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_timestep_embedding_matches():
    t = np.random.default_rng(3).uniform(0, 1, (2, 6)).astype(np.float32)
    for dim in (32, 256):
        want = np.asarray(jw.timestep_embedding(jnp.asarray(t), dim))
        got = tw.timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_mask_to_latent_matches():
    m = (np.random.default_rng(4).random((21, 32, 64)) > 0.9) \
        .astype(np.float32)
    want = np.asarray(jw.mask_to_latent(jnp.asarray(m), 6, 4, 8))
    got = tw.mask_to_latent(torch.from_numpy(m), 6, 4, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_frame_arithmetic_matches():
    for t in list(range(1, 60)) + [225, 224, 40]:
        assert tw.latent_frames(t) == jw.latent_frames(t)
        for bf in (1, 3):
            assert tw.pad_to_valid_t(t, bf) == jw.pad_to_valid_t(t, bf)
    assert tw.pad_to_valid_t(40) == 45 and tw.pad_to_valid_t(225) == 225


@pytest.fixture(scope="module")
def dit():
    """WanDiT at T_lat = 6 (2 causal blocks), latents 4x8."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 6, 4, 8, 16)).astype(np.float32)
    tf = rng.uniform(0, 1, (1, 6)).astype(np.float32)
    cond = rng.standard_normal((1, 6, 4, 8, 36)).astype(np.float32)
    model = jw.WanDiT(JCFG)
    params = init(model, 5, x, tf, cond, None)
    return (model, params, (x, tf, cond),
            torch_model(tw.WanDiT, TCFG, params))


def test_dit_forward_matches_flax(dit):
    model, params, (x, tf, cond), tm = dit
    want = np.asarray(jax.jit(model.apply)(params, x, tf, cond, None))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, tf, cond)))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), want)


def test_sampler_matches_flax_host_loop(dit):
    """sample_causal from the same noise as a host loop of the JAX
    package's make_sample_step (2 blocks x 4 steps)."""
    model, params, (x, _, cond), tm = dit
    noise = np.random.default_rng(6).standard_normal(x.shape) \
        .astype(np.float32)
    step = jw.make_sample_step(
        lambda p, xx, tf, c, ctx: model.apply(p, xx, tf, c, ctx), JCFG, 1, 6)
    want = jnp.asarray(noise)
    for si in range(2 * len(JCFG.denoise_steps)):
        want = step(params, want, jnp.asarray(cond), None, jnp.int32(si))
    got = tw.sample_causal(tm, torch.from_numpy(cond), TCFG,
                           torch.from_numpy(noise))
    assert_close(got.numpy(), np.asarray(want))


def test_sampler_rejects_partial_block(dit):
    *_, tm = dit
    with pytest.raises(ValueError, match="block size"):
        tw.sample_causal(tm, torch.zeros(1, 5, 4, 8, 36), TCFG,
                         torch.zeros(1, 5, 4, 8, 16))


def test_from_jax_conv3d_layout():
    params = {"params": {"c": {"kernel": np.arange(2 * 3 * 3 * 4 * 5.0)
                               .reshape(2, 3, 3, 4, 5)}}}
    sd = from_jax.flax_to_state_dict(params)
    assert sd["c.weight"].shape == (5, 4, 2, 3, 3)
    assert sd["c.weight"][4, 3, 1, 2, 0] == params["params"]["c"][
        "kernel"][1, 2, 0, 3, 4]


def test_seeded_weights_are_finite_and_reproducible():
    a = tw.init_weights(tw.WanDiT(TCFG), torch.Generator().manual_seed(7))
    b = tw.init_weights(tw.WanDiT(TCFG), torch.Generator().manual_seed(7))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert float(a.block0.modulation.detach().std()) == pytest.approx(0.02, rel=0.2)
    with torch.no_grad():
        y = a(torch.zeros(1, 3, 4, 8, 16), torch.ones(1, 3),
              torch.zeros(1, 3, 4, 8, 36))
    assert torch.isfinite(y).all()
