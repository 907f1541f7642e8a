"""The port's causal infill path (``pipeline/infill_diffusion.py``,
``ops/drift.py``, ``ops/infill.py``, ``ops/image.py::bilinear_sample``,
``cli/infill.py``) against the JAX package at WAN_TINY, work_hw (32, 64).

Tolerances: bilinear_sample 1e-5 absolute on [0, 255] data (measured 0);
lhm_color_transfer 1e-3 absolute on [0, 255] data (3x3 eigendecompositions
and sums over the frame in other orders: measured 1.5e-4); drift
correction, the mask resize and the SBS chunk loop exact (uint8);
``infill_chunk`` against the JAX engine with the same parameters and the
JAX engine's own noise: uint8 within 1 LSB on at most 0.5% of bytes
(float32 sums in other orders can flip the truncation of ``x * 255``;
measured 0), every pixel outside the holes unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.cli import infill as jcli
from metric_depth_video_toolbox_tpu.models import wan as jw
from metric_depth_video_toolbox_tpu.ops import drift as jdrift
from metric_depth_video_toolbox_tpu.ops import image as jim
from metric_depth_video_toolbox_tpu.ops import infill as jinfill
from metric_depth_video_toolbox_tpu.pipeline import infill_diffusion as jid
from metric_depth_video_toolbox_tpu_torch.cli import infill as tcli
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import wan as tw
from metric_depth_video_toolbox_tpu_torch.ops import drift as tdrift
from metric_depth_video_toolbox_tpu_torch.ops import image as tim
from metric_depth_video_toolbox_tpu_torch.ops import infill as tinfill
from metric_depth_video_toolbox_tpu_torch.pipeline import \
    infill_diffusion as tid
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import perturbed_like

WORK = (32, 64)


def textured(rng, h, w):
    base = rng.integers(0, 255, (h // 4 + 2, w // 4 + 2, 3)).astype(np.uint8)
    return np.kron(base, np.ones((4, 4, 1), np.uint8))


def test_bilinear_sample_matches():
    rng = np.random.default_rng(0)
    img = rng.random((20, 30, 3)).astype(np.float32) * 255
    xy = rng.uniform(-3, 33, (25, 17, 2)).astype(np.float32)
    for fill in (0.0, 7.5):
        want = np.asarray(jim.bilinear_sample(jnp.asarray(img),
                                              jnp.asarray(xy), fill=fill))
        got = tim.bilinear_sample(torch.from_numpy(img),
                                  torch.from_numpy(xy), fill=fill)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_lhm_color_transfer_matches():
    rng = np.random.default_rng(1)
    g = rng.random((3, 32, 48, 3)).astype(np.float32) * 255
    r = rng.random((3, 32, 48, 3)).astype(np.float32) * 200 + 20
    w = (rng.random((3, 32, 48)) > 0.3).astype(np.float32)
    want = np.asarray(jax.vmap(jinfill.lhm_color_transfer)(g, r, w))
    got = tinfill.lhm_color_transfer(*(torch.from_numpy(a)
                                       for a in (g, r, w)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    want1 = np.asarray(jinfill.lhm_color_transfer(g[0], r[0]))
    got1 = tinfill.lhm_color_transfer(torch.from_numpy(g[0]),
                                      torch.from_numpy(r[0]))
    np.testing.assert_allclose(got1.numpy(), want1, atol=1e-3)


@pytest.fixture(scope="module")
def drifted():
    """6 frames of a texture, the generated ones shifted by a per-frame
    (dx, dy) and given a patch of noise (outliers in one grid cell)."""
    rng = np.random.default_rng(2)
    tex = textured(rng, 96, 160)
    shifts = [(0, 0), (2, 1), (3, -2), (-1, 2), (1, 1), (4, 0)]
    ref = np.stack([tex[8:72, 8:136]] * 6)
    gen = np.stack([tex[8 - dy:72 - dy, 8 - dx:136 - dx]
                    for dx, dy in shifts]).copy()
    gen[2, 5:20, 10:30] = rng.integers(0, 255, (15, 20, 3))
    return gen, ref


def test_phase_correlation_grid_matches(drifted):
    gen, ref = drifted
    for i in range(len(gen)):
        ws, wp = jdrift.phase_correlation_grid(jnp.asarray(ref[i]),
                                               jnp.asarray(gen[i]))
        ts, tp = tdrift.phase_correlation_grid(torch.from_numpy(ref[i]),
                                               torch.from_numpy(gen[i]))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(ws))
        np.testing.assert_allclose(tp.numpy(), np.asarray(wp), atol=1e-4)
        wf, wok = jdrift.robust_flow_field(ws, wp)
        tf, tok = tdrift.robust_flow_field(ts, tp)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(wf))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(wok))


def test_drift_correct_matches(drifted):
    gen, ref = drifted
    want = jdrift.drift_correct_video(gen, ref)
    got = tdrift.drift_correct_video(gen, ref)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, gen)
    want1 = np.asarray(jdrift.drift_correct_frame(jnp.asarray(gen[1]),
                                                  jnp.asarray(ref[1])))
    got1 = tdrift.drift_correct_frame(torch.from_numpy(gen[1]),
                                      torch.from_numpy(ref[1]))
    np.testing.assert_array_equal(got1.numpy(), want1)


def test_resize_mask_matches_jax_nearest():
    """The engine's hole-mask resize, 1080x960 eye -> 480x832 and 1080x1920
    -> 480x832: equal to jax.image.resize 'nearest' (torch's 'nearest'
    mode differs on many pixels)."""
    rng = np.random.default_rng(3)
    for hw in ((1080, 960), (1080, 1920)):
        m = rng.random((2,) + hw) > 0.8
        want = np.asarray(jax.image.resize(jnp.asarray(m, jnp.float32),
                                           (2, 480, 832), "nearest"))
        got = tid.resize_mask(torch.from_numpy(m), (480, 832)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def engines():
    """A JAX CausalInfillEngine at WAN_TINY with perturbed parameters (drawn
    like its ``_ensure``'s ``init`` trees, from their shapes), and the
    port's engine on the CPU with the same parameters."""
    je = jid.CausalInfillEngine(cfg=jw.WAN_TINY, work_hw=WORK, chunk=9)
    key = jax.random.PRNGKey(0)
    f = jnp.zeros((1, je._t_pad(5)) + WORK + (3,))
    enc = jax.eval_shape(je.enc.init, key, f)
    z = jax.eval_shape(je.enc.apply, enc, f)
    tl, lh, lw = z.shape[1:4]
    shapes = {
        "enc": enc,
        "dec": jax.eval_shape(je.dec.init, key,
                              jnp.zeros(z.shape, jnp.float32)),
        "dit": jax.eval_shape(
            je.model.init, key, jnp.zeros((1, tl, lh, lw, je.cfg.z_ch)),
            jnp.zeros((1, tl)), jnp.zeros((1, tl, lh, lw, je.cfg.cond_ch)),
            None)}
    params = {name: perturbed_like(tree, 10 + i)
              for i, (name, tree) in enumerate(sorted(shapes.items()))}
    je._params = params
    te = tid.CausalInfillEngine(
        cfg=tw.WAN_TINY, work_hw=WORK, chunk=9, device="cpu",
        params={k: from_jax.flax_to_state_dict(v)
                for k, v in params.items()})
    return je, te


def chunk_inputs(seed, t=9, h=40, w=72):
    rng = np.random.default_rng(seed)
    frames = np.stack([textured(rng, h, w)[:h, :w] for _ in range(t)])
    hole = np.zeros((t, h, w), bool)
    hole[:, 10:25, 20:40] = True
    hole[3:, 30:36, 50:70] = True
    mono = np.stack([textured(rng, h, w)[:h, :w] for _ in range(t)])
    return frames, hole, mono


def jax_noise(je, t):
    """The noise the JAX engine's next infill_chunk draws."""
    _, sub = jax.random.split(je._rng)
    tl = jw.latent_frames(je._t_pad(t))
    lh, lw = WORK[0] // 8, WORK[1] // 8
    return np.array(jax.random.normal(sub, (1, tl, lh, lw, 16),
                                      jnp.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_infill_chunk_matches_jax(engines, seed):
    je, te = engines
    frames, hole, mono = chunk_inputs(seed)
    noise = jax_noise(je, 9)
    want = je.infill_chunk(frames, hole, mono)
    got = te.infill_chunk(frames, hole, mono, noise=torch.from_numpy(noise))
    assert got.shape == frames.shape and got.dtype == np.uint8
    off = np.abs(got.astype(int) - want.astype(int))
    assert off.max() <= 1 and (off > 0).mean() <= 0.005, \
        (off.max(), (off > 0).mean())
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    assert (got[hole] != frames[hole]).mean() > 0.5


def test_ref_latent_cached_between_eyes(engines):
    _, te = engines
    frames, hole, mono = chunk_inputs(2)
    te.infill_chunk(frames, hole, mono)
    cached = te._ref_cache[1]
    te.infill_chunk(frames[:, :, ::-1], hole[:, :, ::-1], mono)
    assert te._ref_cache[1] is cached
    te.clear_cache()
    te.infill_chunk(frames, hole, mono)
    assert te._ref_cache[1] is not cached
    torch.testing.assert_close(te._ref_cache[1], cached, rtol=0, atol=0)


def test_on_latents_sees_each_chunks_latents(engines):
    """The hook gets the sampled latents of every chunk, before decoding:
    (1, T_lat, lh, lw, z_ch), finite."""
    _, te = engines
    frames, hole, mono = chunk_inputs(3)
    seen = []
    te.on_latents = seen.append
    try:
        te.infill_chunk(frames, hole, mono)
        te.infill_chunk(frames[:5], hole[:5], mono[:5])
    finally:
        te.on_latents = None
    assert [tuple(z.shape) for z in seen] == [
        (1, 3, 4, 8, te.cfg.z_ch), (1, 3, 4, 8, te.cfg.z_ch)]
    assert all(bool(torch.isfinite(z).all()) for z in seen)


class _FakeEngine:
    """A deterministic stand-in for the diffusion engine (chunk 5, overlap
    4), so both packages' chunk loops can be compared exactly."""
    chunk, overlap, mono_conditioning = 5, 4, True
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def infill_chunk(self, frames_u8, hole_mask, mono_u8=None):
        self.calls.append(frames_u8.shape[0])
        fill = (frames_u8.astype(np.int32) // 2 + 40
                + (mono_u8.astype(np.int32) // 4 if mono_u8 is not None
                   else 0))
        return np.where(hole_mask[..., None], np.clip(fill, 0, 255),
                        frames_u8).astype(np.uint8)


@pytest.mark.parametrize("mirror_left,drift_correct", [(True, False),
                                                       (False, True)])
def test_sbs_chunk_loop_matches_jax(tmp_path, mirror_left, drift_correct):
    """The port's in-memory chunk loop equals the JAX package's file
    chunk loop on the same frames, holes and source video."""
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    rng = np.random.default_rng(4)
    t, h, w = 12, 48, 64
    sbs = np.stack([np.concatenate([textured(rng, h, w)[:h, :w]] * 2, 1)
                    for _ in range(t)])
    hole = np.zeros((t, h, 2 * w), bool)
    hole[:, 8:20, 10:24] = True
    hole[:, 30:40, 70:90] = True
    mask_rgb = np.repeat(np.where(hole[..., None], np.uint8(200),
                                  np.uint8(0)), 3, axis=-1)
    mono = np.stack([textured(rng, h, w)[:h, :w] for _ in range(t)])
    paths = {k: str(tmp_path / f"{k}.mkv") for k in ("sbs", "mask", "mono")}
    for k, arr in (("sbs", sbs), ("mask", mask_rgb), ("mono", mono)):
        tvio.save_rgb_video(arr, paths[k], 24)
    out = jid.infill_sbs_video_diffusion(
        paths["sbs"], paths["mask"], color_video=paths["mono"],
        engine=_FakeEngine(), mirror_left=mirror_left,
        drift_correct=drift_correct, apply_edge_blending=False)
    with tvio.VideoReader(out) as r:
        want = r.read_all()
    eng = _FakeEngine()
    got = tid.infill_sbs_frames(sbs, hole, eng, mono=mono,
                                mirror_left=mirror_left,
                                drift_correct=drift_correct)
    assert eng.calls == [5] * 16    # 8 chunks of 5 per eye, stride 1
    np.testing.assert_array_equal(got, want)


def test_make_engine_presets():
    eng, drv = tid.make_engine("inspatio_world", cfg=tw.WAN_TINY,
                               device="cpu")
    _, jdrv = jid.make_engine("inspatio_world", cfg=jw.WAN_TINY)
    assert drv == jdrv
    assert (eng.chunk, eng.overlap, eng.work_hw) == (225, 6, (480, 832))
    assert tid.ENGINE_PRESETS == jid.ENGINE_PRESETS
    for preset in ("stereocrafter", "m2svid"):
        eng, drv = tid.make_engine(preset, device="cpu")
        _, jdrv = jid.make_engine(preset)
        assert isinstance(eng, tid.DiffusionInfillEngine) and drv == jdrv


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.nargs, a.type, a.required)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    assert _options(tcli.build_parser()) == _options(jcli.build_parser())


@pytest.mark.parametrize("argv,match", [
    (["--infill_engine", "inspatio_world", "--checkpoint", "x.npz"],
     "converted checkpoint"),
    (["--infill_engine", "diffusion", "--checkpoint", "x.msgpack"], "A5"),
    (["--infill_engine", "stereocrafter", "--model_scale", "svd",
      "--clip_checkpoint", "clip.msgpack"], "A5")])
def test_cli_raises_for_unported(tmp_path, argv, match):
    with pytest.raises(NotImplementedError, match=match):
        tmain.main(["infill", "--sbs_color_video",
                    str(tmp_path / "none.mkv")] + argv)


def _engine_key(eng):
    """What the CLI chose, comparable across the two packages."""
    import dataclasses
    return (type(eng).__name__, eng.chunk, eng.overlap, tuple(eng.work_hw),
            eng.mono_conditioning, type(eng.cfg).__name__,
            dataclasses.asdict(eng.cfg))


@pytest.mark.parametrize("argv", [
    ["--infill_engine", "diffusion"],
    ["--infill_engine", "m2svid"],
    ["--infill_engine", "external", "--external_command", "engine.py",
     "quality=high"],
    ["--infill_engine", "inspatio_world", "--model_scale", "svd"],
    ["--infill_engine", "inspatio_world", "--apply_edge_blending"],
    ["--infill_engine", "stereocrafter", "--model_scale", "svd",
     "--num_inference_steps", "3"],
    ["--infill_engine", "m2svid", "--model_scale", "tiny",
     "--apply_edge_blending", "--color_video", "mono.mkv"]],
    ids=["diffusion", "m2svid", "external", "inspatio_svd", "inspatio_edge",
         "svd_steps", "m2svid_tiny_edge"])
def test_cli_engine_selection(tmp_path, monkeypatch, argv):
    """Both packages' ``infill`` CLIs on the same argv reach the same
    entry point with the same engine (preset, model scale, steps) and
    chunk-loop keyword arguments (the halo blend, the mirror, drift
    correction)."""
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    from metric_depth_video_toolbox_tpu.cli import main as jmain

    seen = {}
    for name, mod in (("jax", jid), ("torch", tid)):
        calls = seen[name] = []

        def diffusion(v, mask, engine=None, calls=calls, **kw):
            calls.append(("diffusion", v, mask, _engine_key(engine), kw))
            return v + "_infilled.mkv"

        def external(v, mask, command, calls=calls, **kw):
            calls.append(("external", v, mask, list(command), kw))
            return v + "_infilled.mkv"
        monkeypatch.setattr(mod, "infill_sbs_video_diffusion", diffusion)
        monkeypatch.setattr(mod, "infill_sbs_video_external", external)
    clip = str(tmp_path / "clip.mkv")
    jmain.main(["infill", "--sbs_color_video", clip] + argv)
    tmain.main(["infill", "--sbs_color_video", clip] + argv)
    assert seen["torch"] == seen["jax"] and len(seen["torch"]) == 1
    kind, _, mask, key, kw = seen["torch"][0]
    assert mask == clip + "_infillmask.mkv"
    if "--apply_edge_blending" in argv:
        assert kw["apply_edge_blending"] is True
    if kind == "diffusion" and "--num_inference_steps" in argv:
        assert key[-1]["num_steps"] == 3


def test_cli_batch_keeps_going_after_a_failed_clip(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    clips = [str(tmp_path / f"c{i}.mkv") for i in range(3)]
    listing = tmp_path / "clips.txt"
    listing.write_text("\n".join(clips) + "\n")

    def external(v, mask, command, **kw):
        if v == clips[1]:
            raise RuntimeError("engine refused")
        return v + "_infilled.mkv"
    monkeypatch.setattr(tid, "infill_sbs_video_external", external)
    outs = tcli.run(tcli.build_parser().parse_args(
        ["--sbs_color_video", str(listing), "--infill_engine", "external",
         "--external_command", "x"]))
    assert outs == [clips[0] + "_infilled.mkv", clips[2] + "_infilled.mkv"]
    assert f"infill FAILED for {clips[1]}: engine refused" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit, match="--external_command required"):
        tmain.main(["infill", "--sbs_color_video", clips[0],
                    "--infill_engine", "external"])


def test_cli_inspatio_engine_scales():
    eng, _ = tcli.make_inspatio_engine("svd", device="cpu")
    assert eng.cfg == tw.WAN_1_3B
    eng, _ = tcli.make_inspatio_engine("tiny", 3, device="cpu")
    assert eng.cfg.dim == tw.WAN_TINY.dim
    np.testing.assert_allclose(eng.cfg.denoise_steps, (1.0, 2 / 3, 1 / 3))
    eng, _ = tcli.make_inspatio_engine("production", device="cpu")
    assert eng.cfg == tw.WAN_1_3B
