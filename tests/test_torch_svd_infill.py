"""The port's SVD-class infill engine and the code around it
(``pipeline/infill_diffusion.py``: ``DiffusionInfillEngine``, the halo
blend, ``make_engine``'s stereocrafter / m2svid presets, the external
hook; ``cli/infill.py``) against the JAX package.

Tolerances: the engine's sampled latents, fed the JAX engine's noise, within
1e-4 of the largest latent (measured <= 2e-6); uint8 frames within
``assert_u8_budget`` (at most 1 LSB on at most 0.5% of bytes: float32 sums
in other orders can flip the truncation of ``x * 255``); every pixel outside
the holes unchanged; the chunk loop with the halo blend within
``assert_u8_budget`` (the blend rounds a float32 blur); the presets and the
external hook's argv and output exact.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import clip as jc
from metric_depth_video_toolbox_tpu.models import diffusion as jd
from metric_depth_video_toolbox_tpu.models import svd as js
from metric_depth_video_toolbox_tpu.pipeline import infill_diffusion as jid
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import clip as tc
from metric_depth_video_toolbox_tpu_torch.models import diffusion as td
from metric_depth_video_toolbox_tpu_torch.models import svd as ts
from metric_depth_video_toolbox_tpu_torch.pipeline import \
    infill_diffusion as tid
from port_helpers import _one_torch_thread  # noqa: F401
from test_torch_diffusion import flax_like, port_cfg
from test_torch_infill_engine import _FakeEngine, textured
from test_torch_stereo import assert_u8_budget

WORK, T = (32, 48), 5
# name -> (JAX cfg, port cfg, mono conditioning, SVD graph with CLIP)
CASES = {"tiny": (jd.DIFFUSION_TINY, td.DIFFUSION_TINY, False, False),
         "tiny_mono": (jd.DIFFUSION_TINY, td.DIFFUSION_TINY, True, False),
         "svd_clip": (js.SVD_TINY, ts.SVD_TINY, False, True)}


@pytest.fixture(scope="module", params=sorted(CASES))
def engines(request):
    """A JAX DiffusionInfillEngine on a numpy-drawn tree, and the port's on
    the CPU with the same trees (inpainter and CLIP tower)."""
    jcfg, tcfg, mono, svd = CASES[request.param]
    f = jnp.zeros((T,) + WORK + (3,))
    jkw, tkw = {}, {}
    if svd:
        jm = js.SVDInpainter(jcfg, js.SVD_VAE_TINY)
        cm = jc.CLIPVisionTower(jc.CLIP_TINY)
        clip_tree = flax_like(jax.eval_shape(lambda: cm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))), 31)
        jkw = dict(vae_cfg=js.SVD_VAE_TINY, clip_params=clip_tree,
                   clip_cfg=jc.CLIP_TINY)
        tkw = dict(vae_cfg=ts.SVD_VAE_TINY, clip_params=clip_tree,
                   clip_cfg=tc.CLIP_TINY)
    else:
        jm = jd.VideoInpainter(jcfg)
    tree = flax_like(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), f, f[..., 0], mono=f if mono else None)), 30)
    je = jid.DiffusionInfillEngine(cfg=jcfg, params=tree, work_hw=WORK,
                                   chunk=T, mono_conditioning=mono,
                                   data_parallel=False, **jkw)
    te = tid.DiffusionInfillEngine(cfg=tcfg, params=tree, work_hw=WORK,
                                   chunk=T, mono_conditioning=mono,
                                   device="cpu", **tkw)
    return request.param, je, te


def chunk_inputs(seed, t=T, h=40, w=72):
    rng = np.random.default_rng(seed)
    frames = np.stack([textured(rng, h, w)[:h, :w] for _ in range(t)])
    hole = np.zeros((t, h, w), bool)
    hole[:, 10:25, 20:40] = True
    hole[2:, 30:36, 50:70] = True
    mono = np.stack([textured(rng, h, w)[:h, :w] for _ in range(t)])
    return frames, hole, mono


def test_infill_chunk_matches_jax(engines, monkeypatch):
    """One chunk through both engines with the JAX engine's noise: the
    sampled latents and the uint8 frames."""
    name, je, te = engines
    frames, hole, mono = chunk_inputs(40)
    mono = mono if je.mono_conditioning else None
    seen = []

    def sample(*a, **k):   # the JAX engine's latents, out of its jit
        z = orig(*a, **k)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), z)
        return z
    orig = jd.sample
    monkeypatch.setattr(jd, "sample", sample)
    te._ensure()
    with torch.no_grad():
        lat = tuple(te.model.encode(torch.zeros((T,) + WORK + (3,))).shape)
    _, sub = jax.random.split(je._rng)
    noise = np.array(jax.random.normal(sub, lat, jnp.float32))
    want = np.asarray(je.infill_chunk(frames, hole, mono))
    got_z = []
    te.on_latents = got_z.append
    try:
        got = te.infill_chunk(frames, hole, mono,
                              noise=torch.from_numpy(noise))
    finally:
        te.on_latents = None
    zw, zg = seen[-1], got_z[0].numpy()
    assert zg.shape == zw.shape == lat
    assert np.abs(zg - zw).max() <= 1e-4 * np.abs(zw).max()
    assert_u8_budget(got, want)
    np.testing.assert_array_equal(got[~hole], frames[~hole])
    assert (got[hole] != frames[hole]).mean() > 0.5
    assert (te.clip is not None) == name.startswith("svd")


def test_seeded_engine_draws_its_noise_and_weights(engines):
    """Without weights or noise the engine draws both from its generator:
    two engines of one seed give the same frames, the pixels outside the
    holes unchanged; its parameter count is the Flax tree's."""
    name, je, _ = engines
    jcfg, tcfg, mono, svd = CASES[name]
    kw = dict(vae_cfg=ts.SVD_VAE_TINY) if svd else {}
    frames, hole, mono_f = chunk_inputs(41)
    outs = []
    for _ in range(2):
        eng = tid.DiffusionInfillEngine(cfg=tcfg, work_hw=WORK, chunk=T,
                                        mono_conditioning=mono, rng_seed=3,
                                        device="cpu", **kw)
        outs.append(eng.infill_chunk(frames, hole, mono_f))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0][~hole], frames[~hole])
    assert eng.num_parameters() == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda: (js.SVDInpainter(jcfg, js.SVD_VAE_TINY)
                                    if svd else jd.VideoInpainter(jcfg)
                                    ).init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 16, 16, 3)),
                                           jnp.zeros((1, 16, 16)),
                                           mono=jnp.zeros((1, 16, 16, 3))
                                           if mono else None))))


def _sbs_files(tmp_path, t=12, h=48, w=64):
    """An SBS clip, an infill mask whose holes carry encoded normals, and a
    mono clip, as files."""
    rng = np.random.default_rng(42)
    sbs = np.stack([np.concatenate([textured(rng, h, w)[:h, :w]] * 2, 1)
                    for _ in range(t)])
    mask = np.zeros((t, h, 2 * w, 3), np.uint8)
    mask[:, 8:20, 10:24] = (200, 60, 128)       # normals pointing down-left
    mask[:, 30:40, 70:90] = (40, 230, 128)
    mono = np.stack([textured(rng, h, w)[:h, :w] for _ in range(t)])
    paths = {k: str(tmp_path / f"{k}.mkv") for k in ("sbs", "mask", "mono")}
    for k, arr in (("sbs", sbs), ("mask", mask), ("mono", mono)):
        tvio.save_rgb_video(arr, paths[k], 24)
    return paths, sbs, mask


def test_sbs_loop_with_halo_blend_matches_jax(tmp_path):
    """The chunk loop with the halo blend, file to file, both packages on
    the same deterministic engine; the blend changes frames."""
    paths, sbs, mask = _sbs_files(tmp_path)
    out_j = jid.infill_sbs_video_diffusion(
        paths["sbs"], paths["mask"], output=str(tmp_path / "j.mkv"),
        color_video=paths["mono"], engine=_FakeEngine(),
        apply_edge_blending=True)
    out_t = tid.infill_sbs_video_diffusion(
        paths["sbs"], paths["mask"], output=str(tmp_path / "t.mkv"),
        color_video=paths["mono"], engine=_FakeEngine(),
        apply_edge_blending=True)
    with tvio.VideoReader(out_j) as r:
        want = r.read_all()
    with tvio.VideoReader(out_t) as r:
        got = r.read_all()
    assert_u8_budget(got, want)
    plain = tid.infill_sbs_frames(sbs, np.any(mask != 0, -1), _FakeEngine(),
                                  mono=None)
    assert (got != plain).any()
    with pytest.raises(ValueError, match="masks_rgb"):
        tid.infill_sbs_frames(sbs, np.any(mask != 0, -1), _FakeEngine(),
                              apply_edge_blending=True)


@pytest.mark.parametrize("preset", ["stereocrafter", "m2svid"])
def test_make_engine_svd_presets_match_jax(preset):
    jeng, jdrv = jid.make_engine(preset)
    eng, drv = tid.make_engine(preset, device="cpu")
    assert drv == jdrv
    assert isinstance(eng, tid.DiffusionInfillEngine)
    assert (eng.chunk, eng.overlap, eng.work_hw, eng.mono_conditioning) == (
        jeng.chunk, jeng.overlap, tuple(jeng.work_hw),
        jeng.mono_conditioning)
    assert eng.cfg == port_cfg(jeng.cfg) == td.DIFFUSION_TINY
    eng, _ = tid.make_engine(preset, cfg=ts.SVD_TINY, device="cpu",
                             vae_cfg=ts.SVD_VAE_TINY)
    eng._ensure()
    assert isinstance(eng.model, ts.SVDInpainter)
    assert eng.model.unet.conv_in.in_channels == 9 + 4 * (
        preset == "m2svid")


_EXTERNAL = r"""
import json, shutil, sys
args = sys.argv[1:]
if "--fail" in args:
    sys.stderr.write("engine refused")
    sys.exit(3)
out = args[args.index("--output") + 1]
shutil.copyfile(args[args.index("--sbs_color_video") + 1], out)
with open(out + ".argv.json", "w") as f:
    json.dump(args, f)
"""


def test_external_hook_matches_jax(tmp_path):
    """Both packages run the same small command with the same argv; it
    writes the output; a failing command raises with its stderr."""
    script = tmp_path / "engine.py"
    script.write_text(_EXTERNAL)
    sbs, mask, mono = (str(tmp_path / n) for n in ("s.mkv", "m.mkv",
                                                   "c.mkv"))
    (tmp_path / "s.mkv").write_bytes(b"sbs bytes")
    cmd = [sys.executable, str(script), "--flag"]
    argvs = []
    for mod, name in ((jid, "j.mkv"), (tid, "t.mkv")):
        out = mod.infill_sbs_video_external(sbs, mask, cmd,
                                            output=str(tmp_path / name),
                                            color_video=mono)
        assert out == str(tmp_path / name)
        assert (tmp_path / name).read_bytes() == b"sbs bytes"
        argv = json.loads((tmp_path / (name + ".argv.json")).read_text())
        argvs.append([a if a != out else "OUT" for a in argv])
    assert argvs[0] == argvs[1] == [
        "--flag", "--sbs_color_video", sbs, "--sbs_mask_video", mask,
        "--output", "OUT", "--color_video", mono]
    assert tid.infill_sbs_video_external(sbs, mask, cmd) == \
        sbs + "_infilled.mkv"
    for mod in (jid, tid):
        with pytest.raises(RuntimeError, match="engine refused"):
            mod.infill_sbs_video_external(sbs, mask, cmd + ["--fail"])
