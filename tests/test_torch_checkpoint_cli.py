"""Converted checkpoints read from files by the port's commands, against the
JAX package on the same file, on the CPU at tiny sizes; then each reference
behaviour of the JAX package's checkpoint paths, copied by the port and
pinned here.

- ``mdvt-torch depth --checkpoint`` (a ``convert_vda`` tree of an upstream
  Video-Depth-Anything state dict at ``vitt`` widths) against the JAX
  package's VDA run with the same file and flags, both fitted to the same
  reference depth video (float32 end to end): the depth videos' codes
  within one step on 99% of pixels (as the depth engine's tests).
- ``da3 --backbone_checkpoint`` (a ``convert_dinov2_vit`` tree on another
  patch grid): the grafted weights equal the JAX engine's graft (position
  embedding resampled) within 1e-6, and the depth video against the JAX
  package's ``run_da3`` with the same head weights, codes within one step
  on 99% of pixels.
- ``infill --checkpoint`` / ``--clip_checkpoint`` at ``--model_scale svd``
  (``SVD_TINY``, a ``convert_stereocrafter`` tree and a CLIP tower's
  tree) and ``--infill_engine inspatio_world
  --checkpoint`` (``WAN_TINY``, ``{"dit", "enc", "dec"}`` with a
  ``convert_wan`` DiT), the working size cut to 32 x 48: the port's
  command fed the JAX engine's noise, against the JAX engine on the same
  files: uint8 within ``assert_u8_budget`` (1 LSB on at most 0.5% of
  bytes), as the engines' own tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import clip as jclip
from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu.models import dpt as jdpt
from metric_depth_video_toolbox_tpu.models import svd as jsvd
from metric_depth_video_toolbox_tpu.models import video_depth as jvd
from metric_depth_video_toolbox_tpu.models import vit as jvit
from metric_depth_video_toolbox_tpu.models import wan as jwan
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu.pipeline import infill_diffusion as jid
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import clip as tclip
from metric_depth_video_toolbox_tpu_torch.models import convert as tconvert
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import svd as tsvd
from metric_depth_video_toolbox_tpu_torch.models import wan as twan
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from metric_depth_video_toolbox_tpu_torch.pipeline import \
    infill_diffusion as tid
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import perturbed_like
from test_torch_convert import svd_sds, vda_sd, wan_sd
from test_torch_infill_engine import textured
from test_torch_stereo import assert_u8_budget

T, H, W = 10, 48, 64
DEPTH_FLAGS = ["--model_size", "vitt", "--input_size", "42", "--window",
               "8", "--fp32"]
VDA_TINY = jvd.VideoDepthConfig(vit=jvit.VIT_TINY, dpt=jdpt.DPT_TINY,
                                temporal_heads=2, norm_groups=4)
RESIZE_LEAVES = [f"head.resize{i}.{p}" for i in (0, 1, 3)
                 for p in ("bias", "weight")]


def clip_frames(t=T, h=H, w=W, seed=0):
    """A panning textured scene (uint8)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h // 4 + 2, w // 4 + 2 * t, 3), np.uint8)
    tex = np.kron(base, np.ones((4, 4, 1), np.uint8))
    return np.stack([tex[:h, 2 * i:2 * i + w] for i in range(t)])


def codes_close(got_path, want_path, share=0.99):
    with tvio.VideoReader(got_path) as r:
        got = r.read_all().astype(np.int32)
    with tvio.VideoReader(want_path) as r:
        want = r.read_all().astype(np.int32)
    assert got.shape == want.shape
    assert (np.abs(got - want).max(-1) <= 1).mean() >= share
    return got


@pytest.fixture(scope="module")
def vda_file(tmp_path_factory):
    """A ``convert_vda`` tree of an upstream state dict for the 42 x 56
    working grid (3 x 4 patches), written by the JAX package."""
    path = str(tmp_path_factory.mktemp("ckpt") / "vda.msgpack")
    jconvert.save_checkpoint(path, jconvert.convert_vda(vda_sd(12),
                                                        VDA_TINY))
    return path


def test_depth_checkpoint_matches_jax(tmp_path, monkeypatch, vda_file):
    pytest.importorskip("cv2")
    frames = clip_frames()
    ref = np.random.default_rng(1).uniform(2.0, 30.0, (T, H, W)).astype(
        np.float32)
    paths = {k: str(tmp_path / f"{k}.mkv") for k in ("j", "t", "ref")}
    for k in "jt":
        tvio.save_rgb_video(frames, paths[k], 24)
    tvio.save_depth_video(ref, paths["ref"], 24, 100.0)
    # the JAX command's call, its one difference: no frame mesh over the
    # test run's virtual devices
    (want,) = jdepth.run_batch(
        "vda", paths["j"], max_depth=100.0, max_frames=-1, target_fps=-1,
        input_size=42, size="vitt", window=8, fp32=True,
        params=jconvert.load_checkpoint(vda_file), data_parallel=False,
        reference_depth_video=paths["ref"], quantize=None,
        rolling_average=0)
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    tmain.main(["depth", "--color_video", paths["t"], "--depth_video",
                paths["ref"], "--checkpoint", vda_file] + DEPTH_FLAGS)
    got = codes_close(paths["t"] + "_depth.mkv", want)
    assert got.shape == (T, H, W, 3) and got.any()


def test_vda_tree_leaves_ignored_like_flax_apply(vda_file):
    """The JAX engine runs ``DPTConfig()`` (``torch_resize=False``), whose
    Flax ``apply`` ignores the tree's learned resize layers; the port
    ignores exactly those leaves and lists them. A strict load of the same
    tree raises; a missing leaf raises in both packages."""
    tree = tconvert.load_checkpoint(vda_file)
    assert {"resize0", "resize1", "resize3"} <= set(
        tree["params"]["head"])
    frames = clip_frames(4)
    kw = dict(size="vitt", input_size=42, window=4, fp32=True)
    eng = tdepth.VDAEngine(params=tree, device="cpu", **kw)
    model, _ = eng.models((42, 56))
    assert sorted(eng.ignored_leaves) == RESIZE_LEAVES
    with pytest.raises(RuntimeError, match="resize0"):
        from_jax.load_flax_params(model, tree)
    assert np.isfinite(eng.infer_video(frames)).all()
    # (the JAX engine runs on this tree in test_depth_checkpoint_matches_jax)
    del tree["params"]["head"]["motion0"]["proj_in"]["bias"]
    with pytest.raises(RuntimeError, match="motion0.proj_in.bias"):
        tdepth.VDAEngine(params=tree, device="cpu", **kw).models((42, 56))
    jtree = jconvert.load_checkpoint(vda_file)
    del jtree["params"]["head"]["motion0"]["proj_in"]["bias"]
    with pytest.raises(Exception, match="proj_in"):
        jdepth.VDAEngine(params=jtree, anchor_params={}, data_parallel=False,
                         **kw).infer_video(frames)


def test_depth_checkpoint_grid_mismatch_fails_like_jax(vda_file):
    """``convert_dinov2_vit`` does not resample ``pos_embed``: a file made
    for a 3 x 4 grid fails on a clip whose working grid is another, in the
    JAX package (Flax refuses the parameter's shape) and in the port (an
    error naming both grids)."""
    frames = clip_frames(4, h=56, w=56)
    kw = dict(size="vitt", input_size=42, window=4, fp32=True)
    with pytest.raises(Exception, match="pos_embed"):
        jdepth.VDAEngine(params=jconvert.load_checkpoint(vda_file),
                         anchor_params={}, data_parallel=False,
                         **kw).infer_video(frames)
    eng = tdepth.VDAEngine(params=tconvert.load_checkpoint(vda_file),
                           device="cpu", **kw)
    with pytest.raises(ValueError, match=r"12 patches.*42 x 42 is a grid "
                                         r"of 3 x 3 = 9 patches"):
        eng.infer_video(frames)


# ------------------------------------------------------------- DA3 ----

def dinov2_file(tmp_path, n_tokens=16):
    """A ``convert_dinov2_vit`` tree of an upstream DINOv2 state dict on a
    4 x 4 grid (the DA3 tests' engine runs 2 x 3)."""
    from test_convert import _synth_da2_state_dict
    sd = _synth_da2_state_dict(np.random.default_rng(9), jvit.VIT_TINY,
                               jdpt.DPT_TINY, n_tokens)
    path = str(tmp_path / "dinov2.msgpack")
    tconvert.save_checkpoint(path, tconvert.convert_dinov2_vit(
        sd, jvit.VIT_TINY))
    return path


def test_da3_backbone_checkpoint_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("cv2")
    from test_torch_da3 import J_CFG, T_CFG, WINDOW, clip, flax_params
    path = dinov2_file(tmp_path)
    frames = clip()
    jpath, tpath = str(tmp_path / "j.mkv"), str(tmp_path / "t.mkv")
    tvio.save_rgb_video(frames, jpath, 24)
    tvio.save_rgb_video(frames, tpath, 24)
    jeng = jdepth.DA3PipelineEngine(cfg=J_CFG, **WINDOW)
    jeng.engine._params = flax_params(False)
    head = from_jax.flax_to_state_dict(jeng.engine._params)
    jeng.engine.load_backbone(path)
    want = jdepth.run_da3(jpath, engine=jeng)
    teng = tdepth.DA3PipelineEngine(cfg=T_CFG["flash_packed"], device="cpu",
                                    params=head, backbone=path, **WINDOW)
    got = tdepth.run_da3(tpath, engine=teng)
    codes_close(got, want)
    grafted = teng.engine.model(teng.engine._work_hw(*frames.shape[1:3]))
    want_bb = from_jax.flax_to_state_dict(
        jeng.engine._params["params"]["backbone"])
    got_bb = grafted.backbone.state_dict()
    assert sorted(got_bb) == sorted(want_bb)
    for k in want_bb:
        np.testing.assert_allclose(got_bb[k].numpy(), want_bb[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    # the command line: the file's backbone grafted into seeded weights
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    cpath = str(tmp_path / "c.mkv")
    tvio.save_rgb_video(frames, cpath, 24)
    tmain.main(["da3", "--color_video", cpath, "--model_size", "vitt",
                "--da3_resolution", "28", "--images_per_batch", "4",
                "--batch_overlap", "3", "--nr_of_ref_frames", "2",
                "--backbone_checkpoint", path])
    with tvio.VideoReader(cpath + "_depth.mkv") as r:
        assert r.frame_count == len(frames)


def test_da3_checkpoint_flag_ignored_like_jax(tmp_path, monkeypatch):
    """The JAX package's ``da3_main`` accepts ``--checkpoint`` and never
    reads it; the port's does the same (a path that does not exist)."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.cli import depth_engines as jcli
    from metric_depth_video_toolbox_tpu_torch.cli import depth_engines as tcli
    from test_torch_da3 import clip
    seen = []
    for pkg in (jconvert, tconvert):
        monkeypatch.setattr(pkg, "load_checkpoint",
                            lambda p: seen.append(p))
    monkeypatch.setattr(jdepth, "run_batch",
                        lambda *a, **kw: seen.append(kw) or [])
    jcli.da3_main(["--color_video", "x.mkv", "--checkpoint", "none.pkl"])
    assert "none.pkl" not in str(seen) and seen[-1]["backbone"] is None
    path = str(tmp_path / "c.mkv")
    tvio.save_rgb_video(clip()[:3], path, 24)
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    args = tcli.build_da3_parser().parse_args(
        ["--color_video", path, "--model_size", "vitt", "--da3_resolution",
         "28", "--checkpoint", str(tmp_path / "none.pkl")])
    assert tcli.run_da3(args) == [path + "_depth.mkv"]
    assert len(seen) == 1


# ----------------------------------------------------------- infill ----

WORK = (32, 48)
N_SBS = 5


class JaxNoise:
    """The noise sequence of a JAX engine seeded 0: each ``infill_chunk``
    splits the key and draws from the half."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def __call__(self, shape):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.normal(
            sub, shape, jnp.float32)))


def feed_jax_noise(monkeypatch, cls, latent_shape):
    noise = JaxNoise()
    orig = cls.infill_chunk

    def infill_chunk(self, frames_u8, hole_mask, mono_u8=None, noise_=None):
        return orig(self, frames_u8, hole_mask, mono_u8,
                    noise=noise(latent_shape(self, frames_u8.shape[0])))
    monkeypatch.setattr(cls, "infill_chunk", infill_chunk)


def sbs_files(tmp_path):
    rng = np.random.default_rng(42)
    h, w = 40, 72
    sbs = np.stack([np.concatenate([textured(rng, h, w)[:h, :w]] * 2, 1)
                    for _ in range(N_SBS)])
    mask = np.zeros((N_SBS, h, 2 * w, 3), np.uint8)
    mask[:, 8:20, 10:24] = (200, 60, 128)
    mask[:, 22:34, 90:110] = (40, 230, 128)
    mono = np.stack([textured(rng, h, w)[:h, :w] for _ in range(N_SBS)])
    paths = {k: str(tmp_path / f"{k}.mkv") for k in ("sbs", "mask", "mono")}
    for k, arr in (("sbs", sbs), ("mask", mask), ("mono", mono)):
        tvio.save_rgb_video(arr, paths[k], 24)
    return paths


def svd_latent(eng, t):
    eng._ensure()
    with torch.no_grad():
        return tuple(eng.model.encode(torch.zeros((t,) + eng.work_hw
                                                  + (3,))).shape)


def wan_latent(eng, t):
    c = eng.cfg
    return (1, twan.latent_frames(eng._t_pad(t)), eng.work_hw[0] // 8,
            eng.work_hw[1] // 8, c.z_ch)


def run_both(tmp_path, monkeypatch, preset, argv, jax_engine, cls, latent):
    """The port's ``mdvt-torch infill`` and the JAX package's chunk loop
    with ``jax_engine`` on the same files -> (port frames, JAX frames)."""
    pytest.importorskip("cv2")
    for presets in (jid.ENGINE_PRESETS, tid.ENGINE_PRESETS):
        monkeypatch.setitem(presets, preset, dict(presets[preset],
                                                  work_hw=WORK))
    paths = sbs_files(tmp_path)
    _, drv = jid.make_engine(preset, cfg=jax_engine.cfg)
    drv = {k: v for k, v in drv.items() if k in (
        "mirror_left", "drift_correct", "apply_edge_blending")}
    want = jid.infill_sbs_video_diffusion(
        paths["sbs"], paths["mask"], output=str(tmp_path / "j.mkv"),
        color_video=paths["mono"], engine=jax_engine, **drv)
    feed_jax_noise(monkeypatch, cls, latent)
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    tmain.main(["infill", "--sbs_color_video", paths["sbs"],
                "--sbs_mask_video", paths["mask"], "--color_video",
                paths["mono"]] + argv)
    out = {}
    for k, p in (("port", paths["sbs"] + "_infilled.mkv"), ("jax", want)):
        with tvio.VideoReader(p) as r:
            out[k] = r.read_all()
    return out["port"], out["jax"]


def test_infill_svd_checkpoint_matches_jax(tmp_path, monkeypatch):
    unet_sd, vae_sd = svd_sds()
    ckpt, clip_ckpt = (str(tmp_path / n) for n in ("sc.msgpack",
                                                   "clip.msgpack"))
    jconvert.save_checkpoint(ckpt, jconvert.convert_stereocrafter(
        unet_sd, vae_sd, jsvd.SVD_TINY, jsvd.SVD_VAE_TINY))
    # a CLIP tower's tree (the converter is held in test_torch_convert.py)
    jconvert.save_checkpoint(clip_ckpt, perturbed_like(jax.eval_shape(
        jclip.CLIPVisionTower(jclip.CLIP_TINY).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3))), 3))
    # --model_scale svd at the tiny widths: the configs the commands build
    monkeypatch.setattr(tsvd, "SVDConfig", lambda: tsvd.SVD_TINY)
    monkeypatch.setattr(tsvd, "SVDVAEConfig", lambda: tsvd.SVD_VAE_TINY)
    monkeypatch.setattr(tclip, "CLIP_VIT_H", tclip.CLIP_TINY)
    jeng = jid.DiffusionInfillEngine(
        cfg=dataclasses.replace(jsvd.SVD_TINY, num_steps=2),
        params=jconvert.load_checkpoint(ckpt),
        work_hw=WORK, chunk=25, overlap=6, vae_cfg=jsvd.SVD_VAE_TINY,
        clip_params=jconvert.load_checkpoint(clip_ckpt),
        clip_cfg=jclip.CLIP_TINY, data_parallel=False)
    seen = []
    real = tid.make_engine
    monkeypatch.setattr(tid, "make_engine", lambda *a, **kw: seen.append(
        kw) or real(*a, **kw))
    got, want = run_both(
        tmp_path, monkeypatch, "stereocrafter",
        ["--infill_engine", "stereocrafter", "--model_scale", "svd",
         "--checkpoint", ckpt, "--clip_checkpoint", clip_ckpt,
         "--num_inference_steps", "2"],
        jeng, tid.DiffusionInfillEngine, svd_latent)
    assert seen[0]["clip_params"] is not None
    assert got.shape == want.shape == (N_SBS, 40, 144, 3)
    assert_u8_budget(got, want)


def wan_tree():
    """``{"dit", "enc", "dec"}``: the DiT from ``convert_wan`` of the
    upstream mirror, the VAE's halves drawn like the JAX ``init``."""
    cfg = jwan.WAN_TINY
    frames = jnp.zeros((1, 5) + WORK + (3,))
    key = jax.random.PRNGKey(0)
    enc = jwan.WanVAEEncoder(cfg.vae)
    enc_shapes = jax.eval_shape(enc.init, key, frames)
    z = jax.eval_shape(enc.apply, enc_shapes, frames)
    dec = jwan.WanVAEDecoder(cfg.vae)
    return {"dit": jconvert.convert_wan(wan_sd(), cfg),
            "enc": perturbed_like(enc_shapes, 1),
            "dec": perturbed_like(jax.eval_shape(
                dec.init, key, jnp.zeros(z.shape, jnp.float32)), 2)}


def test_infill_inspatio_checkpoint_matches_jax(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "wan.msgpack")
    jconvert.save_checkpoint(ckpt, wan_tree())
    jeng = jid.CausalInfillEngine(
        cfg=dataclasses.replace(jwan.WAN_TINY, denoise_steps=(1.0, 0.5)),
        params=jconvert.load_checkpoint(ckpt), work_hw=WORK)
    got, want = run_both(
        tmp_path, monkeypatch, "inspatio_world",
        ["--infill_engine", "inspatio_world", "--model_scale", "tiny",
         "--checkpoint", ckpt, "--num_inference_steps", "2"], jeng,
        tid.CausalInfillEngine, wan_latent)
    assert got.shape == want.shape == (N_SBS, 40, 144, 3)
    assert_u8_budget(got, want)


def test_bare_wan_tree_fails_like_jax(tmp_path):
    """A ``convert_wan`` tree alone (the DiT, no ``dit`` key) is kept as it
    is by the JAX ``CausalInfillEngine``, which then fails with
    ``KeyError`` indexing it for its parts; the port raises ``KeyError``
    too, naming the layout."""
    bare = jconvert.convert_wan(wan_sd(), jwan.WAN_TINY)
    assert "dit" not in bare
    frames = np.zeros((5, 32, 48, 3), np.uint8)
    hole = np.zeros((5, 32, 48), bool)
    jeng = jid.CausalInfillEngine(cfg=jwan.WAN_TINY, params=bare,
                                  work_hw=WORK)
    with pytest.raises(KeyError, match="enc|dit"):   # ("enc" comes first)
        jeng.infill_chunk(frames, hole, frames)
    teng = tid.CausalInfillEngine(cfg=twan.WAN_TINY, params=bare,
                                  work_hw=WORK, device="cpu")
    with pytest.raises(KeyError, match="convert_wan"):
        teng.infill_chunk(frames, hole, frames)


# ------------------------------------------------- download-weights ----

def _no_network(*args, **kwargs):
    raise OSError("no network in this test")


@pytest.mark.parametrize("case", ["dry_run", "convert", "cfg_fault",
                                  "missing"])
def test_download_weights_cli(tmp_path, monkeypatch, capsys, case):
    """``mdvt-torch download-weights`` against the JAX package's command,
    with the network refused: the dry-run plan; a file already in
    ``--dest_dir`` used as it is and ``--convert`` writing
    ``<file>.mdvt.msgpack``, which Flax reads to the JAX command's tree; the
    JAX package's ``cfg=None`` fault for ``vda``; a missing file naming
    itself."""
    import urllib.request

    import flax.serialization as ser
    from metric_depth_video_toolbox_tpu.cli import download_weights as jdl
    from test_torch_convert import u2net_sd
    monkeypatch.setattr(urllib.request, "urlretrieve", _no_network)
    model = "u2net" if case == "convert" else "vda"
    out = {}
    for tag, run in (("jax", jdl.main), ("port", lambda a: tmain.main(
            ["download-weights"] + a))):
        dest = tmp_path / tag
        dest.mkdir()
        argv = ["--model", model, "--dest_dir", str(dest)]
        if case == "dry_run":
            run(argv + ["--dry_run"])
            out[tag] = capsys.readouterr().out
        elif case == "missing":
            with pytest.raises(FileNotFoundError) as e:
                run(argv)
            out[tag] = str(e.value).replace(str(dest), "<dest>")
        else:
            sd = (u2net_sd() if case == "convert" else vda_sd())
            for name in tconvert.WEIGHT_REGISTRY[model]["files"]:
                torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                           str(dest / name))
            if case == "cfg_fault":
                with pytest.raises(AttributeError, match="'vit'"):
                    run(argv + ["--convert"])
                continue
            run(argv + ["--convert"])
            with open(dest / "u2net.onnx.mdvt.msgpack", "rb") as f:
                out[tag] = ser.msgpack_restore(f.read())
    if case == "convert":
        jax.tree.map(np.testing.assert_array_equal, out["port"], out["jax"])
        assert set(out["port"]["params"]) >= {"stage1", "outconv"}
    elif case != "cfg_fault":
        assert out["port"] == out["jax"] and "video_depth_anything" in out[
            "port"]
