"""``mdvt movie`` in the port against the JAX package's: the scene CSV and
splitter, the Matroska remux, and one run of each package's
``movie_to_3d`` on the same tiny two-scene clip with the same weights.

The movie runs VDA ``vitt`` (float32, 48 x 64 frames, working size 42 x
56, windows of 8 with overlap 2, so each 16-frame scene stitches two
windows) with its depth made metric against a reference depth video
(float32 end to end: the bfloat16 metric anchor would leave the two
packages' depths up to 15% apart, test_torch_depth_engine.py), U²-Net
SEG_TINY masks at work size 40, and the basic infill. Tolerances:
- scene files and their frame counts: identical;
- depth: rtol 1e-4 (the reference-fitted depth's tolerance);
- masks: a pixel may differ only where the probability lies within 1e-4
  of the threshold;
- convergence depths: rtol 1e-5 on the same depth and mask videos, rtol
  1e-4 end to end;
- each scene's SBS and infilled output: the budget of
  test_torch_stereo.py (at most 1 LSB on at most 0.5% of bytes);
- the final movie: every frame, StereoMode 1.

The JAX ``movie_to_3d`` hands a list of two or more scene videos to
``run_batch``, which takes one path or a .txt list: it fails on a movie
of two scenes that share an engine (ROADMAP section C). Its run here goes
through a shim that gives ``run_batch`` one video at a time.
"""

import dataclasses
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.io import mkv as jmkv
from metric_depth_video_toolbox_tpu.io import video as jvio
from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.models import segmentation as jseg
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu.pipeline import masks as jmasks
from metric_depth_video_toolbox_tpu.pipeline import movie as jmovie
from metric_depth_video_toolbox_tpu.pipeline import scenes as jscenes
from metric_depth_video_toolbox_tpu_torch.io import mkv as tmkv
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import segmentation as tseg
from metric_depth_video_toolbox_tpu_torch.pipeline import masks as tmasks
from metric_depth_video_toolbox_tpu_torch.pipeline import movie as tmovie
from metric_depth_video_toolbox_tpu_torch.pipeline import scenes as tscenes

SCENE, H, W = 16, 48, 64
INPUT_SIZE, WORK = 42, 40
ENGINE = dict(size="vitt", fp32=True, window=8, overlap=2,
              input_size=INPUT_SIZE)
FLIP = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module runs:
    its tensors are small, and in the parallel test run the spinning
    thread pools of several processes on the same cores slow its work
    several times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# --- scenes ---------------------------------------------------------------

def _scenes():
    rows = []
    for i, (sf, ef) in enumerate(((0, 3599), (3600, 3649), (3650, 4999))):
        rows.append({"Scene Number": str(i + 1), "Start Frame": str(sf),
                     "Start Timecode": jscenes._timecode(sf / 24),
                     "Start Time (seconds)": f"{sf / 24:.3f}",
                     "End Frame": str(ef),
                     "End Timecode": jscenes._timecode((ef + 1) / 24),
                     "End Time (seconds)": f"{(ef + 1) / 24:.3f}",
                     "Length (frames)": str(ef - sf + 1),
                     "Length (seconds)": f"{(ef - sf + 1) / 24:.3f}",
                     "Length (timecode)": jscenes._timecode(
                         (ef - sf + 1) / 24)})
    rows[1]["Engine"] = "da3"
    rows[2]["Infill"] = "No"
    return rows


def test_scene_csv_round_trip(tmp_path):
    """Both packages write the same bytes and read each other's file."""
    paths = {}
    for name, mod in (("jax", jscenes), ("torch", tscenes)):
        paths[name] = mod.write_scene_csv(str(tmp_path / f"{name}.csv"),
                                          _scenes())
    assert filecmp.cmp(paths["jax"], paths["torch"], shallow=False)
    for path in paths.values():
        assert tscenes.read_scene_csv(path) == jscenes.read_scene_csv(path)
    assert tscenes.read_scene_csv(paths["jax"])[1]["Engine"] == "da3"


def test_split_scenes_matches_jax():
    want = jscenes.split_scenes(_scenes(), max_scene_frames=1500)
    got = tscenes.split_scenes(_scenes(), max_scene_frames=1500)
    assert got == want
    assert [s["Length (frames)"] for s in got] == [
        "1500", "1500", "600", "50", "1350"]


def test_detect_scenes_matches_jax(movie_runs):
    clip = movie_runs["clip"]
    assert tscenes.detect_scenes(clip) == jscenes.detect_scenes(clip)


# --- Matroska remux -------------------------------------------------------

@pytest.fixture
def mkv_sample(tmp_path):
    """tests/test_mkv.py's fixture: a 10-frame 32 x 64 lossless video."""
    pytest.importorskip("cv2")
    frames = np.random.default_rng(0).integers(
        0, 255, (10, 32, 64, 3)).astype(np.uint8)
    path = str(tmp_path / "s.mkv")
    jvio.save_rgb_video(frames, path, 24)
    return path


def _copies(path, tmp_path):
    out = {}
    for name in ("jax", "torch"):
        out[name] = str(tmp_path / f"{name}.mkv")
        with open(path, "rb") as src, open(out[name], "wb") as dst:
            dst.write(src.read())
    return out


def test_set_stereo_mode_bytes_match_jax(mkv_sample, tmp_path):
    files = _copies(mkv_sample, tmp_path)
    jmkv.set_stereo_mode(files["jax"])
    tmkv.set_stereo_mode(files["torch"])
    assert filecmp.cmp(files["jax"], files["torch"], shallow=False)
    assert tmkv.get_stereo_mode(files["torch"]) == tmkv.STEREO_SBS_LEFT_FIRST


def test_mux_audio_bytes_match_jax(mkv_sample, tmp_path):
    from test_mkv import _make_audio_mkv

    audio = str(tmp_path / "a.mkv")
    _make_audio_mkv(audio, n_blocks=6, block_ms=50)
    files = _copies(mkv_sample, tmp_path)
    jmkv.mux_audio(files["jax"], audio, stereo_mode=1)
    tmkv.mux_audio(files["torch"], audio, stereo_mode=1)
    assert filecmp.cmp(files["jax"], files["torch"], shallow=False)
    assert tmkv.has_audio_track(files["torch"])


# --- the movie, both packages ---------------------------------------------

def _clip():
    """Two 16-frame scenes of different hue with a hard cut, each panning
    a blocky texture."""
    out = []
    for seed, tint in ((1, (120, 0, 0)), (2, (0, 40, 120))):
        base = np.random.default_rng(seed).integers(
            0, 120, (H // 4 + 2, W // 4 + 2 * SCENE, 3)) + np.array(tint)
        tex = np.kron(base.astype(np.uint8), np.ones((4, 4, 1), np.uint8))
        out.append(np.stack([tex[:H, 2 * i:2 * i + W]
                             for i in range(SCENE)]))
    return np.concatenate(out)


def _reference_depth():
    """A ramp with a near slab, moving with the frame index."""
    yy = np.linspace(0, 1, H, dtype=np.float32)[:, None]
    depth = np.tile(3.0 + 12.0 * yy, (SCENE, 1, W))
    for i in range(SCENE):
        depth[i, 12:34, 14 + i:34 + i] = 1.6
    return depth.astype(np.float32)


def _jax_run_batch_one_at_a_time(monkeypatch):
    run_batch = jdepth.run_batch

    def shim(engine, videos, **kw):
        videos = videos if isinstance(videos, list) else [videos]
        return [run_batch(engine, v, **kw)[0] for v in videos]
    monkeypatch.setattr(jmovie.depth_stage, "run_batch", shim)


def _flax_like(tree, seed):
    """numpy values for a Flax parameter tree of shapes, drawn with Flax's
    initializers by leaf name (a jitted ``init`` of the VDA engine takes
    ~20 s on the CPU): LeCun-normal kernels, unit scales, variances and
    layer scales, N(0, 0.02) position embeddings, zeros elsewhere."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name in ("scale", "var", "gamma"):
            return np.ones(leaf.shape)
        if name == "pos_embed":
            return rng.normal(0, 0.02, leaf.shape)
        return np.zeros(leaf.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: draw(p, a).astype(np.float32), tree)


@pytest.fixture(scope="module")
def movie_runs(tmp_path_factory):
    """One run of each package's ``movie_to_3d`` on the same clip, the same
    weights and the same mask threshold."""
    pytest.importorskip("cv2")
    tmp = tmp_path_factory.mktemp("movie")
    frames = _clip()
    clip = str(tmp / "clip.mkv")
    jvio.save_rgb_video(frames, clip, 24)
    ref = str(tmp / "reference_depth.mkv")
    jvio.save_depth_video(_reference_depth(), ref, 24, 100.0)

    jeng = jdepth.VDAEngine(data_parallel=False, **ENGINE)
    work = jda.working_resolution(H, W, INPUT_SIZE, 14)
    vda = _flax_like(jax.eval_shape(
        jeng.model.init, jax.random.PRNGKey(0),
        jnp.zeros((ENGINE["window"],) + work + (3,))), 0)
    anchor = _flax_like(jax.eval_shape(
        jeng.anchor.init, jax.random.PRNGKey(0),
        jnp.zeros((1,) + work + (3,))), 1)
    seg_params = _flax_like(jax.eval_shape(
        jseg.U2Net(jseg.SEG_TINY).init, jax.random.PRNGKey(0),
        jnp.zeros((1, WORK, WORK, 3))), 2)
    tmask = tmasks.MaskEngine(
        cfg=tseg.SEG_TINY, work=WORK, device="cpu",
        params=from_jax.flax_to_state_dict(seg_params))
    # the threshold in the widest gap between the middle half of the
    # probabilities on the clip (the port's, within 1e-5 of the JAX
    # package's: test_torch_masks.py), so that the masks get both values
    p = tmask.probabilities(frames).numpy()
    s = np.sort(p.reshape(-1))
    mid = s[s.size // 4: 3 * s.size // 4]
    i = int(np.argmax(np.diff(mid)))
    thr = tmask.threshold = float((mid[i] + mid[i + 1]) / 2)

    common = dict(xfov=60.0, batch_size=4)
    runs = {"clip": clip, "frames": frames, "p": p, "thr": thr}
    mp = pytest.MonkeyPatch()
    try:
        _jax_run_batch_one_at_a_time(mp)
        jclip = str(tmp / "jax" / "clip.mkv")
        os.makedirs(os.path.dirname(jclip))
        os.link(clip, jclip)
        runs["jax"] = jmovie.movie_to_3d(
            jclip, engine_kwargs=dict(
                ENGINE, data_parallel=False, params=vda,
                anchor_params=anchor, reference_depth_video=ref),
            mask_engine=jmasks.MaskEngine(cfg=jseg.SEG_TINY,
                                          params=seg_params, work=WORK,
                                          threshold=thr), **common)
    finally:
        mp.undo()
    tclip = str(tmp / "torch" / "clip.mkv")
    os.makedirs(os.path.dirname(tclip))
    os.link(clip, tclip)
    kwargs = dict(
        engine_kwargs=dict(
            ENGINE, params=from_jax.flax_to_state_dict(vda),
            anchor_params=from_jax.flax_to_state_dict(anchor),
            reference_depth_video=ref),
        mask_engine=tmask, device="cpu", **common)
    runs["torch"] = tmovie.movie_to_3d(tclip, **kwargs)
    runs["torch_steps"] = dict(tmovie.STEP_SECONDS)
    runs["torch_kwargs"] = kwargs
    runs["ref"] = ref
    return runs


def _out_dir(runs, name):
    return os.path.join(os.path.dirname(runs[name]), "clip_3d")


def _read(path):
    with tvio.VideoReader(path) as r:
        return r.read_all()


def test_movie_scene_files_match(movie_runs):
    jdir, tdir = _out_dir(movie_runs, "jax"), _out_dir(movie_runs, "torch")
    assert filecmp.cmp(os.path.join(jdir, "clip-Scenes.csv"),
                       os.path.join(tdir, "clip-Scenes.csv"), shallow=False)
    rows = tscenes.read_scene_csv(os.path.join(tdir, "clip-Scenes.csv"))
    assert [r["Length (frames)"] for r in rows] == [str(SCENE)] * 2
    for n in (1, 2):
        got = _read(os.path.join(tdir, f"scene_{n}.mkv"))
        want = _read(os.path.join(jdir, f"scene_{n}.mkv"))
        assert got.shape == (SCENE, H, W, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, movie_runs["frames"][(n - 1) * SCENE:n * SCENE])


def test_movie_masks_match(movie_runs):
    jdir, tdir = _out_dir(movie_runs, "jax"), _out_dir(movie_runs, "torch")
    for n in (1, 2):
        got = _read(os.path.join(tdir, f"scene_{n}.mkv_mask.mkv"))[..., 0]
        want = _read(os.path.join(jdir, f"scene_{n}.mkv_mask.mkv"))[..., 0]
        p = movie_runs["p"][(n - 1) * SCENE:n * SCENE]
        assert set(np.unique(got)) <= {0, 255}
        flips = got != want
        assert (np.abs(p[flips] - movie_runs["thr"]) < FLIP).all()
    assert 0 < got.mean() < 255


def test_movie_depth_matches(movie_runs):
    """Decoded depth within rtol 1e-4 (the reference-fitted depth's
    tolerance, test_torch_depth_engine.py: the fit's 2x2 normal equations
    cancel, so float32 sums in another order move a whole scene's scale)."""
    from metric_depth_video_toolbox_tpu_torch.io.video import DepthVideoReader

    jdir, tdir = _out_dir(movie_runs, "jax"), _out_dir(movie_runs, "torch")
    for n in (1, 2):
        depth = {}
        for name, d in (("jax", jdir), ("torch", tdir)):
            with DepthVideoReader(os.path.join(d, f"scene_{n}.mkv_depth.mkv"),
                                  100.0) as r:
                depth[name] = r.read_depth_batch(64)
        assert depth["torch"].shape == (SCENE, H, W)
        np.testing.assert_allclose(depth["torch"], depth["jax"], rtol=1e-4,
                                   atol=2 * 100.0 / 65535)


def _json(path):
    with open(path, encoding="utf-8") as f:
        return np.asarray(json.load(f), np.float64)


def test_movie_convergence_matches(movie_runs, tmp_path):
    """The port's convergence depths within rtol 1e-5 of the JAX
    package's ``find_convergence_depths`` on the port's own depth and mask
    videos, and within the depth tolerance (rtol 1e-4) of the JAX movie's
    on its own."""
    from metric_depth_video_toolbox_tpu.pipeline import convergence as jconv

    jdir, tdir = _out_dir(movie_runs, "jax"), _out_dir(movie_runs, "torch")
    for n in (1, 2):
        name = f"scene_{n}.mkv_depth.mkv_convergence_depths.json"
        got = _json(os.path.join(tdir, name))
        shared = _json(jconv.find_convergence_depths(
            os.path.join(tdir, f"scene_{n}.mkv_depth.mkv"),
            mask_video=os.path.join(tdir, f"scene_{n}.mkv_mask.mkv"),
            output=str(tmp_path / name)))
        want = _json(os.path.join(jdir, name))
        assert got.shape == (SCENE,)
        assert np.isnan(got).tolist() == np.isnan(want).tolist() == \
            np.isnan(shared).tolist()
        np.testing.assert_allclose(got, shared, rtol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("suffix", ["_stereo.mkv", "_stereo.mkv_infilled.mkv",
                                    "_stereo.mkv_infillmask.mkv"])
def test_movie_sbs_matches(movie_runs, suffix):
    from test_torch_stereo import assert_u8_budget

    jdir, tdir = _out_dir(movie_runs, "jax"), _out_dir(movie_runs, "torch")
    for n in (1, 2):
        name = f"scene_{n}.mkv_depth.mkv{suffix}"
        got = _read(os.path.join(tdir, name))
        assert got.shape == (SCENE, H, 2 * W, 3)
        assert_u8_budget(got, _read(os.path.join(jdir, name)))


def test_movie_final_frames_and_stereo_mode(movie_runs):
    from test_torch_stereo import assert_u8_budget

    path = movie_runs["torch"]
    assert path.endswith("clip_SBS.mkv")
    got = _read(path)
    assert got.shape == (2 * SCENE, H, 2 * W, 3)
    assert_u8_budget(got, _read(movie_runs["jax"]))
    assert tmkv.get_stereo_mode(path) == tmkv.STEREO_SBS_LEFT_FIRST
    # the infill filled holes: the final frames are the infilled scenes
    tdir = _out_dir(movie_runs, "torch")
    sbs = _read(os.path.join(tdir, "scene_1.mkv_depth.mkv_stereo.mkv"))
    assert (got[:SCENE] != sbs).any(-1).mean() > 0.005
    assert set(movie_runs["torch_steps"]) == {
        "1 scenes", "2 depth", "3 masks", "4 convergence", "5 stereo",
        "6 infill", "7 concat"}


def test_movie_second_run_writes_nothing(movie_runs):
    tdir = os.path.dirname(movie_runs["torch"])

    def snapshot():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for d, _, fs in os.walk(tdir) for f in fs}
    before = snapshot()
    out = tmovie.movie_to_3d(os.path.join(tdir, "clip.mkv"),
                             **movie_runs["torch_kwargs"])
    assert out == movie_runs["torch"]
    assert snapshot() == before


def test_movie_redone_scene_is_concatenated_again(movie_runs):
    """A scene whose infilled output was deleted is infilled again, and the
    final movie, now older than it, is written anew."""
    tdir = os.path.dirname(movie_runs["torch"])
    final = movie_runs["torch"]
    infilled = os.path.join(_out_dir(movie_runs, "torch"),
                            "scene_2.mkv_depth.mkv_stereo.mkv_infilled.mkv")
    want = _read(final)
    was = os.stat(final).st_mtime_ns
    os.remove(infilled)
    out = tmovie.movie_to_3d(os.path.join(tdir, "clip.mkv"),
                             **movie_runs["torch_kwargs"])
    assert out == final and os.path.exists(infilled)
    assert os.stat(final).st_mtime_ns > was
    assert os.stat(final).st_mtime_ns >= os.stat(infilled).st_mtime_ns
    np.testing.assert_array_equal(_read(final), want)
    assert tmkv.get_stereo_mode(final) == tmkv.STEREO_SBS_LEFT_FIRST


def test_movie_cli_parser_matches_jax():
    from metric_depth_video_toolbox_tpu.cli import movie_2_3d as jcli
    from metric_depth_video_toolbox_tpu_torch.cli import movie_2_3d as tcli

    def key(a):
        return (tuple(a.option_strings), a.dest, a.default, a.type,
                a.required, tuple(a.choices or ()))
    assert sorted(map(key, jcli.build_parser()._actions), key=str) == \
        sorted(map(key, tcli.build_parser()._actions), key=str)


def _scene_list(mod, scene_mod, out_dir):
    csv = os.path.join(out_dir, "clip-Scenes.csv")
    return mod.plan_scene_files(scene_mod.split_scenes(
        scene_mod.read_scene_csv(csv)), out_dir)


def test_movie_step6_diffusion_matches_jax(movie_runs, tmp_path,
                                           monkeypatch):
    """The movie's ``--infill_engine diffusion`` (step 6) on copies of the
    port's scene directory, both packages: each scene gets the JAX
    package's default engine, ``DiffusionInfillEngine(chunk=25,
    overlap=6)`` (DIFFUSION_TINY at 256 x 256, not the production model),
    here on one weight tree and the JAX engine's noise. Each infilled scene
    within the budget of test_torch_stereo.py."""
    import shutil

    from metric_depth_video_toolbox_tpu.models import diffusion as jd
    from metric_depth_video_toolbox_tpu.pipeline import \
        infill_diffusion as jid
    from metric_depth_video_toolbox_tpu_torch.models import diffusion as td
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as tid
    from test_torch_stereo import assert_u8_budget

    src = _out_dir(movie_runs, "torch")
    dirs = {}
    for name in ("jax", "torch"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(src, dirs[name])
        for f in os.listdir(dirs[name]):
            if f.endswith("_infilled.mkv"):
                os.remove(os.path.join(dirs[name], f))
    f = jnp.zeros((1, 16, 16, 3))
    tree = _flax_like(jax.eval_shape(jd.VideoInpainter(jd.DIFFUSION_TINY).init,
                                     jax.random.PRNGKey(0), f, f[..., 0]), 3)
    jeng = jid.DiffusionInfillEngine
    monkeypatch.setattr(jid, "DiffusionInfillEngine", lambda **kw: jeng(
        params=tree, data_parallel=False, **kw))
    built = []

    class PortEngine(tid.DiffusionInfillEngine):
        """The port's default engine on the tree, fed the noise the JAX
        engine draws: a PRNGKey(0) split before every chunk."""

        def __init__(self, **kw):
            super().__init__(params=tree, **kw)
            built.append((kw, self))
            self.key = jax.random.PRNGKey(0)

        def infill_chunk(self, frames_u8, hole_mask, mono_u8=None,
                         noise=None):
            self.key, sub = jax.random.split(self.key)
            lat = (frames_u8.shape[0],) + tuple(
                s // 8 for s in self.work_hw) + (4,)
            noise = np.array(jax.random.normal(sub, lat, jnp.float32))
            return super().infill_chunk(frames_u8, hole_mask, mono_u8,
                                        torch.from_numpy(noise))
    monkeypatch.setattr(tid, "DiffusionInfillEngine", PortEngine)
    jmovie.step6_infill(_scene_list(jmovie, jscenes, dirs["jax"]),
                        infill_engine="diffusion")
    scenes = _scene_list(tmovie, tscenes, dirs["torch"])
    tmovie.step6_infill(scenes, infill_engine="diffusion", device="cpu")
    assert [kw for kw, _ in built] == [
        {"chunk": 25, "overlap": 6, "device": "cpu"}] * 2
    for _, eng in built:
        assert (eng.cfg, eng.work_hw, eng.mono_conditioning) == (
            td.DIFFUSION_TINY, (256, 256), False)
    for scene in scenes:
        name = os.path.basename(scene["infilled"])
        got = _read(scene["infilled"])
        assert_u8_budget(got, _read(os.path.join(dirs["jax"], name)))
        sbs = _read(scene["sbs"])
        hole = np.any(_read(scene["sbs_infill"]) != 0, axis=-1)
        assert got.shape == sbs.shape == (SCENE, H, 2 * W, 3)
        assert (got[hole] != sbs[hole]).mean() > 0.5


@pytest.mark.parametrize("kwargs,match", [
    ({"parallel": 2}, "A16")])
def test_movie_unported_options_raise(tmp_path, kwargs, match):
    pytest.importorskip("cv2")
    frames = _clip()[:SCENE]
    clip = str(tmp_path / "c.mkv")
    tvio.save_rgb_video(frames, clip, 24)
    with pytest.raises(NotImplementedError, match=match):
        tmovie.movie_to_3d(clip, device="cpu", xfov=60.0, **kwargs)


@pytest.mark.parametrize("engine,kw,want", [
    ("geometrycrafter", {}, [("geometrycrafter", ["s1.mkv"], {})]),
    ("depthcrafter", {}, [
        ("single_frame", "s1.mkv", {}),
        ("depthcrafter", "s1.mkv",
         {"reference_depth_video": "s1.mkv_ref_depth.mkv"})]),
    ("vda", {"quantize": "int8"}, [("vda", ["s1.mkv"],
                                    {"quantize": "int8"})])])
def test_movie_step2_runs_what_named_a13(tmp_path, monkeypatch, engine, kw,
                                         want):
    """The depth engines and the option that raised naming ROADMAP A13 in
    the movie: geometrycrafter through ``run_batch``, depthcrafter after a
    single-frame reference pass moved to ``<scene>_ref_depth.mkv``, and
    ``quantize`` handed to the engine (the engines' numbers are held in
    test_torch_diffusion_depth.py and test_torch_quant.py)."""
    calls = []

    def run_batch(eng, vids, **kws):
        calls.append((eng, vids, {k: v for k, v in kws.items()
                                  if k in ("reference_depth_video",
                                           "quantize")}))
        if eng == "single_frame":
            out = str(tmp_path / "ref.mkv")
            with open(out, "wb") as f:
                f.write(b"\0" * 4096)
            return [out]
        return []
    monkeypatch.setattr(tmovie.depth_stage, "run_batch", run_batch)
    monkeypatch.chdir(tmp_path)
    scenes = [{"finished": False, "Scene Number": 1,
               "depth_video_file": "no1.mkv", "scene_video_file": "s1.mkv"}]
    tmovie.step2_estimate_depth(scenes, engine=engine, device="cpu",
                                engine_kwargs=kw)
    assert calls == want
    assert os.path.exists(tmp_path / "s1.mkv_ref_depth.mkv") == (
        engine == "depthcrafter")


def test_movie_unknown_engine_falls_back_with_warning(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(tmovie.depth_stage, "run_batch",
                        lambda eng, vids, **kw: calls.append((eng, vids)))
    scenes = [{"finished": False, "Scene Number": 1, "Engine": "bogus",
               "depth_video_file": "no1.mkv", "scene_video_file": "s1.mkv"},
              {"finished": False, "Scene Number": 2,
               "depth_video_file": "no2.mkv", "scene_video_file": "s2.mkv"}]
    tmovie.step2_estimate_depth(scenes, engine="vda", device="cpu")
    out = capsys.readouterr().out
    assert "WARNING" in out and "bogus" in out
    assert calls == [("vda", ["s1.mkv", "s2.mkv"])]


def test_movie_gui_exits_as_reference():
    from metric_depth_video_toolbox_tpu_torch.cli import main as tmain

    with pytest.raises(SystemExit, match="headless"):
        tmain.main(["movie", "--color_video", "x.mkv", "--gui"])


def test_step7_audio_branches(tmp_path, monkeypatch):
    """The final concat muxes a Matroska source's audio natively when no
    ffmpeg is on the PATH, and goes through ffmpeg when there is one."""
    from test_mkv import _make_audio_mkv

    sbs = str(tmp_path / "s1.mkv")
    tvio.save_rgb_video(_clip()[:4], sbs, 24)
    scenes = [{"infilled": sbs, "sbs": sbs, "Length (frames)": "4"}]
    audio = str(tmp_path / "movie.mkv")
    _make_audio_mkv(audio, n_blocks=4, block_ms=50)
    monkeypatch.setattr(tmovie.shutil, "which", lambda name: None)
    out = tmovie.step7_concat(scenes, audio)
    assert out == str(tmp_path / "movie_SBS.mkv")
    assert tmkv.has_audio_track(out)
    assert tmkv.get_stereo_mode(out) == tmkv.STEREO_SBS_LEFT_FIRST

    calls = []
    monkeypatch.setattr(tmovie.shutil, "which", lambda name: "/bin/ffmpeg")
    monkeypatch.setattr(tmovie.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or
                        dataclasses.make_dataclass("R", ["returncode"])(1))
    os.remove(out)
    out = tmovie.step7_concat(scenes, audio)
    assert calls[0][:3] == ["ffmpeg", "-y", "-i"] and "copy" in calls[0]
    assert "aac" in calls[1]
    assert _read(out).shape == (4, H, W, 3)
    assert tmkv.get_stereo_mode(out) == tmkv.STEREO_SBS_LEFT_FIRST
