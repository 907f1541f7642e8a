"""The small subcommands of the port against the JAX package's CLI, file to
file: ``engine videoanythingmetric`` (and the same bytes as ``depth`` with
the same flags), ``split-sbs``, ``inpaint``, ``project create / status /
set / split``, ``depth --profile DIR`` (one Chrome trace), and the
movie's two-pass single-frame step 2 with ``--depth_engine unik3d`` and
``moge``.

Tolerances:
- ``split-sbs``, ``project``: identical frames and files;
- ``inpaint``: identical frames (the fill is rounded to uint8; measured
  equal);
- ``engine videoanythingmetric`` against the JAX CLI on the same weights:
  the metric anchor runs in bfloat16 in both packages, so depth within
  15% relative where 1/depth is above 1% of its largest (the anchor case
  of test_torch_depth_engine.py); against ``depth`` in the port: the same
  decoded bytes (the container itself is not byte-reproducible);
- the movie's step 2 (float32, point maps mapped upstream-style as in
  test_torch_single_frame.py): 16-bit depth codes within one step
  everywhere and equal on 99% of pixels, FOVs within 1e-3 degrees.
"""

import filecmp
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu.pipeline import movie as jmovie
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as tda
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from metric_depth_video_toolbox_tpu_torch.pipeline import movie as tmovie
from port_helpers import _one_torch_thread  # noqa: F401
from port_helpers import (float32_presets, init_like,
                          upstream_style_point_maps)

pytest.importorskip("cv2")

T, H, W = 10, 48, 64
INPUT_SIZE = 42


def clip():
    """A panning textured scene (uint8 frames)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 200, (H // 4 + 2, W // 4 + 2 * T, 3), np.uint8)
    tex = np.kron(base, np.ones((4, 4, 1), np.uint8))
    return np.stack([tex[:H, 2 * i:2 * i + W] for i in range(T)])


def _read(path):
    with tvio.VideoReader(path) as r:
        return r.read_all()


def _codes(path):
    rgb = _read(path).astype(np.int64)
    return rgb[..., 0] * 256 + rgb[..., 2]


def _write(tmp_path, name, frames):
    path = str(tmp_path / name)
    tvio.save_rgb_video(frames, path, 24)
    return path


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")


# --- engine videoanythingmetric and depth --profile ----------------------

VDA_FLAGS = ["--model_size", "vitt", "--input_size", str(INPUT_SIZE),
             "--fp32"]


def test_videoanythingmetric_is_depth_with_the_same_flags(tmp_path, cpu):
    """The VDA engine with --fp32, ignoring --output_dir, --checkpoint,
    --xfov and --yfov as the JAX package does: the same bytes as
    ``depth``."""
    a = _write(tmp_path, "a.mkv", clip())
    b = _write(tmp_path, "b.mkv", clip())
    tmain.main(["engine", "videoanythingmetric", "--color_video", a,
                "--output_dir", str(tmp_path / "elsewhere"), "--checkpoint",
                str(tmp_path / "absent.msgpack"), "--xfov", "70"]
               + VDA_FLAGS)
    tmain.main(["depth", "--color_video", b] + VDA_FLAGS)
    assert not os.path.exists(tmp_path / "elsewhere")
    got, want = _read(a + "_depth.mkv"), _read(b + "_depth.mkv")
    assert got.shape == (T, H, W, 3)
    np.testing.assert_array_equal(got, want)


def test_depth_profile_writes_a_trace(tmp_path, cpu):
    path = _write(tmp_path, "c.mkv", clip()[:4])
    trace_dir = tmp_path / "trace"
    tmain.main(["depth", "--color_video", path, "--profile",
                str(trace_dir)] + VDA_FLAGS)
    (trace,) = os.listdir(trace_dir)
    assert trace.endswith(".json")
    with open(trace_dir / trace, encoding="utf-8") as f:
        assert json.load(f)["traceEvents"]
    assert os.path.exists(path + "_depth.mkv")


def test_videoanythingmetric_matches_jax_cli(tmp_path, cpu, monkeypatch):
    from metric_depth_video_toolbox_tpu.cli import depth_engines as jcli

    jeng = jdepth.VDAEngine(size="vitt", fp32=True, input_size=INPUT_SIZE,
                            data_parallel=False)
    work = jda.working_resolution(H, W, INPUT_SIZE, 14)
    vda = init_like(jeng.model, 0, jnp.zeros((8,) + work + (3,)))
    anchor = init_like(jeng.anchor, 1, jnp.zeros((1,) + work + (3,)))
    monkeypatch.setitem(jdepth._ENGINE_CLASSES, "vda", functools.partial(
        jdepth.VDAEngine, params=vda, anchor_params=anchor,
        data_parallel=False))
    monkeypatch.setitem(tdepth._ENGINE_CLASSES, "vda", functools.partial(
        tdepth.VDAEngine, params=from_jax.flax_to_state_dict(vda),
        anchor_params=from_jax.flax_to_state_dict(anchor)))
    depth = {}
    for pkg in ("jax", "torch"):
        path = _write(tmp_path, f"{pkg}.mkv", clip())
        # these weights' depths are a few mm: a 5 cm range keeps the
        # 16-bit codes' step far below the 15% budget
        argv = ["--color_video", path, "--max_depth", "0.05"] + VDA_FLAGS
        if pkg == "jax":
            jcli.videoanythingmetric_main(argv)
        else:
            tmain.main(["engine", "videoanythingmetric"] + argv)
        with tvio.DepthVideoReader(path + "_depth.mkv", 0.05) as r:
            depth[pkg] = r.read_depth_batch(64)
    want, got = depth["jax"], depth["torch"]
    assert got.shape == want.shape == (T, H, W)
    inv = 1.0 / np.maximum(want, 1e-6)
    ok = (want < 0.05) & (inv > 0.01 * inv.max())
    assert ok.mean() > 0.95
    np.testing.assert_allclose(got[ok], want[ok], rtol=0.15)


# --- split-sbs and inpaint -------------------------------------------------

def test_split_sbs_matches_jax(tmp_path, cpu):
    from metric_depth_video_toolbox_tpu.cli import split_sbs_video as jsplit

    sbs = np.random.default_rng(2).integers(0, 256, (5, H, 2 * W, 3),
                                            np.uint8)
    out = {}
    for pkg in ("jax", "torch"):
        path = _write(tmp_path, f"{pkg}_sbs.mkv", sbs)
        argv = ["--sbs_video", path, "--max_frames", "4"]
        if pkg == "jax":
            jsplit.run(jsplit.build_parser().parse_args(argv))
        else:
            tmain.main(["split-sbs"] + argv)
        out[pkg] = [_read(path + s) for s in ("_left.mkv", "_right.mkv")]
    for got, want, half in zip(out["torch"], out["jax"],
                               (sbs[:4, :, :W], sbs[:4, :, W:])):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, half)


def test_inpaint_matches_jax(tmp_path, cpu):
    import cv2

    from metric_depth_video_toolbox_tpu.cli import apply_inpainting as jinp

    frames = clip()[:5]
    mask = np.zeros((H // 2, W // 2), np.uint8)   # resized to the frames
    mask[4:12, 6:20] = 255
    mask_path = str(tmp_path / "overlay.png")
    cv2.imwrite(mask_path, mask)
    out = {}
    for pkg in ("jax", "torch"):
        path = _write(tmp_path, f"{pkg}.mkv", frames)
        argv = ["--color_video", path, "--overlay_mask", mask_path,
                "--batch_size", "2", "--iterations", "24"]
        if pkg == "jax":
            jinp.run(jinp.build_parser().parse_args(argv))
        else:
            tmain.main(["inpaint"] + argv)
        out[pkg] = _read(path + "_inpainted.mkv")
    np.testing.assert_array_equal(out["torch"], out["jax"])
    hole = np.kron(mask > 16, np.ones((2, 2), bool))
    assert (out["torch"][:, ~hole] == frames[:, ~hole]).all()
    assert (out["torch"][:, hole] != frames[:, hole]).any()


# --- project ----------------------------------------------------------------

def test_project_verbs_match_jax(tmp_path, cpu, capsys):
    """create (config + detected scene CSV), status, set (a per-scene
    override), split (renumbering and renaming the scenes' files): the
    same files as the JAX package's, the same status rows."""
    from metric_depth_video_toolbox_tpu.cli import project as jproj

    scenes = []
    for seed, tint in ((1, 0), (2, 110)):
        base = np.random.default_rng(seed).integers(
            0, 120, (H // 4 + 2, W // 4 + 40, 3)) + tint
        tex = np.kron(base.astype(np.uint8), np.ones((4, 4, 1), np.uint8))
        scenes.append(np.stack([tex[:H, i:i + W] for i in range(20)]))
    movie = _write(tmp_path, "movie.mkv", np.concatenate(scenes))
    rows = {}
    for pkg in ("jax", "torch"):
        root = str(tmp_path / pkg)

        def run(*argv, _root=root, _pkg=pkg):
            argv = [argv[0], "--project_dir", _root] + list(argv[1:])
            if _pkg == "jax":
                return jproj.run(jproj.build_parser().parse_args(argv))
            return tmain.main(["project"] + argv)
        run("create", "--color_video", movie, "--depth_engine", "moge",
            "--xfov", "60")
        for name in ("scene_2.mkv", "scene_2.mkv_depth.mkv"):
            with open(os.path.join(root, name), "w") as f:
                f.write(name)
        run("set", "--scene", "2", "--column", "Engine", "--value", "unik3d")
        run("split", "--scene", "1", "--at_frame", "10")
        if pkg == "jax":
            rows[pkg] = jproj.run(jproj.build_parser().parse_args(
                ["status", "--project_dir", root]))
        else:
            from metric_depth_video_toolbox_tpu_torch.pipeline import \
                project as tproj
            run("status")
            rows[pkg] = tproj.status(tproj.open_project(root))
    assert rows["torch"] == rows["jax"]
    assert [r["engine"] for r in rows["torch"]] == ["moge", "moge", "unik3d"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        assert filecmp.cmp(jdir / name, tdir / name, shallow=False), name
    with open(tdir / "scene_3.mkv_depth.mkv") as f:
        assert f.read() == "scene_2.mkv_depth.mkv"
    assert "scene 1 split at 10" in capsys.readouterr().out


# --- the movie's two-pass step 2 --------------------------------------------

@pytest.fixture
def patched(monkeypatch):
    float32_presets(monkeypatch, jda, tda)
    upstream_style_point_maps(monkeypatch, jdepth, tdepth)


def _scene(root, frames):
    os.makedirs(root, exist_ok=True)
    video = os.path.join(root, "scene_1.mkv")
    tvio.save_rgb_video(frames, video, 24)
    return [{"Scene Number": "1", "finished": False,
             "scene_video_file": video,
             "depth_video_file": video + "_depth.mkv"}]


@pytest.mark.parametrize("engine", ["unik3d", "moge"])
def test_movie_two_pass_step2_matches_jax(engine, patched, tmp_path,
                                          capsys):
    """Step 2 with a single-frame engine: a unik3d FOV pass, then the
    engine locked to the median FOV, writing the ``_xfovs.json``; both
    packages on one stand-in tree (a moge tree holds the ray conditioning
    the locked pass adds)."""
    kw = dict(size="vitt", input_size=INPUT_SIZE)
    jeng = jdepth.SingleFrameEngine(data_parallel=False, variant=engine,
                                    xfov=60.0, **kw)
    work = jda.working_resolution(H, W, INPUT_SIZE, 14)
    x = jnp.zeros((1,) + work + (3,))
    grid = jnp.zeros((1, work[0] // 14, work[1] // 14, 3))
    tree = init_like(jeng.model, 0, *((x, grid) if jeng.cfg.k_condition
                                      else (x,)))
    frames = clip()
    out = {}
    jscenes = _scene(str(tmp_path / "jax"), frames)
    jmovie.step2_estimate_depth(jscenes, engine=engine, engine_kwargs=dict(
        kw, params=tree, data_parallel=False, xfov=30.0))
    tscenes = _scene(str(tmp_path / "torch"), frames)
    tmovie.step2_estimate_depth(tscenes, engine=engine, engine_kwargs=dict(
        kw, params=tree, xfov=30.0), device="cpu")
    for pkg, sc in (("jax", jscenes), ("torch", tscenes)):
        d = sc[0]["depth_video_file"]
        with open(d + "_xfovs.json", encoding="utf-8") as f:
            out[pkg] = (_codes(d), np.asarray(json.load(f)))
    diff = np.abs(out["torch"][0] - out["jax"][0])
    assert out["torch"][0].shape == (T, H, W)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], atol=1e-3)
    lock = [ln for ln in capsys.readouterr().out.splitlines()
            if "two-pass FOV lock" in ln]
    assert len(lock) == 2 and lock[0].split(": ")[1] == lock[1].split(
        ": ")[1]
    if engine == "moge":     # the locked FOV, not the movie's --xfov
        assert np.ptp(out["torch"][1]) == 0
        assert abs(out["torch"][1][0] - 30.0) > 1


def test_two_pass_shares_the_first_engines_weights():
    """Seeded (no tree): the locked engine aliases the FOV engine's
    tensors where names and shapes agree, the backbone among them, and
    keeps its own where they differ (DepthPro locked to a FOV: a 1-channel
    head)."""
    est = tdepth.SingleFrameEngine(size="vitt", variant="unik3d",
                                   device="cpu")
    eng = tdepth.SingleFrameEngine(size="vitt", variant="depthpro",
                                   xfov=50.0, device="cpu")
    work = (42, 56)
    n = eng.share_weights(est, work)
    mine = dict(eng.model(work).named_parameters())
    theirs = dict(est.model(work).named_parameters())
    assert n == len(mine) - 2          # all but head_conv3's weight, bias
    assert mine["backbone.pos_embed"] is not theirs["backbone.pos_embed"]
    assert mine["backbone.pos_embed"].data_ptr() == theirs[
        "backbone.pos_embed"].data_ptr()
    assert mine["head.head_conv3.weight"].shape != theirs[
        "head.head_conv3.weight"].shape
    frames = torch.zeros(1, H, W, 3, dtype=torch.uint8).numpy()
    assert eng.infer_video(frames).shape == (1, H, W)
