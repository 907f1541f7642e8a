"""The port's basic (normal-march) infill against the JAX package's:
``normal_march_infill``, ``mark_lower_side``, ``blur_under_mask``,
``basic_infill_frame``, ``infill_sbs_video`` and the stereo step's
``do_basic_infill``.

Tolerances:
- the marches (which pixel each hole copies, and the marks) bit for bit,
  below the JAX package's worklist cap of 1 << 16 marching pixels per
  frame; above it the port marches every hole, the JAX package only the
  first ``max_holes`` (ROADMAP section C);
- the blur under the mask within one code of uint8 (float32 sums in
  another order, then rounded);
- the stereo step with the infill, the budget of test_torch_stereo.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.ops import infill as jinf
from metric_depth_video_toolbox_tpu.pipeline import infill_video as jiv
from metric_depth_video_toolbox_tpu.pipeline import stereo as jst
from metric_depth_video_toolbox_tpu_torch.ops import infill as tinf
from metric_depth_video_toolbox_tpu_torch.pipeline import infill_video as tiv
from metric_depth_video_toolbox_tpu_torch.pipeline import stereo as tst

_jmarch = jax.jit(jinf.normal_march_infill,
                  static_argnames=("max_steps", "max_holes"))
_jbasic = jax.jit(jax.vmap(jiv.basic_infill_frame))


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


def _holes(rng, b, h, w):
    """Frames with a block hole, a ragged strip and scattered holes; a
    normal field of random directions, some exactly green (no normal)
    and some without XY length."""
    color = rng.integers(0, 256, (b, h, w, 3), np.uint8)
    hole = rng.random((b, h, w)) > 0.93
    hole[:, 10:30, 20:35] = True
    hole[:, 5:9, 40:70] |= rng.random((b, 4, 30)) > 0.3
    normal = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    normal[:, 12:16, 22:28] = (0.0, 1.0, 0.0)
    normal[:, 20:22, 30:33, :2] = 0.0
    return color, hole, normal


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_march_infill_matches_jax(seed):
    color, hole, normal = _holes(np.random.default_rng(seed), 3, 40, 72)
    want = np.stack([np.asarray(_jmarch(jnp.asarray(color[i]),
                                        jnp.asarray(hole[i]),
                                        jnp.asarray(normal[i])))
                     for i in range(3)])
    got = tinf.normal_march_infill(torch.from_numpy(color),
                                   torch.from_numpy(hole),
                                   torch.from_numpy(normal)).numpy()
    assert got.dtype == np.uint8
    assert (got != color).any(-1)[hole].mean() > 0.5
    np.testing.assert_array_equal(got, want)


def test_green_coded_hole_is_marched_like_jax():
    """A (0, 255, 0) mask pixel becomes (-1, 1, -1) through ``mask * 2 -
    1``, which is not the march's green code (0, 1, 0): a 6 x 8 green hole
    in a 16 x 32 frame is marched (diagonally) and filled, all 48 pixels,
    in both packages."""
    rng = np.random.default_rng(5)
    mask = np.zeros((16, 32, 3), np.uint8)
    mask[5:11, 10:18] = (0, 255, 0)
    sbs = rng.integers(1, 256, (16, 32, 3), np.uint8)
    sbs[5:11, 10:18] = 0
    hole = (mask != 0).any(-1)
    normals = mask.astype(np.float32) / 255.0 * 2.0 - 1.0
    want = np.asarray(_jmarch(jnp.asarray(sbs), jnp.asarray(hole),
                              jnp.asarray(normals)))
    got = tinf.normal_march_infill(torch.from_numpy(sbs),
                                   torch.from_numpy(hole),
                                   torch.from_numpy(normals)).numpy()
    np.testing.assert_array_equal(got, want)
    assert hole.sum() == 48 and (got[hole] != 0).any(-1).sum() == 48


def test_mark_lower_side_matches_jax():
    rng = np.random.default_rng(2)
    mask = rng.integers(0, 256, (3, 40, 72, 3), np.uint8)
    mask[rng.random((3, 40, 72)) < 0.4] = 0
    mask[:, 15:25, 30:50] = 0
    want = np.stack([np.asarray(jinf.mark_lower_side(jnp.asarray(m)))
                     for m in mask])
    got = tinf.mark_lower_side(torch.from_numpy(mask)).numpy()
    assert (got[..., 2] == 255).sum() > 100
    np.testing.assert_array_equal(got, want)


def test_port_marches_past_the_jax_cap():
    """384 marching holes, ``max_holes=100``: the JAX package fills the
    first 100 of them and leaves the rest; the port ignores the cap and
    gives what the JAX package gives with a cap above the count."""
    rng = np.random.default_rng(7)
    color = rng.integers(1, 256, (16, 64, 3), np.uint8)
    hole = np.zeros((16, 64), bool)
    hole[2:14, 16:48] = True
    color[hole] = 0
    normal = np.zeros((16, 64, 3), np.float32)
    normal[..., 0] = 1.0
    args = [jnp.asarray(a) for a in (color, hole, normal)]
    capped = np.asarray(_jmarch(*args, max_holes=100))
    full = np.asarray(_jmarch(*args))
    got = tinf.normal_march_infill(
        torch.from_numpy(color), torch.from_numpy(hole),
        torch.from_numpy(normal), max_holes=100).numpy()
    assert hole.sum() == 384
    assert (capped[hole] != 0).any(-1).sum() == 100
    assert (got[hole] != 0).any(-1).sum() == 384
    np.testing.assert_array_equal(got, full)


def _within_one_code(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()


def test_blur_under_mask_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 30, 44, 3), np.uint8)
    mask = (rng.random((2, 30, 44)) > 0.8).astype(np.float32)
    want = np.stack([np.asarray(jinf.blur_under_mask(
        jnp.asarray(img[i]), jnp.asarray(mask[i]), ksize=7))
        for i in range(2)])
    got = tinf.blur_under_mask(torch.from_numpy(img),
                               torch.from_numpy(mask), ksize=7).numpy()
    _within_one_code(got, want)


def _sbs_and_mask(rng, b, h, w):
    """SBS frames and an infill mask of encoded normals with black (keep)
    and green (no normal) pixels."""
    sbs = rng.integers(0, 256, (b, h, w, 3), np.uint8)
    mask = rng.integers(0, 256, (b, h, w, 3), np.uint8)
    mask[rng.random((b, h, w)) < 0.7] = 0
    mask[:, 4:9, 10:18] = (0, 255, 0)
    return sbs, mask


def test_basic_infill_frame_matches_jax():
    sbs, mask = _sbs_and_mask(np.random.default_rng(4), 3, 36, 80)
    want = np.asarray(_jbasic(jnp.asarray(sbs), jnp.asarray(mask)))
    got = tiv.basic_infill_frame(torch.from_numpy(sbs),
                                 torch.from_numpy(mask)).numpy()
    _within_one_code(got, want)
    assert (got != sbs).any(-1).mean() > 0.2


def test_infill_sbs_video_file_to_file_matches_jax(tmp_path):
    """5 frames in batches of 2, with a mask video one frame short (the
    last frame is then unmasked), through both packages' files."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.io import video as jvio
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    sbs, mask = _sbs_and_mask(np.random.default_rng(6), 5, 36, 80)
    spath, mpath = str(tmp_path / "sbs.mkv"), str(tmp_path / "mask.mkv")
    jvio.save_rgb_video(sbs, spath, 24)
    jvio.save_rgb_video(mask[:4], mpath, 24)
    out = {}
    for name, mod, kw in (("jax", jiv, {}), ("torch", tiv, {"device": "cpu"})):
        path = mod.infill_sbs_video(spath, mpath,
                                    output=str(tmp_path / f"{name}.mkv"),
                                    batch_size=2, **kw)
        with tvio.VideoReader(path) as r:
            out[name] = r.read_all()
    assert out["torch"].shape == (5, 36, 80, 3)
    _within_one_code(out["torch"], out["jax"])
    np.testing.assert_array_equal(out["torch"][4], sbs[4])


def test_infill_sbs_video_diffusion_engine_runs_the_default(tmp_path,
                                                           monkeypatch):
    """``engine="diffusion"`` builds the JAX package's default engine
    (DIFFUSION_TINY at 256 x 256, chunks of 25 overlapping by 6, seeded
    weights) and writes the infilled SBS video: every frame, the holes
    filled, the pixels outside the holes and the halo band unchanged."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio
    from metric_depth_video_toolbox_tpu_torch.models import diffusion as td
    from metric_depth_video_toolbox_tpu_torch.ops import image as tim
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as tid

    rng = np.random.default_rng(7)
    sbs = rng.integers(0, 256, (6, 24, 64, 3), np.uint8)
    mask = np.zeros_like(sbs)
    mask[:, 6:14, 8:20] = (200, 60, 128)
    mask[:, 10:18, 40:50] = (40, 230, 128)
    spath, mpath = str(tmp_path / "sbs.mkv"), str(tmp_path / "mask.mkv")
    tvio.save_rgb_video(sbs, spath, 24)
    tvio.save_rgb_video(mask, mpath, 24)
    built = []
    engine = tid.DiffusionInfillEngine

    def spy(**kw):
        built.append(engine(**kw))
        return built[-1]
    monkeypatch.setattr(tid, "DiffusionInfillEngine", spy)
    out = tiv.infill_sbs_video(spath, mpath, engine="diffusion",
                               device="cpu")
    assert out == spath + "_infilled.mkv"
    (eng,) = built
    assert (eng.cfg, eng.work_hw, eng.chunk, eng.overlap,
            eng.mono_conditioning) == (td.DIFFUSION_TINY, (256, 256), 25, 6,
                                       False)
    with tvio.VideoReader(out) as r:
        got = r.read_all()
    assert got.shape == sbs.shape
    hole = np.any(mask != 0, axis=-1)
    lower = tinf.mark_lower_side(torch.from_numpy(mask))
    band = tim.dilate((lower[..., 2] == 255).float(), ksize=5) > 0
    band = tim.dilate(band.float(), ksize=7).numpy() > 0   # the blur reach
    keep = ~hole & ~band
    np.testing.assert_array_equal(got[keep], sbs[keep])
    assert (got[hole] != sbs[hole]).mean() > 0.5


def test_render_stereo_video_basic_infill_matches_jax(tmp_path):
    """``render_stereo_video(do_basic_infill=True)`` file to file against
    the JAX package's, on test_torch_stereo.py's scene."""
    pytest.importorskip("cv2")
    from test_torch_stereo import assert_u8_budget, scene

    from metric_depth_video_toolbox_tpu.io import video as jvio
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    depth, color = scene(5, b=4)
    dpath = str(tmp_path / "clip_depth.mkv")
    cpath = str(tmp_path / "clip.mkv")
    jvio.save_depth_video(depth, dpath, 24, 100.0)
    jvio.save_rgb_video(color, cpath, 24)
    outs = {}
    for name, mod in (("jax", jst), ("torch", tst)):
        kw = {"device": "cpu"} if name == "torch" else {}
        out = mod.render_stereo_video(
            dpath, color_video=cpath, output=str(tmp_path / f"{name}.mkv"),
            xfov=60.0, convergence_depths=[2.0] * 4, infill_mask=True,
            do_basic_infill=True, batch_size=2, **kw)
        with tvio.VideoReader(out) as r:
            outs[name] = r.read_all()
    assert outs["torch"].shape == (4, 48, 128, 3)
    assert_u8_budget(outs["torch"], outs["jax"])


def test_stereo_cli_do_basic_infill_reaches_the_renderer(monkeypatch):
    """``--do_basic_infill`` (not ported before) now runs: it turns the
    edge cull on and reaches ``render_stereo_video``."""
    from metric_depth_video_toolbox_tpu_torch.cli import stereo_rerender

    seen = {}
    monkeypatch.setattr(tst, "render_stereo_video",
                        lambda *a, **kw: seen.update(kw) or "out.mkv")
    args = stereo_rerender.build_parser().parse_args(
        ["--depth_video", "x.mkv", "--xfov", "60", "--do_basic_infill"])
    assert stereo_rerender.run(args, device="cpu") == "out.mkv"
    assert seen["do_basic_infill"] is True and seen["remove_edges"] is True


def test_infill_cli_basic_file_to_file(tmp_path, monkeypatch):
    """``mdvt-torch infill`` with its default engine, basic."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    sbs, mask = _sbs_and_mask(np.random.default_rng(8), 3, 36, 80)
    spath = str(tmp_path / "sbs.mkv")
    tvio.save_rgb_video(sbs, spath, 24)
    tvio.save_rgb_video(mask, spath + "_infillmask.mkv", 24)
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    tmain.main(["infill", "--sbs_color_video", spath])
    with tvio.VideoReader(spath + "_infilled.mkv") as r:
        got = r.read_all()
    want = tiv.basic_infill_frame(torch.from_numpy(sbs),
                                  torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
