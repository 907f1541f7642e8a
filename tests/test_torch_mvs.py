"""The port's MVSAnywhere-class MVS (``models/mvs.py``, ``MVSEngine`` and
``run_mvsa`` in ``pipeline/depth.py``, ``engine mvsa``) and
``ops/solvers.py::median_ratio_scale`` against the JAX package.

Tolerances: ``median_ratio_scale`` and ``median`` exact (the same float32
values sorted; the even count's mean as ``jnp.median`` rounds it); the
sweep coordinates within 1e-5 pixels; ``MVSNet`` at MVS_TINY in float32
within 1e-5 of the largest output (float32 sums in other orders; the cost
volume summed view by view here), its mask exact; the engine's depth within
1e-4 of the largest depth (the refinement's clip and the rescale's median
pick among the same values); the CLI's depth video within one 16-bit code
on at most 1% of the pixels.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.cli import depth_engines as jcli
from metric_depth_video_toolbox_tpu.models import mvs as jmvs
from metric_depth_video_toolbox_tpu.ops import solvers as jsolvers
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu_torch.cli import depth_engines as tcli
from metric_depth_video_toolbox_tpu_torch.io import checkpoint as tckpt
from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import mvs as tmvs
from metric_depth_video_toolbox_tpu_torch.ops import solvers as tsolvers
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from port_helpers import _one_torch_thread  # noqa: F401
from test_torch_diffusion import assert_rel, flax_like

N, H, W = 5, 40, 64         # resize_w 32: a 20 x 32 working size, 5 x 8
KEY = jax.random.PRNGKey(0)


# ------------------------------------------------- median_ratio_scale ----

@pytest.mark.parametrize("n", [257, 256], ids=["odd", "even"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_median_ratio_scale_matches_jax_exactly(n, weighted):
    rng = np.random.default_rng(n + weighted)
    ref = rng.uniform(0.5, 4.0, n).astype(np.float32)
    pred = rng.uniform(0.5, 4.0, n).astype(np.float32)
    pred[:3] = 0.0                      # clamped to eps in both
    ref[5:9] = ref[9:13]                # ties
    pred[5:9] = pred[9:13]
    w = (rng.random(n) > 0.3).astype(np.float32) if weighted else None
    want = np.asarray(jsolvers.median_ratio_scale(
        jnp.asarray(ref), jnp.asarray(pred),
        None if w is None else jnp.asarray(w)))
    got = tsolvers.median_ratio_scale(
        torch.from_numpy(ref), torch.from_numpy(pred),
        None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.numpy().tobytes() == want.tobytes()
    assert tsolvers.median(torch.from_numpy(ref)).numpy().tobytes() == \
        np.median(ref).astype(np.float32).tobytes()


def test_weighted_median_of_all_zero_weights_is_the_smallest_ratio():
    ref = np.asarray([3.0, 1.0, 2.0], np.float32)
    pred = np.ones(3, np.float32)
    w = np.zeros(3, np.float32)
    want = jsolvers.median_ratio_scale(jnp.asarray(ref), jnp.asarray(pred),
                                       jnp.asarray(w))
    got = tsolvers.median_ratio_scale(torch.from_numpy(ref),
                                      torch.from_numpy(pred),
                                      torch.from_numpy(w))
    assert float(got) == float(want) == 1.0


# ------------------------------------------------------------- MVSNet ----

CFG_J = dataclasses.replace(jmvs.MVS_TINY, dtype="float32")
CFG_T = dataclasses.replace(tmvs.MVS_TINY, dtype="float32")


def poses(n, seed=0):
    """A smooth seeded camera path, camera-to-world (n, 4, 4) float32."""
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ph = rng.uniform(0, 6.28, 3)
    for i in range(n):
        a = 0.02 * np.sin(0.5 * i + ph[0])
        out[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        out[i, :3, 3] = [0.05 * i, 0.01 * np.sin(i + ph[1]),
                         0.02 * np.cos(i + ph[2])]
    return out


def k_feat(h, w, xfov=60.0):
    from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
    k = np.asarray(jgeo.camera_matrix_from_fov(w, h, xfov))
    return (np.diag([0.25, 0.25, 1.0]) @ k).astype(np.float32)


def mvs_tree(seed, hw=(20, 32), v=2):
    net = jmvs.MVSNet(CFG_J)
    z, zs = jnp.zeros(hw + (3,)), jnp.zeros((v,) + hw + (3,))
    kf = jnp.asarray(k_feat(*hw))
    return flax_like(jax.eval_shape(lambda: net.init(
        KEY, z, zs, kf, jnp.tile(jnp.eye(4), (v, 1, 1)), jnp.ones((v,)))),
        seed)


def test_sweep_coords_match_jax():
    kf = k_feat(20, 32)
    rel = np.linalg.inv(poses(3)[1:]) @ poses(3)[0]
    inv = np.asarray(jmvs.inverse_depth_hypotheses(CFG_J))
    want_xy, want_front = jmvs.sweep_coords(
        jnp.asarray(kf), jnp.linalg.inv(kf), jnp.asarray(rel),
        jnp.asarray(inv), 5, 8)
    got_inv = tmvs.inverse_depth_hypotheses(CFG_T)
    np.testing.assert_allclose(got_inv.numpy(), inv, rtol=1e-6, atol=0)
    got_xy, got_front = tmvs.sweep_coords(
        torch.from_numpy(kf), torch.linalg.inv(torch.from_numpy(kf)),
        torch.from_numpy(rel.astype(np.float32)), got_inv, 5, 8)
    np.testing.assert_allclose(got_xy.numpy(), np.asarray(want_xy),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got_front.numpy(), np.asarray(want_front))


@torch.no_grad()
def test_mvsnet_matches_flax():
    """A batch of 2 reference frames, 2 source views each (one marked
    invalid in the second frame), on one tree."""
    tree = mvs_tree(1)
    rng = np.random.default_rng(2)
    ref = rng.random((2, 20, 32, 3)).astype(np.float32)
    src = rng.random((2, 2, 20, 32, 3)).astype(np.float32)
    c2w = poses(3)
    rel = np.stack([np.linalg.inv(c2w[1:]) @ c2w[0]] * 2).astype(np.float32)
    valid = np.asarray([[1.0, 1.0], [1.0, 0.0]], np.float32)
    kf = k_feat(20, 32)
    net = jmvs.MVSNet(CFG_J)
    want = jax.jit(jax.vmap(lambda r, s, p, v: net.apply(
        tree, r, s, jnp.asarray(kf), p, v)))(ref, src, rel, valid)
    model = from_jax.load_flax_params(tmvs.MVSNet(CFG_T), tree).eval()
    got = tmvs.infer_batch(model, torch.from_numpy(
        (ref * 255).round().astype(np.uint8)), torch.from_numpy(
            (src * 255).round().astype(np.uint8)), torch.from_numpy(kf),
        torch.from_numpy(rel), torch.from_numpy(valid))
    want_u8 = jax.jit(lambda r, s: jmvs.infer_batch(
        net.apply, tree, r, s, jnp.asarray(kf), jnp.asarray(rel),
        jnp.asarray(valid)))((ref * 255).round().astype(np.uint8),
                             (src * 255).round().astype(np.uint8))
    for key in ("depth", "depth_cv", "confidence"):
        assert_rel(got[key].numpy(), want_u8[key], 1e-5)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want_u8["mask"]))
    out = model(torch.from_numpy(ref), torch.from_numpy(src),
                torch.from_numpy(kf), torch.from_numpy(rel),
                torch.from_numpy(valid))
    assert_rel(out["depth"].numpy(), want["depth"], 1e-5)
    assert out["depth"].shape == (2, 20, 32)


# ------------------------------------------------------------- engine ----

def clip(seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (12, 20, 3), np.uint8)
    tex = np.kron(base, np.ones((4, 4, 1), np.uint8))
    return np.stack([np.roll(tex, 2 * i, axis=1)[:H, :W]
                     for i in range(N)])


@pytest.fixture
def float32_mvs(monkeypatch):
    """Both packages' MVS presets in float32."""
    for mod in (jmvs, tmvs):
        def preset(*a, _orig=mod.preset, **kw):
            return dataclasses.replace(_orig(*a, **kw), dtype="float32")
        monkeypatch.setattr(mod, "preset", preset)


@pytest.mark.parametrize("rescale", [False, True], ids=["plain", "rescale"])
def test_mvs_engine_matches_jax(float32_mvs, rescale):
    """Window 3 (one source view a side, the clip's first and last frames
    padded with an invalid view), batches of 2 (the last one padded), the
    20 x 32 result resized back by nearest neighbour; with the rescale to
    the cost volume's median ratio."""
    tree = mvs_tree(4)
    kw = dict(size="tiny", window=3, resize_w=32, batch=2, params=tree,
              rescale_to_cost_volume=rescale)
    jeng = jdepth.MVSEngine(data_parallel=False, **kw)
    teng = tdepth.MVSEngine(device="cpu", **kw)
    for i in range(N):
        assert teng._window_indices(i, N) == jeng._window_indices(i, N)
    assert teng._window_indices(0, N) == ([1, 0], [1.0, 0.0])
    frames, c2w = clip(), poses(N)
    want = jeng.infer_video(frames, c2w, 60.0)
    got = teng.infer_video(frames, c2w, 60.0)
    assert got.shape == want.shape == (N, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_fast_cost_volume_halves_the_hypotheses():
    for size, want in (("base", 32), ("tiny", 8)):
        eng = tdepth.MVSEngine(size=size, fast_cost_volume=True,
                               device="cpu")
        assert eng.cfg.num_depths == want == jdepth.MVSEngine(
            size=size, fast_cost_volume=True, data_parallel=False
        ).cfg.num_depths


def test_mvsa_cli_matches_jax(float32_mvs, tmp_path, monkeypatch):
    """``engine mvsa`` file to file through both CLIs, on one converted
    checkpoint file (read by both), ``--model_size tiny``,
    ``--rescale_to_cost_volume``."""
    pytest.importorskip("cv2")
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    ckpt = str(tmp_path / "mvs.msgpack")
    tckpt.save_checkpoint(ckpt, mvs_tree(5))
    monkeypatch.setattr(jdepth.MVSEngine, "__init__", lambda self, *a,
                        _i=jdepth.MVSEngine.__init__, **kw: _i(
                            self, *a, **dict(kw, data_parallel=False)))
    paths = {}
    for pkg, main in (("jax", jcli.mvsa_main), ("torch", tcli.mvsa_main)):
        os.makedirs(tmp_path / pkg)
        c = str(tmp_path / pkg / "c.mkv")
        tvio.save_rgb_video(clip(), c, 24)
        sidecar.save_transformations(c + "_t.json", poses(N))
        main(["--color_video", c, "--transformation_file", c + "_t.json",
              "--xfov", "60", "--model_size", "tiny", "--window", "3",
              "--resize_w", "32", "--checkpoint", ckpt,
              "--rescale_to_cost_volume"])
        paths[pkg] = c + "_depth.mkv"
    codes = {}
    for pkg, path in paths.items():
        with tvio.VideoReader(path) as r:
            rgb = r.read_all().astype(np.int64)
        codes[pkg] = rgb[..., 0] * 256 + rgb[..., 2]
    d = np.abs(codes["torch"] - codes["jax"])
    assert codes["torch"].shape == (N, H, W)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01


def test_movie_mvsa_falls_back_to_single_frame_like_jax(tmp_path,
                                                        monkeypatch, capsys):
    """The movie's ``mvsa`` has no camera track: both packages run the
    single-frame two-pass flow instead, with the same message."""
    from metric_depth_video_toolbox_tpu.pipeline import movie as jmovie
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie as tmovie

    calls = []
    for movie in (jmovie, tmovie):
        monkeypatch.setattr(
            movie, "_two_pass_single_frame",
            lambda videos, variant, max_depth, kw: calls.append(
                (videos, variant, max_depth)))
    for pkg, movie in (("jax", jmovie), ("torch", tmovie)):
        scenes = [{"Scene Number": "7", "finished": False,
                   "scene_video_file": f"{pkg}.mkv",
                   "depth_video_file": str(tmp_path / "none.mkv")}]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        movie.step2_estimate_depth(scenes, engine="mvsa", max_depth=50.0,
                                   **kw)
    assert calls == [(["jax.mkv"], "da", 50.0), (["torch.mkv"], "da", 50.0)]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "mvsa" in ln]
    assert len(lines) == 2 and lines[0] == lines[1] == (
        "scene 7: mvsa needs --transformation_file; using single_frame "
        "instead")
