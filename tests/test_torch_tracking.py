"""Point tracking in the port (``models/tracker.py``, ``models/cotracker.py``,
``pipeline/tracking.py``, ``cli/track_points_in_video.py``) against the JAX
package on the same numpy-seeded inputs and the same weights.

Tolerances (float32 on the CPU):
- corner response: 1e-5 of the largest; grid queries: points and validity
  exactly equal (the same numpy generator draws the jitter);
- ``lk_advance`` / ``lk_track_clip``: positions within 1e-3 px where both
  keep the track, validity equal on all but 0.1% of (frame, track)
  entries (none at these sizes);
- ``CoTrackerLite``: 1e-5 of the largest trajectory value;
- ``CoTracker3`` at COTRACKER3_TINY: coordinates, visibility and
  confidence within 1e-4 of the largest (its flow embedding multiplies
  coordinates by up to 1000 / C * (C - 2) before a sine, so an iteration
  that moves a point tens of pixels turns float32 rounding into visible
  differences; the shared tree scales ``flow_head`` by 0.01, as a trained
  head's small updates would);
- the clip resize 1080p -> 384 x 512 (antialiased bilinear): 1e-4 of 255;
- ``track`` file to file: the same global ids per frame, positions within
  1e-3 px, the visualization video within 1 code.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.cli import track_points_in_video as jcli
from metric_depth_video_toolbox_tpu.io import video as jvio
from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu.models import cotracker as jct
from metric_depth_video_toolbox_tpu.models import tracker as jtrk
from metric_depth_video_toolbox_tpu_torch.cli import \
    track_points_in_video as tcli
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import cotracker as tct
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import tracker as ttrk
from metric_depth_video_toolbox_tpu_torch.ops import image as tim
from metric_depth_video_toolbox_tpu_torch.pipeline import tracking as ttracking
from port_helpers import _one_torch_thread, init_like  # noqa: F401

H, W, T = 72, 96, 10


def rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-12)


def panning(t=T, h=H, w=W, seed=0, step=2):
    """A textured clip panning ``step`` px a frame (uint8 (t, h, w, 3))."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h // 4 + 1, (w + step * t) // 4 + 1, 3),
                        dtype=np.uint8)
    tex = np.kron(base, np.ones((4, 4, 1), np.uint8))
    smooth = np.asarray(jax.image.resize(
        jnp.asarray(tex, jnp.float32), tex.shape, "linear"))
    frames = np.stack([smooth[:h, i * step:i * step + w] for i in range(t)])
    return frames.astype(np.uint8)


def test_corner_response_and_grid_queries_match_jax():
    frame = panning()[0]
    want = np.asarray(jtrk.corner_response(jnp.asarray(frame)))
    got = ttrk.corner_response(torch.from_numpy(frame)).numpy()
    assert rel(got, want) < 1e-5
    for jitter in (True, False):
        jp, jok = jtrk.generate_grid_queries(
            frame, grid=12, rng=np.random.default_rng(3), jitter=jitter)
        tp, tok = ttrk.generate_grid_queries(
            frame, grid=12, rng=np.random.default_rng(3), jitter=jitter)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tok, jok)
        assert 0 < tok.sum() < tok.size


def assert_tracks_close(traj, vis, jtraj, jvis):
    """Validity equal on all but 0.1% of entries; positions within 1e-3 px
    where both keep the track."""
    vis, jvis = np.asarray(vis) > 0, np.asarray(jvis) > 0
    assert (vis != jvis).sum() <= int(0.001 * vis.size)
    both = vis & jvis
    assert both.sum() > 0
    assert np.abs(np.asarray(traj)[both] - np.asarray(jtraj)[both]).max() \
        < 1e-3


def test_lk_advance_and_clip_match_jax():
    frames = panning()
    pts, ok = jtrk.generate_grid_queries(frames[0], grid=8)
    jnew, jres = jtrk.lk_advance(jnp.asarray(frames[0]),
                                 jnp.asarray(frames[1]), jnp.asarray(pts))
    tnew, tres = ttrk.lk_advance(torch.from_numpy(frames[0]),
                                 torch.from_numpy(frames[1]),
                                 torch.from_numpy(pts))
    assert np.abs(tnew.numpy() - np.asarray(jnew)).max() < 1e-3
    assert np.abs(tres.numpy() - np.asarray(jres)).max() < 1e-3
    # the pan moves every point 2 px left
    assert np.abs(np.median(tnew.numpy()[:, 0] - pts[:, 0]) + 2.0) < 0.1
    jtraj, jvis = jtrk.lk_track_clip(jnp.asarray(frames), jnp.asarray(pts),
                                     jnp.asarray(ok))
    traj, vis = ttrk.lk_track_clip(torch.from_numpy(frames),
                                   torch.from_numpy(pts),
                                   torch.from_numpy(ok))
    assert traj.shape == (T, 64, 2) and vis.shape == (T, 64)
    assert_tracks_close(traj.numpy(), vis.numpy(), jtraj, jvis)


def test_cotracker_lite_matches_jax():
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (3, 32, 40, 3)).astype(np.uint8)
    q = rng.uniform(4, 28, (5, 2)).astype(np.float32)
    jm = jtrk.CoTrackerLite(dim=16)
    tree = init_like(jm, 0, jnp.asarray(frames), jnp.asarray(q))
    want = np.asarray(jm.apply(tree, jnp.asarray(frames), jnp.asarray(q)))
    tm = from_jax.load_params(ttrk.CoTrackerLite(dim=16), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(frames), torch.from_numpy(q)).numpy()
    assert got.shape == (3, 5, 2)
    assert rel(got, want) < 1e-5


def cotracker_tree(cfg, seed, t=4, n=3):
    """A shared CoTracker3 tree: flow_head scaled by 0.01, and
    vis_conf_head's bias at 3 (visibility * confidence above the engine's
    0.6 threshold)."""
    h, w = cfg.model_resolution
    tree = init_like(jct.CoTracker3(cfg), seed,
                     jnp.zeros((t, h, w, 3)), jnp.zeros((n, 3)))
    uf = tree["params"]["updateformer"]
    uf["flow_head"]["kernel"] = uf["flow_head"]["kernel"] * 0.01
    uf["vis_conf_head"]["bias"] = np.full_like(uf["vis_conf_head"]["bias"],
                                               3.0)
    return tree


def test_cotracker3_tiny_matches_jax():
    cfg = jct.COTRACKER3_TINY
    rng = np.random.default_rng(2)
    video = rng.uniform(0, 255, (4, 48, 64, 3)).astype(np.float32)
    queries = np.array([[0, 10.3, 12.7], [1, 30.1, 20.4], [0, 50.0, 40.2],
                        [3, 63.5, 47.5]], np.float32)
    tree = cotracker_tree(cfg, 1)
    want = jct.CoTracker3(cfg).apply(tree, jnp.asarray(video),
                                     jnp.asarray(queries))
    tm = from_jax.load_params(tct.CoTracker3(tct.COTRACKER3_TINY), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(video), torch.from_numpy(queries))
    for key in ("coords", "vis", "conf"):
        assert got[key].shape == want[key].shape
        assert rel(got[key].numpy(), want[key]) < 1e-4, key
    # the encoder alone, tighter
    x = 2.0 * (video / 255.0) - 1.0
    jf = jct.BasicEncoder(cfg).apply({"params": tree["params"]["fnet"]},
                                     jnp.asarray(x))
    with torch.no_grad():
        tf = tm.fnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel(tf.permute(0, 2, 3, 1).numpy(), jf) < 1e-5


def test_clip_resize_1080p_to_model_resolution_matches_jax():
    """The CoTracker3 engine's shrink of a 1080p clip to 384 x 512 (and
    the DROID working size's 1080p -> 192 x 336): antialiased bilinear as
    ``jax.image.resize``; a tiny frame would not exercise the antialias."""
    rng = np.random.default_rng(4)
    clip = rng.integers(0, 255, (2, 1080, 1920, 3)).astype(np.float32)
    for hw in ((384, 512), (192, 336)):
        want = np.asarray(jax.image.resize(jnp.asarray(clip),
                                           (2,) + hw + (3,), "bilinear"))
        got = tim.resize(torch.from_numpy(clip), hw).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-4 * 255


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("track") / "clip.mkv")
    jvio.save_rgb_video(panning(), path, 24)
    return path


def read_tracks(path):
    with open(path) as f:
        return [{int(g): (x, y) for g, x, y in np.asarray(fr).reshape(-1, 3)}
                for fr in json.load(f)]


def assert_track_files_close(got_path, want_path):
    got, want = read_tracks(got_path), read_tracks(want_path)
    assert len(got) == len(want) == T
    entries = sum(len(f) for f in want)
    mismatched = sum(len(set(g) ^ set(w)) for g, w in zip(got, want))
    assert mismatched <= int(0.001 * entries)
    assert entries > 0
    for g, w in zip(got, want):
        for gid in set(g) & set(w):
            assert np.abs(np.subtract(g[gid], w[gid])).max() < 1e-3


def run_both(clip, tmp_path, argv, jax_setup=None, torch_device="cpu"):
    """The JAX CLI's outputs moved aside, then the port's in place."""
    jcli.run(jcli.build_parser().parse_args(["--color_video", clip] + argv))
    out = clip + "_tracking.json"
    jout = str(tmp_path / "jax_tracking.json")
    import shutil
    shutil.move(out, jout)
    if "--track_visualization" in argv:
        shutil.move(out + "_tracked.mkv", jout + "_tracked.mkv")
    tcli.run(tcli.build_parser().parse_args(["--color_video", clip] + argv),
             device=torch_device)
    return out, jout


@pytest.mark.parametrize("argv", [
    ["--grid", "8", "--clip_len", "6"],
    ["--grid", "8", "--clip_len", "4", "--steps_between_track_init", "2",
     "--downscale", "2", "--nr_iterations", "2", "--track_visualization"],
], ids=["lk", "lk_downscale_stagger_viz"])
def test_track_file_to_file_matches_jax(clip, tmp_path, argv):
    out, jout = run_both(clip, tmp_path, argv)
    assert_track_files_close(out, jout)
    if "--track_visualization" in argv:
        got = tvio.read_video_frames(out + "_tracked.mkv")[0].astype(int)
        want = tvio.read_video_frames(jout + "_tracked.mkv")[0].astype(int)
        assert got.shape == want.shape == (T, H, W, 3)
        assert np.abs(got - want).max() <= 1


def test_track_cotracker3_file_to_file_matches_jax(clip, tmp_path,
                                                   monkeypatch):
    """``track --engine cotracker3 --weights`` with a converted file: the
    engine's default configuration (COTRACKER3) is the tiny one here in
    both packages, its model resolution 48 x 64 (the 72 x 96 clip shrinks,
    antialiased)."""
    monkeypatch.setattr(jct, "COTRACKER3", jct.COTRACKER3_TINY)
    monkeypatch.setattr(tct, "COTRACKER3", tct.COTRACKER3_TINY)
    ckpt = str(tmp_path / "cotracker3.msgpack")
    jconvert.save_checkpoint(ckpt, cotracker_tree(jct.COTRACKER3_TINY, 5,
                                                  t=6, n=64))
    out, jout = run_both(clip, tmp_path, [
        "--grid", "8", "--clip_len", "6", "--engine", "cotracker3",
        "--weights", ckpt])
    assert_track_files_close(out, jout)


def test_cotracker3_pth_loads_like_jax(tmp_path):
    """``--weights x.pth``: the upstream state dict converted on load, its
    configuration read from the shapes (flow embedding C = 64)."""
    from test_weight_exact_cotracker import TCoTracker3
    import dataclasses
    cfg = dataclasses.replace(jct.COTRACKER3_TINY, flow_embed_dim=64)
    torch.manual_seed(0)
    sd = TCoTracker3(cfg).state_dict()
    path = str(tmp_path / "scaled_offline.pth")
    torch.save(sd, path)
    params, tcfg = ttracking.load_cotracker3(path)
    want = jconvert.convert_cotracker3({k: v.numpy() for k, v in sd.items()})
    jcfg = jconvert.cotracker3_config_from_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), params, want))
    eng = tct.CoTracker3Engine(tcfg, params=params, device="cpu")
    assert eng.cfg.corr_levels == cfg.corr_levels


def test_cotracker3_engine_matches_jax():
    """``CoTracker3Engine.track_clip``: resize, chunks of queries (here 3
    of 2 with 1 padded), the rescale and the visibility threshold."""
    cfg = jct.COTRACKER3_TINY
    tree = cotracker_tree(cfg, 6, t=5, n=2)
    frames = panning(t=5)
    pts = np.array([[20.0, 30.0], [50.5, 40.2], [70.1, 20.7], [40.0, 60.0],
                    [10.0, 10.0]], np.float32)
    valid = np.array([1, 1, 0, 1, 1], np.float32)
    jtraj, jvis = jct.CoTracker3Engine(cfg, params=tree, track_chunk=2) \
        .track_clip(frames, pts, valid)
    traj, vis = tct.CoTracker3Engine(tct.COTRACKER3_TINY, params=tree,
                                     track_chunk=2, device="cpu") \
        .track_clip(frames, pts, valid)
    assert traj.shape == (5, 5, 2)
    assert_tracks_close(traj, vis, jtraj, jvis)
    assert vis[:, 2].sum() == 0


def test_track_seeded_cotracker3_runs(clip, tmp_path, monkeypatch):
    """Without --weights the engine draws seeded weights."""
    monkeypatch.setattr(tct, "COTRACKER3", tct.COTRACKER3_TINY)
    out = tcli.run(tcli.build_parser().parse_args(
        ["--color_video", clip, "--grid", "6", "--clip_len", "10",
         "--engine", "cotracker3"]), device="cpu")
    assert len(read_tracks(out)) == T
