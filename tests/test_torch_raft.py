"""RAFT optical flow in the port (``models/raft.py``, ``cli/optical_flow.py``)
against the JAX package on the same numpy-seeded frames and the same
weights.

Tolerances (float32 on the CPU): the flow within 1e-4 of its largest
magnitude; the correlation pyramid within 1e-5 of its largest entry; the
colour coding and the flow video within 1 code (a hue at a sector
boundary may round either way).

The frames are 72 x 64: a 9 x 8 feature grid, so the correlation pyramid's
average pool drops an odd last row (9 -> 4), as 1080p's 135-row grid does
(135 -> 67 -> 33 -> 16).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.cli import optical_flow as jcli
from metric_depth_video_toolbox_tpu.io import video as jvio
from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu.models import raft as jraft
from metric_depth_video_toolbox_tpu_torch.cli import optical_flow as tcli
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import raft as traft
from port_helpers import _one_torch_thread, init_like  # noqa: F401

H, W = 72, 64


def frames(n, seed=0):
    """n frames of a smooth texture panning 3 px right, 1 px down a
    frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (H // 4 + 8, W // 4 + 8, 3)).astype(
        np.float32)
    tex = np.asarray(jax.image.resize(jnp.asarray(base),
                                      (4 * base.shape[0], 4 * base.shape[1],
                                       3), "linear"))
    return np.stack([tex[i:i + H, 3 * i:3 * i + W]
                     for i in range(n)]).astype(np.uint8)


@pytest.fixture(scope="module")
def tree():
    a = jnp.zeros((1, H, W, 3), jnp.uint8)
    return init_like(jraft.RAFT(jraft.RAFT_TINY), 3, a, a)


def test_raft_tiny_matches_jax(tree):
    clip = frames(3)
    a, b = clip[:2], clip[1:]
    want = np.asarray(jraft.RAFT(jraft.RAFT_TINY).apply(
        tree, jnp.asarray(a), jnp.asarray(b)))
    model = from_jax.load_params(traft.RAFT(traft.RAFT_TINY), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        single = model(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    assert got.shape == want.shape == (2, H, W, 2)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-4 * scale
    assert torch.equal(single, torch.from_numpy(got[0]))
    rgb_want = np.asarray(jax.vmap(jraft.flow_to_rgb)(jnp.asarray(want)))
    rgb_got = traft.flow_to_rgb(torch.from_numpy(got)).numpy()
    assert rgb_got.dtype == np.uint8
    assert np.abs(rgb_got.astype(int) - rgb_want.astype(int)).max() <= 1


def test_corr_pyramid_and_lookup_odd_height_match_jax():
    rng = np.random.default_rng(5)
    f1 = rng.standard_normal((2, 9, 8, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 9, 8, 16)).astype(np.float32)
    want = jraft._corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3)
    got = traft._corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2), 3)
    assert [tuple(g.shape) for g in got] == [(144, 9, 8), (144, 4, 4),
                                             (144, 2, 2)]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-5 * np.abs(
            np.asarray(w)).max()
    coords = rng.uniform(-2, 10, (2, 9, 8, 2)).astype(np.float32)
    lw = np.asarray(jraft._lookup(want, jnp.asarray(coords), 2))
    lg = traft._lookup(got, torch.from_numpy(coords), 2).numpy()
    assert lg.shape == lw.shape == (2, 9, 8, 3 * 25)
    assert np.abs(lg - lw).max() < 1e-5 * np.abs(lw).max()


def test_raft_on_a_grid_too_small_for_its_pyramid_matches_jax():
    """40-row frames at four levels: a 5-row feature grid, so the last
    level has no rows; its lookups read zeros in both packages."""
    import dataclasses
    rng = np.random.default_rng(7)
    a = rng.integers(0, 255, (1, 40, 64, 3)).astype(np.uint8)
    b = np.roll(a, 3, axis=2)
    jcfg = dataclasses.replace(jraft.RAFT_TINY, corr_levels=4, iters=2)
    tree = init_like(jraft.RAFT(jcfg), 9, jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(jraft.RAFT(jcfg).apply(tree, jnp.asarray(a),
                                             jnp.asarray(b)))
    model = from_jax.load_params(traft.RAFT(dataclasses.replace(
        traft.RAFT_TINY, corr_levels=4, iters=2)), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()


def test_flow_to_rgb_matches_jax():
    rng = np.random.default_rng(6)
    flow = rng.standard_normal((2, 16, 24, 2)).astype(np.float32) * 5
    want = np.asarray(jax.vmap(jraft.flow_to_rgb)(jnp.asarray(flow)))
    got = traft.flow_to_rgb(torch.from_numpy(flow)).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    fixed = traft.flow_to_rgb(torch.from_numpy(flow[0]), max_mag=3.0).numpy()
    want0 = np.asarray(jraft.flow_to_rgb(jnp.asarray(flow[0]), max_mag=3.0))
    assert np.abs(fixed.astype(int) - want0.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def files(tmp_path_factory, tree):
    d = tmp_path_factory.mktemp("flow")
    clip = str(d / "clip.mkv")
    jvio.save_rgb_video(frames(6), clip, 24)
    ckpt = str(d / "raft.msgpack")
    jconvert.save_checkpoint(ckpt, tree)
    return clip, ckpt


@pytest.mark.parametrize("last_mode,batch", [("prev", "4"), ("self", "2"),
                                             ("none", "3")])
def test_flow_file_to_file_matches_jax(files, tmp_path, monkeypatch,
                                       last_mode, batch):
    """``flow`` on a converted checkpoint at RAFT_TINY (the commands' fixed
    RAFT_LARGE made tiny in both packages), each ``--last_mode``, batches
    of 4 (one flush of 4 + 1), 2 and 3."""
    monkeypatch.setattr(jraft, "RAFTConfig", lambda: jraft.RAFT_TINY)
    monkeypatch.setattr(traft, "RAFT_LARGE", traft.RAFT_TINY)
    clip, ckpt = files
    argv = ["--color_video", clip, "--checkpoint", ckpt, "--last_mode",
            last_mode, "--batch_size", batch, "--amp", "--channels_last"]
    out = clip + "_flow.mkv"
    jcli.run(jcli.build_parser().parse_args(argv))
    want_path = str(tmp_path / "jax_flow.mkv")
    shutil.move(out, want_path)
    tcli.run(tcli.build_parser().parse_args(argv + ["--cpu"]))
    got = tvio.read_video_frames(out)[0].astype(int)
    want = tvio.read_video_frames(want_path)[0].astype(int)
    n = {"prev": 6, "self": 6, "none": 5}[last_mode]
    assert got.shape == want.shape == (n, H, W, 3)
    assert np.abs(got - want).max() <= 1
    if last_mode == "prev":
        assert np.array_equal(got[-1], got[-2])
