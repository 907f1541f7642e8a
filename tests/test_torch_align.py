"""The camera aligner in the port (``pipeline/align.py``,
``cli/align_3d_points.py``) against the JAX package on the same synthetic
scene: a textured tilted plane seen by a camera that moves and yaws, its
depth video (16-bit RGB-encoded, max depth 100 m) and tracks that are the
projections of points on the plane.

The hybrid solver (``--use_madpose``) draws its minimal sets from a
``torch.Generator`` in the port and from ``jax.random`` in the JAX
package; here the port is fed the JAX package's draws (the same
``categorical`` under ``PRNGKey(0)`` on the pair's validity), so both
solve from the same sets.

Tolerances (float32 on the CPU): each solver's 4x4 transform within 1e-4
of its largest entry, the hybrid scale within 1e-4; the chained poses in
``*_transformations.json`` within 1e-4; the diagnostics' numbers within
1e-4 relative; the debug overlay video within 1 code on all but 0.1% of
its bytes (a reprojected point is drawn at the integer part of its pixel
position).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.cli import align_3d_points as jcli
from metric_depth_video_toolbox_tpu.io import sidecar as jsidecar
from metric_depth_video_toolbox_tpu.io import video as jvio
from metric_depth_video_toolbox_tpu.pipeline import align as jalign
from metric_depth_video_toolbox_tpu_torch.cli import align_3d_points as tcli
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.pipeline import align as talign
from port_helpers import _one_torch_thread  # noqa: F401

H, W, T, N = 60, 80, 8, 48
XFOV = 60.0


def intrinsics():
    f = W / (2.0 * np.tan(np.deg2rad(XFOV) / 2.0))
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def c2w(fi):
    """Camera-to-world pose of frame fi: yaw 0.01 rad a frame, x 4 cm, z
    2 cm."""
    a = 0.01 * fi
    m = np.eye(4)
    m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                 [-np.sin(a), 0, np.cos(a)]]
    m[:3, 3] = [0.04 * fi, 0.0, 0.02 * fi]
    return m


# the plane n . X = d in world space
PLANE_N = np.array([-0.25, 0.15, 1.0])
PLANE_D = 4.0


def scene(seed=0):
    """-> (depth (T, H, W), tracks: list over frames of (n_i, 3) [gid, x,
    y], dense uv (T, N, 2), visible (T, N))"""
    k = intrinsics()
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    rays = np.stack([(xs - k[0, 2]) / k[0, 0], (ys - k[1, 2]) / k[1, 1],
                     np.ones_like(xs)], -1)
    rng = np.random.default_rng(seed)
    # world points on the plane, seen from frame 0
    u0 = rng.uniform(4, W - 4, N)
    v0 = rng.uniform(4, H - 4, N)
    r0 = np.stack([(u0 - k[0, 2]) / k[0, 0], (v0 - k[1, 2]) / k[1, 1],
                   np.ones(N)], -1)
    pts = r0 * (PLANE_D / (r0 @ PLANE_N))[:, None]
    depth = np.zeros((T, H, W), np.float32)
    uv = np.zeros((T, N, 2), np.float32)
    vis = np.zeros((T, N), bool)
    for fi in range(T):
        m = c2w(fi)
        rw = rays @ m[:3, :3].T                  # world ray directions
        s = (PLANE_D - m[:3, 3] @ PLANE_N) / (rw @ PLANE_N)
        depth[fi] = s                            # z in camera space = s
        w2c = np.linalg.inv(m)
        pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
        uv[fi, :, 0] = pc[:, 0] / pc[:, 2] * k[0, 0] + k[0, 2]
        uv[fi, :, 1] = pc[:, 1] / pc[:, 2] * k[1, 1] + k[1, 2]
        vis[fi] = ((uv[fi, :, 0] >= 1) & (uv[fi, :, 0] < W - 1)
                   & (uv[fi, :, 1] >= 1) & (uv[fi, :, 1] < H - 1))
    # a few tracks drift off the rigid motion (outliers for the RANSAC)
    uv[:, :4] += np.arange(T)[:, None, None] * 1.5
    tracks = [np.concatenate([np.nonzero(vis[fi])[0][:, None],
                              uv[fi, vis[fi]]], 1).astype(np.float32)
              for fi in range(T)]
    return depth, tracks, uv, vis


def jax_hybrid_draws(valid, hypotheses=64):
    """The JAX hybrid solver's minimal sets for validity ``valid``."""
    n = valid.shape[0]
    logits = jnp.log(jnp.maximum(jnp.asarray(valid, jnp.float32), 1e-9))
    idx = jax.random.categorical(
        jax.random.PRNGKey(0), jnp.broadcast_to(logits, (hypotheses * 3, n)),
        axis=-1)
    return np.array(idx.reshape(hypotheses, 3))


def pair_inputs(fi):
    depth, _, uv, vis = scene()
    valid = (vis[fi] & vis[fi - 1]).astype(np.float32)
    return (uv[fi], uv[fi - 1], depth[fi], depth[fi - 1], intrinsics(),
            valid)


@pytest.mark.parametrize("solver", ["two_group", "stationary", "hybrid"])
def test_solver_matches_jax(solver):
    args = pair_inputs(5)
    want = jalign.SOLVERS[solver](*map(jnp.asarray, args))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    if solver == "hybrid":
        got = talign.solve_pair_hybrid(
            *targs, samples=torch.from_numpy(jax_hybrid_draws(args[-1])))
        assert abs(float(got[1]) - float(want[1])) < 1e-4
        got, want = got[0], want[0]
    else:
        got = talign.SOLVERS[solver](*targs)
    want = np.asarray(want)
    assert got.shape == (4, 4)
    assert np.abs(got.numpy() - want).max() < 1e-4 * np.abs(want).max()


def test_hybrid_draws_from_its_generator():
    """Without given samples the port draws (hypotheses, 3) indices with
    its seeded generator, only among valid tracks here."""
    valid = torch.from_numpy(pair_inputs(5)[-1])
    a = talign.draw_hybrid_samples(valid)
    b = talign.draw_hybrid_samples(valid)
    assert a.shape == (64, 3) and torch.equal(a, b)
    assert bool((valid[a] > 0).all())
    m, s = talign.solve_pair_hybrid(
        *[torch.from_numpy(np.ascontiguousarray(x)) for x in pair_inputs(5)])
    assert torch.isfinite(m).all() and abs(float(s) - 1.0) < 0.05


def test_triangulation_diagnostics_match_jax():
    rng = np.random.default_rng(3)
    cur = np.concatenate([rng.uniform(0, 80, (30, 2)), np.ones((30, 1))],
                         1).astype(np.float32)
    past = cur.copy()
    past[:, :2] += rng.normal(0, 2, (30, 2))
    cur_z = rng.uniform(2, 5, 30).astype(np.float32)
    past_z = rng.uniform(2, 5, 30).astype(np.float32)
    args = (cur, cur_z, past, past_z, c2w(3).astype(np.float32),
            c2w(0).astype(np.float32), intrinsics())
    want = jalign._triangulation_diagnostics(*args)
    got = talign._triangulation_diagnostics(*args)
    assert got == want
    assert talign._triangulation_diagnostics(
        *args[:4], args[4], args[4], args[6]) is None


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("align")
    depth, tracks, _, _ = scene()
    depth_path = str(d / "clip.mkv_depth.mkv")
    jvio.save_depth_video(depth, depth_path, 24, 100.0)
    track_path = str(d / "clip.mkv_tracking.json")
    jsidecar.save_tracking(track_path, tracks)
    rng = np.random.default_rng(7)
    color = rng.integers(0, 255, (T, H, W, 3)).astype(np.uint8)
    color_path = str(d / "clip.mkv")
    jvio.save_rgb_video(color, color_path, 24)
    mask = np.zeros((T, H, W, 3), np.uint8)
    mask[3:, 40:50, 10:30] = 255
    mask_path = str(d / "clip.mkv_mask.mkv")
    jvio.save_rgb_video(mask, mask_path, 24)
    return {"depth": depth_path, "tracks": track_path, "color": color_path,
            "mask": mask_path}


def run_both(files, tmp_path, extra):
    argv = ["--depth_video", files["depth"], "--track_file", files["tracks"],
            "--xfov", str(XFOV)] + extra
    out = files["depth"] + "_transformations.json"
    moved = []
    jargs = jcli.build_parser().parse_args(argv)
    jcli.run(jargs)
    for path in (out, out + "_diagnostics.json",
                 files["depth"] + "_debug.mkv"):
        try:
            shutil.move(path, str(tmp_path / ("jax_" + path.split("/")[-1])))
            moved.append(path)
        except FileNotFoundError:
            pass
    samples = None
    if "--use_madpose" in extra:
        def samples(_fi, valid):
            return jax_hybrid_draws(valid)
    tcli.run(tcli.build_parser().parse_args(argv), device="cpu",
             hybrid_samples=samples)
    return {p: str(tmp_path / ("jax_" + p.split("/")[-1])) for p in moved}


@pytest.mark.parametrize("extra", [
    [], ["--assume_stationary_camera"], ["--use_madpose"],
    ["--mask_video", "MASK", "--strict_mask", "--diagnostics"],
    ["--mask_video", "MASK", "--color_video", "COLOR", "--max_frames", "6"],
], ids=["two_group", "stationary", "madpose", "strict_mask_diagnostics",
        "mask_debug_video"])
def test_align_file_to_file_matches_jax(files, tmp_path, extra):
    extra = [files["mask"] if a == "MASK" else
             files["color"] if a == "COLOR" else a for a in extra]
    jax_files = run_both(files, tmp_path, extra)
    out = files["depth"] + "_transformations.json"
    got = np.asarray(json.load(open(out)), np.float64)
    want = np.asarray(json.load(open(jax_files[out])), np.float64)
    n = 6 if "--max_frames" in extra else T
    assert got.shape == want.shape == (n, 4, 4)
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    if extra == ["--use_madpose"]:
        # the solved camera follows the scene's: x moves 4 cm a frame
        assert abs(got[-1][0, 3] - 0.04 * (T - 1)) < 0.05
    elif not extra:
        assert got[-1][0, 3] > 0.1
    if "--diagnostics" in extra:
        gd = json.load(open(out + "_diagnostics.json"))
        wd = json.load(open(jax_files[out + "_diagnostics.json"]))
        assert len(gd) == len(wd)
        for g, w in zip(gd, wd):
            assert g.keys() == w.keys()
            for key in g:
                assert abs(g[key] - w[key]) <= 1e-4 * max(abs(w[key]), 1.0)
    if "--color_video" in extra:
        dbg = files["depth"] + "_debug.mkv"
        got_v = tvio.read_video_frames(dbg)[0].astype(int)
        want_v = tvio.read_video_frames(jax_files[dbg])[0].astype(int)
        assert got_v.shape == want_v.shape == (6, H, W, 3)
        off = np.abs(got_v - want_v) > 1
        assert off.sum() <= 0.001 * off.size
