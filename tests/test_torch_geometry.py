"""The port's small public helpers against the JAX package on the CPU:
the geometry helpers (``ops/geometry.py``), ``ops/codec.py::
normalize_depth``, ``ops/image.py::rescale_to_side``,
``models/depth_anything.py::scale_shift_align_to_metric`` and
``utils/timer.py``.

Tolerances:
- the float geometry helpers within 1e-6 absolute, ``frustum_planes``
  within 1e-5 relative (a cross product and an inverse);
- the bool helpers (``points_in_frustum``, ``frustums_intersect``,
  ``disparity_steepness_mask``) exactly, on inputs that the test first
  shows to lie more than 1e-4 from every plane or threshold;
- ``normalize_depth`` within 1e-6 (its percentiles are values at an index,
  no interpolation), on data with NaN and +-inf and on all zeros;
- ``rescale_to_side`` exactly;
- ``scale_shift_align_to_metric`` within 1e-5 relative, s and t too;
- ``timer`` and ``Progress``: the printed text equal, both packages
  reading one fake clock (the port has no ``StageMetrics``: its spans,
  ``tests/test_torch_trace.py``, record the stages).
"""

import importlib
import io
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.ops import codec as jcodec
from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.ops import image as jim
from metric_depth_video_toolbox_tpu_torch import utils as tutils
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as tda
from metric_depth_video_toolbox_tpu_torch.ops import codec as tcodec
from metric_depth_video_toolbox_tpu_torch.ops import geometry as tgeo
from metric_depth_video_toolbox_tpu_torch.ops import image as tim
from port_helpers import _one_torch_thread  # noqa: F401

# the modules: both packages' utils/__init__.py bind ``timer`` to the function
jtimer = importlib.import_module("metric_depth_video_toolbox_tpu.utils.timer")
ttimer = importlib.import_module(
    "metric_depth_video_toolbox_tpu_torch.utils.timer")

MARGIN = 1e-4


def rigid(seed):
    """A seeded camera-to-world transform: a rotation about a random axis
    and a translation of about a metre."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(0.2, 1.0)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) + np.sin(a) * kx + (1 - np.cos(a)) * kx @ kx
    m[:3, 3] = rng.normal(size=3)
    return m.astype(np.float32)


def camera(w=64, h=48, fov=60.0):
    return np.array(jgeo.camera_matrix_from_fov(w, h, xfov_deg=fov),
                    np.float32)


def close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _float_case(name):
    """-> (JAX result, port result) of one float helper."""
    rng = np.random.default_rng(3)
    fovs = rng.uniform(30.0, 100.0, 5).astype(np.float32)
    side = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    ang = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
    depth = rng.uniform(0.5, 20.0, (2, 5, 6)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (2, 1, 1)).astype(np.float32)
    c2w = np.stack([rigid(s) for s in range(3)])
    t = torch.from_numpy
    return {
        "focal_scale_for_master_fov": (
            jgeo.focal_scale_for_master_fov(70.0, fovs),
            tgeo.focal_scale_for_master_fov(70.0, t(fovs))),
        "eye_view_transform": (
            jgeo.eye_view_transform(side, ang),
            tgeo.eye_view_transform(t(side), t(ang))),
        "eye_view_transform_reverse": (
            jgeo.eye_view_transform(0.0315, 0.02, reverse=True),
            tgeo.eye_view_transform(0.0315, 0.02, reverse=True)),
        "cv_to_gl_view": (jgeo.cv_to_gl_view(jnp.asarray(c2w)),
                          tgeo.cv_to_gl_view(t(c2w))),
        "apply_intrinsic_depth_scale": (
            jgeo.apply_intrinsic_depth_scale(jnp.asarray(depth), scale),
            tgeo.apply_intrinsic_depth_scale(t(depth), t(scale))),
        "deg2rad": (jgeo.deg2rad(jnp.asarray(fovs)),
                    tgeo.deg2rad(t(fovs))),
    }[name]


@pytest.mark.parametrize("name", [
    "focal_scale_for_master_fov", "eye_view_transform",
    "eye_view_transform_reverse", "cv_to_gl_view",
    "apply_intrinsic_depth_scale", "deg2rad"])
def test_float_geometry_helpers_match_jax(name):
    want, got = _float_case(name)
    assert tuple(got.shape) == tuple(np.shape(want))
    assert got.dtype == torch.float32
    close(got, want)


def frustum(k, near, far, c2w=None):
    """(JAX planes, JAX corners, port planes, port corners)."""
    jc2w = None if c2w is None else jnp.asarray(c2w)
    tc2w = None if c2w is None else torch.from_numpy(c2w)
    return (jgeo.frustum_planes(jnp.asarray(k), 64, 48, near, far, jc2w),
            jgeo.frustum_corners(jnp.asarray(k), 64, 48, near, far, jc2w),
            tgeo.frustum_planes(torch.from_numpy(k), 64, 48, near, far,
                                tc2w),
            tgeo.frustum_corners(torch.from_numpy(k), 64, 48, near, far,
                                 tc2w))


@pytest.mark.parametrize("posed", [False, True])
def test_frustum_planes_match_jax(posed):
    jp, _, tp, _ = frustum(camera(), 0.5, 12.0,
                           rigid(7) if posed else None)
    assert tuple(tp.shape) == (6, 4)
    close(tp, jp, atol=0.0, rtol=1e-5)


def signed(points, planes):
    """float64 signed distances (N, 6) of points to planes."""
    p = np.asarray(planes, np.float64)
    return np.asarray(points, np.float64) @ p[:, :3].T + p[None, :, 3]


def test_points_in_frustum_matches_jax():
    jp, _, tp, _ = frustum(camera(), 0.5, 12.0, rigid(7))
    rng = np.random.default_rng(5)
    pts = (rigid(7)[:3, :3] @ rng.uniform([-8, -6, 0], [8, 6, 14],
                                          (400, 3)).T).T + rigid(7)[:3, 3]
    pts = pts.astype(np.float32)
    d = signed(pts, jp)
    pts = pts[np.all(np.abs(d) > MARGIN, axis=1)]
    assert len(pts) > 300
    want = np.asarray(jgeo.points_in_frustum(jnp.asarray(pts), jp))
    assert 0.1 < want.mean() < 0.9
    got = tgeo.points_in_frustum(torch.from_numpy(pts), tp)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shift,meets", [(0.3, True), (40.0, False)])
def test_frustums_intersect_matches_jax(shift, meets):
    """Frustum b turned 0.1 rad about y and moved by (shift, 0.13, 0.37)
    from frustum a: overlapping, then far apart."""
    k = camera()
    b2w = (np.asarray(jgeo.translation_matrix(shift, 0.13, 0.37))
           @ np.asarray(jgeo.rotation_y(0.1))).astype(np.float32)
    jpa, jca, tpa, tca = frustum(k, 0.5, 12.0)
    jpb, jcb, tpb, tcb = frustum(k, 0.5, 12.0, b2w)
    for planes, corners in ((jpa, jcb), (jpb, jca)):
        assert np.all(np.abs(signed(corners, planes)) > MARGIN)
    want = bool(jgeo.frustums_intersect(jpa, jca, jpb, jcb))
    assert want == meets
    got = tgeo.frustums_intersect(tpa, tca, tpb, tcb)
    assert got.dtype == torch.bool and got.shape == () and bool(got) == want


def test_disparity_steepness_mask_matches_jax():
    """Slabs at 2, 6.5 and 30 m with 1% grain: disparity jumps of 0.4-1.6
    px at the threshold of 0.7, none within 1e-4 of it."""
    rng = np.random.default_rng(8)
    depth = np.full((2, 48, 64), 30.0, np.float32)
    depth[:, 10:30, 10:30] = 2.0
    depth[:, 25:45, 35:55] = 6.5
    depth *= 1 + 0.01 * rng.standard_normal(depth.shape).astype(np.float32)
    k = camera()
    disp = k[0, 0] * 0.063 / np.maximum(depth.astype(np.float64), 1e-6)
    for ax in (-1, -2):
        jump = np.abs(np.diff(disp, axis=ax))
        assert np.all(np.abs(jump - 0.7) > MARGIN)
    want = np.asarray(jgeo.disparity_steepness_mask(
        jnp.asarray(depth), jnp.asarray(k), threshold_px=0.7))
    assert 0.01 < want.mean() < 0.5
    got = tgeo.disparity_steepness_mask(torch.from_numpy(depth),
                                        torch.from_numpy(k), threshold_px=0.7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("data,pct", [("nonfinite", (1.0, 99.0)),
                                      ("nonfinite", (5.0, 70.0)),
                                      ("zeros", (1.0, 99.0))])
def test_normalize_depth_matches_jax(data, pct):
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 40.0, (37, 53)).astype(np.float32)
    if data == "zeros":
        depth[:] = 0.0
    else:
        flat = depth.reshape(-1)
        pick = rng.choice(flat.size, 90, replace=False)
        flat[pick[:30]], flat[pick[30:60]] = np.nan, np.inf
        flat[pick[60:]] = -np.inf
    want = np.asarray(jcodec.normalize_depth(jnp.asarray(depth), *pct))
    got = tcodec.normalize_depth(torch.from_numpy(depth), *pct).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    close(got, want)
    if data == "zeros":
        assert not want.any()
    else:
        assert 0.0 < want.mean() < 1.0


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("multiple", [1, 14])
def test_rescale_to_side_matches_jax(mode, multiple):
    for h, w in ((1080, 1920), (1920, 1080), (480, 640), (37, 53),
                 (518, 518), (719, 1279)):
        for side in (14, 256, 518, 1000):
            got = tim.rescale_to_side(h, w, side, mode, multiple)
            assert got == jim.rescale_to_side(h, w, side, mode, multiple), (
                h, w, side)


@pytest.mark.parametrize("weighted", [False, True])
def test_scale_shift_align_to_metric_matches_jax(weighted):
    rng = np.random.default_rng(6)
    metric = rng.uniform(1.0, 20.0, (3, 24, 32)).astype(np.float32)
    rel = (0.8 / metric + 0.05 + 0.002 * rng.standard_normal(
        metric.shape)).astype(np.float32)
    weights = (rng.random(metric.shape) > 0.3).astype(np.float32) \
        if weighted else None
    want, (ws, wt) = jda.scale_shift_align_to_metric(
        jnp.asarray(rel), jnp.asarray(metric),
        None if weights is None else jnp.asarray(weights))
    got, (gs, gt) = tda.scale_shift_align_to_metric(
        torch.from_numpy(rel), torch.from_numpy(metric),
        None if weights is None else torch.from_numpy(weights))
    close(got, want, atol=0.0, rtol=1e-5)
    close(gs, ws, atol=0.0, rtol=1e-5)
    close(gt, wt, atol=0.0, rtol=1e-5)


class FakeClock:
    """``time.perf_counter`` stepping by a fixed sequence of intervals."""

    def __init__(self):
        self.now = 100.0
        self.steps = iter([0.25, 1.5, 0.003, 7.125, 0.5, 62.0, 0.0, 2.0]
                          * 4)

    def __call__(self):
        self.now += next(self.steps)
        return self.now


def _drive(mod):
    """timer twice (one into a dict) and a Progress of 10 frames. ->
    (Progress text, dict)"""
    out = {}
    with mod.timer("stage a"):
        pass
    with mod.timer("stage b", out=out):
        pass
    with mod.timer("stage b", out=out):
        pass
    stream = io.StringIO()
    prog = mod.Progress(10, label="frame", stream=stream)
    for n in (3, 3, 4):
        prog.step(n)
    prog.close()
    return stream.getvalue(), out


def test_timer_progress_and_stage_metrics_match_jax(monkeypatch, capsys):
    assert tutils.timer is ttimer.timer
    assert tutils.Progress is ttimer.Progress
    runs = []
    for mod in (jtimer, ttimer):
        monkeypatch.setattr(time, "perf_counter", FakeClock())
        runs.append(_drive(mod) + (capsys.readouterr().out,))
    assert runs[0] == runs[1]
    text, out, printed = runs[1]
    assert printed.count(" took: ") == 3 and "eta " in text
    assert set(out) == {"stage b"}
