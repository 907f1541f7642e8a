"""The pose and ray solvers of ``ops/solvers.py``, ``unproject_2d_points`` of
``ops/geometry.py`` and ``InstanceNorm`` of ``models/norm.py`` in the port
against the JAX package on numpy-seeded inputs.

``ransac_pnp`` draws its minimal sets from a ``torch.Generator`` in the
port and from ``jax.random`` in the JAX package; the port is fed the JAX
package's draws (``choice`` without replacement under each split key)
through its ``samples`` argument.

Tolerances (float32 on the CPU): rotation vectors and translations
within 1e-4 (the scene's scale is 1), the PnP residual within 1e-4
relative, inlier masks equal; the ray functions within 1e-5 of the
largest value; unproject exactly equal; InstanceNorm within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import norm as jnorm
from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.ops import solvers as jsolvers
from metric_depth_video_toolbox_tpu_torch.models import norm as tnorm
from metric_depth_video_toolbox_tpu_torch.ops import geometry as tgeo
from metric_depth_video_toolbox_tpu_torch.ops import solvers as tsolvers
from port_helpers import _one_torch_thread  # noqa: F401

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)


def pnp_problem(seed=0, n=40, outliers=6):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(3, 6, n)], -1).astype(np.float32)
    rvec = np.array([0.05, -0.1, 0.03], np.float32)
    tvec = np.array([0.2, -0.1, 0.5], np.float32)
    r = np.asarray(jsolvers._so3_exp(jnp.asarray(rvec)))
    pc = pts @ r.T + tvec
    uv = (pc[:, :2] / pc[:, 2:] * 500.0 + [320.0, 240.0]).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    uv[:outliers] += rng.uniform(30, 60, (outliers, 2)).astype(np.float32)
    w = np.ones(n, np.float32)
    w[-3:] = 0.0
    return pts, uv, w, rvec, tvec


@pytest.mark.parametrize("weighted", [False, True])
def test_pnp_gauss_newton_matches_jax(weighted):
    pts, uv, w, rvec, tvec = pnp_problem()
    kw = {"weights": w} if weighted else {}
    jr, jt, jm = jsolvers.pnp_gauss_newton(
        jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(K),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tr, tt, tm = tsolvers.pnp_gauss_newton(
        torch.from_numpy(pts), torch.from_numpy(uv), torch.from_numpy(K),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert np.abs(tr.numpy() - np.asarray(jr)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() < 1e-4
    assert abs(float(tm) - float(jm)) <= 1e-4 * float(jm)
    # the fit is near the truth despite the outliers' pull
    assert np.abs(tr.numpy() - rvec).max() < 0.05


def jax_ransac_draws(key, w, num_hypotheses, sample_size):
    n = w.shape[0]
    wj = jnp.asarray(w)

    @jax.jit
    def draws(key):
        keys = jax.random.split(key, num_hypotheses)
        return jax.vmap(lambda k: jax.random.choice(
            k, n, shape=(sample_size,), replace=False,
            p=wj / jnp.sum(wj)))(keys)
    return np.array(draws(key))


def test_ransac_pnp_matches_jax_with_its_draws():
    pts, uv, w, rvec, tvec = pnp_problem(1)
    key = jax.random.PRNGKey(7)
    jr, jt, jin = jsolvers.ransac_pnp(key, jnp.asarray(pts), jnp.asarray(uv),
                                      jnp.asarray(K), jnp.asarray(w),
                                      num_hypotheses=32)
    samples = jax_ransac_draws(key, w, 32, 6)
    tr, tt, tin = tsolvers.ransac_pnp(
        None, torch.from_numpy(pts), torch.from_numpy(uv),
        torch.from_numpy(K), torch.from_numpy(w), num_hypotheses=32,
        samples=torch.from_numpy(samples))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    assert np.abs(tr.numpy() - np.asarray(jr)).max() < 1e-4
    assert np.abs(tt.numpy() - np.asarray(jt)).max() < 1e-4
    # the outliers and the zero-weight points are not inliers
    assert not tin[:6].any() and not tin[-3:].any()
    assert np.abs(tt.numpy() - tvec).max() < 0.05


def test_ransac_pnp_draws_from_its_generator():
    pts, uv, w, rvec, _ = pnp_problem(2)
    args = (torch.from_numpy(pts), torch.from_numpy(uv),
            torch.from_numpy(K), torch.from_numpy(w))
    a = tsolvers.ransac_pnp(torch.Generator().manual_seed(0), *args,
                            num_hypotheses=16)
    b = tsolvers.ransac_pnp(torch.Generator().manual_seed(0), *args,
                            num_hypotheses=16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sets = tsolvers.draw_minimal_sets(torch.Generator().manual_seed(1),
                                      args[3], 16, 6, replace=False)
    assert sets.shape == (16, 6)
    assert all(len(set(row.tolist())) == 6 for row in sets)
    assert not bool(torch.isin(sets, torch.tensor([37, 38, 39])).any())
    assert np.abs(a[0].numpy() - rvec).max() < 0.05


def test_pose_matrix_and_sim3_match_jax():
    rng = np.random.default_rng(3)
    rv = rng.normal(0, 0.4, 3).astype(np.float32)
    tv = rng.normal(0, 1, 3).astype(np.float32)
    want = np.asarray(jsolvers.pose_matrix_from_rvec_tvec(jnp.asarray(rv),
                                                          jnp.asarray(tv)))
    got = tsolvers.pose_matrix_from_rvec_tvec(torch.from_numpy(rv),
                                              torch.from_numpy(tv)).numpy()
    assert np.abs(got - want).max() < 1e-6
    c2w = np.stack([want, np.eye(4, dtype=np.float32), want @ want])
    scale = np.float32(1.7)
    rot = np.asarray(jsolvers._so3_exp(jnp.asarray(rv[::-1].copy())))
    trans = rng.normal(0, 1, 3).astype(np.float32)
    want = np.asarray(jsolvers.apply_sim3_to_poses(
        jnp.asarray(c2w), jnp.asarray(scale), jnp.asarray(rot),
        jnp.asarray(trans)))
    got = tsolvers.apply_sim3_to_poses(
        torch.from_numpy(c2w), torch.tensor(scale), torch.from_numpy(rot),
        torch.from_numpy(trans)).numpy()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_ray_weights_and_intersection_match_jax():
    rng = np.random.default_rng(4)
    target = np.array([0.3, -0.2, 4.0])
    origins = rng.normal(0, 1, (2, 12, 3))
    dirs = target - origins + rng.normal(0, 0.02, origins.shape)
    origins, dirs = origins.astype(np.float32), dirs.astype(np.float32)
    valid = (rng.uniform(size=(2, 12)) > 0.25).astype(np.float32)
    want = np.asarray(jsolvers.ray_diversity_weights(jnp.asarray(dirs),
                                                     jnp.asarray(valid)))
    got = tsolvers.ray_diversity_weights(torch.from_numpy(dirs),
                                         torch.from_numpy(valid)).numpy()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
    for kw in ({}, {"valid": valid}, {"weights": valid * 0.5 + 0.25}):
        want = np.asarray(jsolvers.intersect_rays(
            jnp.asarray(origins), jnp.asarray(dirs),
            **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = tsolvers.intersect_rays(
            torch.from_numpy(origins), torch.from_numpy(dirs),
            **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
        assert got.shape == (2, 3)
        assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
        assert np.abs(got - target).max() < 0.05


def test_unproject_2d_points_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 640, (2, 7, 2)).astype(np.float32)
    z = rng.uniform(1, 9, (2, 7)).astype(np.float32)
    k = np.stack([K, K * np.float32(0.5)])
    k[1, 2, 2] = 1.0
    want = np.asarray(jgeo.unproject_2d_points(jnp.asarray(pts),
                                               jnp.asarray(z),
                                               jnp.asarray(k)))
    got = tgeo.unproject_2d_points(torch.from_numpy(pts), torch.from_numpy(z),
                                   torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(dtype):
    rng = np.random.default_rng(6)
    x = (rng.normal(0, 3, (2, 5, 7, 4)) + 1.5).astype(np.float32)
    want = np.asarray(jnorm.InstanceNorm().apply(
        {}, jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got = tnorm.InstanceNorm()(torch.from_numpy(x).permute(0, 3, 1, 2).to(
        getattr(torch, dtype))).to(torch.float32).permute(0, 2, 3, 1).numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert np.abs(got - want).max() < tol * np.abs(want).max()
