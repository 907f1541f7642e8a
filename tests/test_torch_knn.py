"""``ops/knn.py`` against the JAX package's: squared distances within 1e-5
relative plus 4 float32 ulps of the largest |q|^2 + |r|^2 (the
distance-by-matmul formula cancels there, and the two matmuls sum in other
orders); neighbour sets, not index order, since ``torch.topk`` and
``lax.top_k`` may order ties differently (members within that tolerance of
the k-th distance may swap); masks, k > n and a query count that is not a
multiple of the tile; the inverse-distance interpolation within what that
tolerance moves its weights (2 tol / the nearest squared distance, times
the largest value); normals up to
sign without ``view_dirs`` (an eigenvector's sign is arbitrary) and equal
with them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.ops import knn as jknn
from metric_depth_video_toolbox_tpu_torch.ops import knn as tknn
from port_helpers import _one_torch_thread  # noqa: F401


def _cloud(seed, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (n, 3)) + [0, 0, 5]).astype(np.float32)


def _both(fn_name, *arrays, **kw):
    """The function of both packages on the same numpy inputs (arrays in
    ``kw`` too) -> (JAX's result, the port's), as numpy."""
    def conv(a, to):
        return to(a) if isinstance(a, np.ndarray) else a
    j = getattr(jknn, fn_name)(*[conv(a, jnp.asarray) for a in arrays],
                               **{k: conv(v, jnp.asarray)
                                  for k, v in kw.items()})
    t = getattr(tknn, fn_name)(*[conv(a, torch.from_numpy) for a in arrays],
                               **{k: conv(v, torch.from_numpy)
                                  for k, v in kw.items()})
    if isinstance(j, tuple):
        return [np.asarray(x) for x in j], [x.numpy() for x in t]
    return np.asarray(j), t.numpy()


CASES = {
    # name: (Q, N, k, tile, query mask?, ref mask?)
    "tiled": (37, 50, 6, 16, False, False),
    "one_tile": (20, 33, 4, 2048, False, False),
    "k_over_n": (9, 5, 8, 4, False, False),
    "masks": (40, 64, 5, 16, True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_points_matches_jax(case):
    q_n, r_n, k, tile, qm, rm = CASES[case]
    rng = np.random.default_rng(len(case))
    q, r = _cloud(1, q_n), _cloud(2, r_n)
    q_mask = rng.random(q_n) > 0.3 if qm else None
    r_mask = rng.random(r_n) > 0.3 if rm else None
    (jd, ji), (td, ti) = _both("knn_points", q, r, query_mask=q_mask,
                               ref_mask=r_mask, k=k, tile=tile)
    assert td.shape == ti.shape == (q_n, min(k, r_n))
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    tol = 4 * np.finfo(np.float32).eps * (
        (q ** 2).sum(1).max() + (r ** 2).sum(1).max())
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=tol)
    # neighbour sets over the finite distances, but for near-ties at the
    # k-th distance
    for row in range(q_n):
        f = fin[row]
        kth = jd[row][f].max() if f.any() else 0.0
        sure = (jd[row] < kth - 2 * tol) & f
        assert set(ji[row][sure]) <= set(ti[row][f]), row
        sure = (td[row] < kth - 2 * tol) & f
        assert set(ti[row][sure]) <= set(ji[row][f]), row
    if r_mask is not None:
        assert r_mask[ti[fin]].all()
    if q_mask is not None:
        assert np.isinf(td[~q_mask]).all()


def test_knn_points_ties_hold_distances():
    """On an integer grid many distances tie: the port's neighbours are
    at the distances it reports, and the sorted distances equal JAX's."""
    g = np.stack(np.meshgrid(*[np.arange(4.0)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    (jd, _), (td, ti) = _both("knn_points", g, g, k=7, tile=16)
    np.testing.assert_array_equal(td, jd)
    true = ((g[:, None] - g[ti]) ** 2).sum(-1)
    np.testing.assert_array_equal(true, td)


def test_knn_gather_and_interpolate_match_jax():
    q, r = _cloud(3, 30), _cloud(4, 45)
    vals = np.random.default_rng(5).normal(size=(45, 4)).astype(np.float32)
    j, t = _both("knn_interpolate", q, r, vals, k=3, tile=8)
    tol = 4 * np.finfo(np.float32).eps * (
        (q ** 2).sum(1).max() + (r ** 2).sum(1).max())
    nearest = np.asarray(jknn.knn_points(jnp.asarray(q), jnp.asarray(r),
                                         k=1)[0])
    bound = 2 * tol / nearest * np.abs(vals).max() + 1e-6
    assert (np.abs(t - j) <= bound).all()
    assert np.median(bound) < 1e-3
    idx = np.random.default_rng(6).integers(0, 45, (30, 3))
    np.testing.assert_array_equal(
        tknn.knn_gather(torch.from_numpy(vals), torch.from_numpy(idx)).numpy(),
        np.asarray(jknn.knn_gather(jnp.asarray(vals), jnp.asarray(idx))))


@pytest.mark.parametrize("views", [False, True])
def test_knn_normals_match_jax(views):
    """A bumpy surface: normals equal JAX's up to sign without view
    directions, and with them equal (within 1e-5)."""
    rng = np.random.default_rng(7)
    xy = rng.uniform(-1, 1, (90, 2)).astype(np.float32)
    z = 4 + 0.3 * np.sin(2 * xy[:, :1]) + 0.2 * xy[:, 1:] ** 2
    pts = np.concatenate([xy, z], 1).astype(np.float32)
    vd = None
    if views:
        vd = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    mask = rng.random(90) > 0.1
    j, t = _both("knn_normals", pts, k=12, mask=mask, view_dirs=vd, tile=32)
    np.testing.assert_allclose(np.linalg.norm(t, axis=1), 1.0, atol=1e-5)
    if views:
        np.testing.assert_allclose(t, j, atol=1e-5)
        assert ((t * vd).sum(1) <= 0).all()
    else:
        sign = np.sign((t * j).sum(1, keepdims=True))
        np.testing.assert_allclose(t * sign, j, atol=1e-5)
