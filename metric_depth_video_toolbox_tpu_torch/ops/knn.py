"""Batched k-nearest neighbours of point clouds (PyTorch port of
``ops/knn.py``).

Distances come from one matmul per query tile, ``|q - r|^2 = |q|^2 +
|r|^2 - 2 q.r^T`` clamped at 0, and ``torch.topk`` picks the k smallest;
tiling bounds the (tile, N) distance block. Invalid references are at
+inf distance, so they are never neighbours while a valid one is left;
invalid queries get +inf rows.

``topk`` orders equal distances as it likes, so a neighbour list may
differ from the JAX package's in the order of ties (the distances and the
neighbour sets agree). Without ``view_dirs`` an eigenvector's sign is
arbitrary, so :func:`knn_normals` may return the JAX package's normal
negated.
"""

from __future__ import annotations

import torch


def knn_points(query, ref, k=8, query_mask=None, ref_mask=None, tile=2048):
    """k nearest neighbours of ``query`` (Q, D) among ``ref`` (N, D),
    with optional boolean validity masks (Q,) and (N,). -> (squared
    distances (Q, k), indices (Q, k)); k is at most N."""
    q, d = query.shape
    n = ref.shape[0]
    k = min(k, n)
    ref = ref.to(torch.float32)
    query = query.to(torch.float32)
    r2 = torch.sum(ref * ref, dim=-1)
    bad_ref = (torch.zeros(n, device=ref.device) if ref_mask is None
               else torch.where(ref_mask, 0.0, torch.inf))

    tile = min(tile, max(q, 1))
    pad = (-q) % tile
    qp = torch.cat([query, query.new_zeros(pad, d)])
    dists, idx = [], []
    for qt in qp.split(tile):
        qt2 = torch.sum(qt * qt, dim=-1, keepdim=True)
        sq = qt2 + r2[None, :] - 2.0 * qt @ ref.T
        sq = torch.clamp(sq, min=0.0) + bad_ref[None, :]
        neg, i = torch.topk(-sq, k, dim=-1)
        dists.append(-neg)
        idx.append(i)
    dists = torch.cat(dists)[:q]
    idx = torch.cat(idx)[:q]
    if query_mask is not None:
        dists = torch.where(query_mask[:, None], dists, torch.inf)
    return dists, idx


def knn_gather(values, idx):
    """Per-neighbour payloads: values (N, C), idx (Q, k) -> (Q, k, C)."""
    return values[idx]


def knn_interpolate(query, ref, ref_values, k=3, eps=1e-8, tile=2048):
    """Inverse-distance-weighted interpolation of ``ref_values`` (N, C)
    at ``query`` (Q, D) from its k nearest references. -> (Q, C)"""
    sq, idx = knn_points(query, ref, k=k, tile=tile)
    w = 1.0 / (sq + eps)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return torch.sum(knn_gather(ref_values, idx) * w[..., None], dim=1)


def knn_normals(points, k=16, mask=None, view_dirs=None, tile=2048):
    """Unit normals (N, 3) of ``points`` (N, 3): the eigenvector of the
    smallest eigenvalue of each k-neighbourhood's covariance (divided by
    the ``k`` asked for), flipped to face against ``view_dirs`` (N, 3)
    when given (a normal at right angles to its view stays as it is)."""
    _, idx = knn_points(points, points, k=k, query_mask=mask,
                        ref_mask=mask, tile=tile)
    nb = knn_gather(points.to(torch.float32), idx)
    c = nb - torch.mean(nb, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", c, c) / k
    normal = torch.linalg.eigh(cov)[1][..., 0]
    if view_dirs is not None:
        flip = torch.sign(torch.sum(normal * -view_dirs, dim=-1))
        normal = normal * torch.where(flip == 0, 1.0, flip)[:, None]
    return normal
