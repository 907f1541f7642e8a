"""The port's block-causal attention (``ops/blockcausal.py``) on the CPU,
where the wrapper runs its plain version, against the JAX package's Pallas
kernel in interpret mode and against dense masked attention, on the four
cases of ``tests/test_blockcausal_pallas.py``.

Tolerance: 2e-5 absolute and relative, the JAX kernel's own test's (the
plain version and the online-softmax kernel sum in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.ops import blockcausal_pallas as bc
from metric_depth_video_toolbox_tpu_torch.ops import blockcausal as tbc
from port_helpers import _one_torch_thread  # noqa: F401

TOL = dict(atol=2e-5, rtol=2e-5)


def dense(q, k, v, ids, sm_scale):
    """Dense block-causal attention in float64 numpy."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    s = np.where(ids[None, :] <= ids[:, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v)


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


# (n, ids, block_q, block_k, seed): unaligned frame blocks (40-token blocks
# across 64-token tiles), a single block (full attention), many small blocks
# (most key tiles skipped for early query tiles)
CASES = {
    "unaligned_blocks": (320, np.arange(320) // 40, 64, 64, 0),
    "single_block": (256, np.zeros(256), 64, 64, 1),
    "tile_skip": (384, np.arange(384) // 16, 128, 64, 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_and_dense(name):
    n, ids, bq, bk, seed = CASES[name]
    ids = ids.astype(np.int32)
    q, k, v = qkv((2, 3, n, 128), seed)
    sm = 1.0 / 128 ** 0.5
    want = np.asarray(bc.block_causal_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids),
        sm, block_q=bq, block_k=bk, interpret=True))
    got = tbc.block_causal_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(ids), sm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), dense(q, k, v, ids, sm), **TOL)


def test_pad_convention():
    """Padded with the JAX convention (pad keys id max + 1), the real rows
    equal the Pallas kernel's and the unpadded dense attention."""
    n_real, n = 300, 384
    ids = (np.arange(n_real) // 50).astype(np.int32)
    ids_pad = np.concatenate([ids, np.full(n - n_real, ids.max() + 1,
                                           np.int32)])
    q, k, v = qkv((1, 2, n, 128), 3)
    sm = 1 / 128 ** 0.5
    want = np.asarray(bc.block_causal_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(ids_pad), sm, block_q=128, block_k=128, interpret=True))
    got = tbc.block_causal_attention(
        *(torch.from_numpy(t) for t in (q, k, v)),
        torch.from_numpy(ids_pad), sm).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, :, :n_real], want[:, :, :n_real],
                               **TOL)
    np.testing.assert_allclose(
        got[:, :, :n_real], dense(q[:, :, :n_real], k[:, :, :n_real],
                                  v[:, :, :n_real], ids, sm), **TOL)


def test_cpu_runs_plain_without_launch():
    """A CPU tensor takes the plain version (any head dim, bf16 in, bf16
    out) and counts no launch; tensors on two devices are refused."""
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in qkv((1, 2, 50, 12), 4))
    ids = (torch.arange(50) // 20).to(torch.int32)
    before = tbc.LAUNCHES["block_causal_attention"]
    out = tbc.block_causal_attention(q, k, v, ids, 0.3)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert tbc.LAUNCHES["block_causal_attention"] == before
    want = dense(q.float(), k.float(), v.float(), ids.numpy(), 0.3)
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2)
    with pytest.raises(ValueError, match="devices"):
        tbc.block_causal_attention(q, k, v, ids.to("meta"), 0.3)


def test_plain_chunks_over_query_rows(monkeypatch):
    """When one head's scores exceed the chunk, the plain version splits
    its query rows (here into 50-row chunks, the last one ragged) and
    still equals dense attention."""
    n, ids, _, _, seed = CASES["unaligned_blocks"]
    ids = ids.astype(np.int32)
    q, k, v = qkv((1, 2, n, 64), seed)
    monkeypatch.setattr(tbc, "_PLAIN_CHUNK", n * 50)
    got = tbc.block_causal_attention_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(ids),
        0.125)
    np.testing.assert_allclose(got.numpy(), dense(q, k, v, ids, 0.125),
                               **TOL)


def bf16_kernel_model(q, k, v, ids, sm_scale, hidden=None):
    """What the bf16 kernel computes, in float32 on the CPU: P rounded to
    bf16 before P V, the sum of P unrounded, the output rounded to bf16.
    ``hidden``: (query rows, keys) the model wrongly leaves out."""
    s = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    visible = ids[None, :] <= ids[:, None]
    if hidden is not None:
        visible = visible.clone()
        visible[hidden] = False
    s = s.masked_fill(~visible, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(torch.bfloat16).float() @ v.float()) / p.sum(-1, keepdim=True)
    return o.to(torch.bfloat16)


@pytest.mark.parametrize("fault", [None, "key_tile_dropped", "mask_off_by_one",
                                   "mask_ignored"])
def test_error_ratio_passes_rounding_and_fails_faults(fault):
    """``error_ratio`` (the limit the card's bf16 kernel is held to) passes
    the kernel's own roundings and fails a wrong kernel: one 64-key tile
    left out for one 64-query tile, one key past a block boundary seen,
    the mask ignored."""
    n, d, block = 1200, 128, 300
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 4, n, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    ids = torch.from_numpy((np.arange(n) // block).astype(np.int32))
    sm = d ** -0.5
    hidden = None
    if fault == "key_tile_dropped":
        hidden = (slice(640, 704), slice(64, 128))
    elif fault == "mask_off_by_one":
        ids = ids.clone()
        ids[block] = 0           # the kernel's view of the ids
    elif fault == "mask_ignored":
        ids = torch.zeros_like(ids)
    got = bf16_kernel_model(q, k, v, ids, sm, hidden)
    ref = tbc.block_causal_attention_plain(
        q.float(), k.float(), v.float(),
        torch.from_numpy((np.arange(n) // block).astype(np.int32)), sm)
    ratio = tbc.error_ratio(got, ref)
    assert (ratio <= 1) == (fault is None), ratio
    if fault is None:
        assert ratio < 0.75
        assert tbc.error_ratio(ref, ref) == 0


def key_ranges_brute(ids, tile):
    """Per query tile: keys with id <= the id of its last and first query,
    counted one by one."""
    n = len(ids)
    key_end, full_end = [], []
    for q0 in range(0, n, tile):
        last, first = ids[min(q0 + tile, n) - 1], ids[q0]
        key_end.append(sum(1 for j in range(n) if ids[j] <= last))
        full_end.append(sum(1 for j in range(n) if ids[j] <= first))
    return key_end, full_end


def pad_ids(ids, n):
    """The JAX package's pad convention: pad keys (and queries) id max + 1."""
    return np.concatenate([ids, np.full(n - len(ids), ids.max() + 1)])


@pytest.mark.parametrize("name,ids", [
    ("one_block", np.zeros(300)),
    ("many_blocks_inside_tiles", np.arange(1000) // 70),
    ("ragged_tail", np.arange(777) // 200),
    ("wan_chip_smoke", np.arange(18720) // 4680),
    ("pad_convention", pad_ids(np.arange(300) // 50, 384)),
    ("one_token", np.zeros(1)),
])
def test_key_ranges_match_brute_force(name, ids):
    """``visible_prefix`` (torch.searchsorted: the keys each query sees,
    what the kernel's per-element test reads) and ``key_ranges`` (what its
    tile loop reads) against loops over the keys, for the kernel's query
    tiles at both head dims."""
    ids = ids.astype(np.int32)
    prefix = tbc.visible_prefix(torch.from_numpy(ids))
    assert prefix.dtype == torch.int32
    assert prefix.tolist() == [int((ids <= i).sum()) for i in ids]
    for tile in sorted(set(tbc.QUERY_TILE.values())):
        key_end, full_end = tbc.key_ranges(prefix, tile)
        assert key_end.dtype == full_end.dtype == torch.int32
        want = key_ranges_brute(ids, tile)
        assert key_end.tolist() == want[0] and full_end.tolist() == want[1]


@pytest.mark.parametrize("d", [16, 64, 96, 128])
def test_strided_views_and_head_dim_padding_keep_attention(d):
    """What the CUDA branch hands the kernel, through the plain version:
    (B, N, H, D) projections seen as (B, H, N, D) by ``transpose(1, 2)``
    are read at their own strides (``tma_strides``, no copy), and a head
    dim other than 64 or 128 is zero-padded (``pad_head_dim``). The
    padded attention, cut back to d columns, equals the unpadded dense
    one."""
    rng = np.random.default_rng(d)
    b, n, h = 2, 200, 3
    ids = (np.arange(n) // 64).astype(np.int32)
    bnhd = [torch.from_numpy(t) for t in qkv((b, n, h, d), d)]
    views = [t.transpose(1, 2) for t in bnhd]          # (B, H, N, D)
    dk = tbc.kernel_head_dim(d)
    prepped = [tbc.pad_head_dim(t, dk) for t in views]
    if dk == d:
        assert all(p is v for p, v in zip(prepped, views))
        bf = views[0].to(torch.bfloat16)
        assert tbc.tma_strides(bf, "q") == [n * h * d, d, h * d]
    sm = d ** -0.5
    got = tbc.block_causal_attention_plain(*prepped, torch.from_numpy(ids),
                                           sm)[..., :d]
    want = dense(*(t.numpy() for t in views), ids, sm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tma_strides_refuse_what_tma_cannot_read():
    """A non-contiguous last dim, or a row stride that is no multiple of
    16 bytes, raises instead of taking another path; a dim of extent 1
    gets a stride TMA takes."""
    x = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="last dim"):
        tbc.tma_strides(x.transpose(2, 3), "q")
    with pytest.raises(ValueError, match="16-byte"):
        tbc.tma_strides(torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16)
                        [..., :64], "k")
    strides = tbc.tma_strides(x, "v")
    assert strides[1:] == [64 * 64, 64] and strides[0] % 8 == 0
