"""The packed-qkv attention of the port (``ops/attention_packed.py``)
against the JAX package's Pallas kernel ``ops/attention_pallas.py`` run in
interpret mode, on the same inputs made from a numpy seed: the cases of
``tests/test_attention_pallas.py`` (head groups, interleaved pads, an
all-pad leading key block, uneven blocks) plus shapes only the port takes
(any head count, a ragged sequence length, head dim 16).

On the CPU the port's wrapper runs its plain version (the CUDA kernel has
no CPU mode; ``tests/test_torch_gpu.py`` holds the kernel against the same
plain version on the card).

Tolerance: 2e-5 absolute and relative in float32 on the rows of real
queries, as the JAX package's own test holds its kernel to its dense
reference (measured: ~1e-6; both sides accumulate in float32 in a different
order). Pad query rows are unspecified by contract and only checked
finite.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.ops import attention_pallas as ap
from metric_depth_video_toolbox_tpu_torch.ops import attention_packed as apk
from port_helpers import _one_torch_thread  # noqa: F401

TOL = 2e-5


def pads(n, *runs):
    valid = np.ones((n,), bool)
    for lo, hi in runs:
        valid[lo:hi] = False
    return valid


def both(h, n, valid, block_q=64, block_k=64, d=64, b=2, seed=0):
    """-> (port, Pallas kernel in interpret mode) on the same inputs."""
    rng = np.random.default_rng(seed)
    qkv4 = rng.standard_normal((b, n, 3 * h, d)).astype(np.float32)
    sm = 1.0 / float(d) ** 0.5
    want = ap.packed_flash_attention(
        jnp.asarray(qkv4), jnp.asarray(valid), num_heads=h, sm_scale=sm,
        block_q=block_q, block_k=block_k, interpret=True)
    before = dict(apk.LAUNCHES)
    got = apk.packed_flash_attention(torch.from_numpy(qkv4),
                                     torch.from_numpy(valid), h, sm)
    assert apk.LAUNCHES == before     # no kernel launch on CPU tensors
    return got.numpy(), np.asarray(want)


def assert_real_rows_close(got, want, valid):
    assert got.shape == want.shape and got.dtype == want.dtype
    rows = np.where(valid)[0]
    np.testing.assert_allclose(got[:, rows], want[:, rows], atol=TOL,
                               rtol=TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("h", [8, 16, 24])
def test_packed_attention_matches_pallas_head_groups(h):
    n = 256
    valid = pads(n)
    got, want = both(h, n, valid)
    assert_real_rows_close(got, want, valid)


@pytest.mark.parametrize("name,h,n,runs,blocks,seed", [
    # an interior pad run (a view boundary) and tail pads
    ("interleaved", 8, 256, ((100, 128), (240, 256)), (64, 64), 1),
    # the whole first key block masked
    ("leading_block", 8, 256, ((0, 64),), (64, 64), 2),
    # block_q != block_k, blocks that do not tile the sequence equally
    ("uneven_blocks", 16, 384, ((380, 384),), (128, 64), 3),
    # two views of 100 real tokens padded to 128 each, back to back
    ("two_views", 8, 256, ((100, 128), (228, 256)), (64, 64), 4),
])
def test_packed_attention_matches_pallas_with_pads(name, h, n, runs, blocks,
                                                   seed):
    valid = pads(n, *runs)
    got, want = both(h, n, valid, block_q=blocks[0], block_k=blocks[1],
                     seed=seed)
    assert_real_rows_close(got, want, valid)


def test_packed_attention_head_dim_16_matches_pallas():
    """VIT_TINY's head dim (the JAX ViT never sends it to the Pallas kernel
    on a TPU; the kernel body itself takes it in interpret mode)."""
    n = 128
    valid = pads(n, (50, 64), (120, 128))
    got, want = both(8, n, valid, d=16, seed=5)
    assert_real_rows_close(got, want, valid)


def dense(qkv4, valid, h, sm):
    """Plain numpy softmax attention over the valid keys, in float64."""
    q, k, v = (qkv4[:, :, i * h:(i + 1) * h].astype(np.float64)
               for i in range(3))
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * sm
    s = np.where(valid[None, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("b,n,h,d", [(1, 77, 3, 16), (2, 131, 5, 32),
                                     (1, 200, 2, 128)])
def test_packed_attention_plain_any_heads_ragged_length(b, n, h, d):
    """Head counts that are no multiple of 8 and lengths that are no
    multiple of a block: the port takes them (the Pallas kernel does not),
    held against a float64 numpy softmax."""
    rng = np.random.default_rng(n)
    qkv4 = rng.standard_normal((b, n, 3 * h, d)).astype(np.float32)
    valid = (np.arange(n) % 11) < 8
    sm = d ** -0.5
    got = apk.packed_flash_attention(torch.from_numpy(qkv4),
                                     torch.from_numpy(valid), h, sm).numpy()
    want = dense(qkv4, valid, h, sm)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_packed_attention_plain_chunks_agree(monkeypatch):
    """The plain version's chunking over heads and query rows does not
    change its result."""
    rng = np.random.default_rng(9)
    qkv4 = torch.from_numpy(rng.standard_normal((2, 96, 12, 16))
                            .astype(np.float32))
    valid = torch.from_numpy((np.arange(96) % 7) < 5)
    whole = apk.packed_flash_attention_plain(qkv4, valid, 4, 0.25)
    for chunk in (96 * 69 * 2, 69 * 10):    # two heads at once; 10 rows
        monkeypatch.setattr(apk, "_PLAIN_CHUNK", chunk)
        part = apk.packed_flash_attention_plain(qkv4, valid, 4, 0.25)
        np.testing.assert_allclose(part.numpy(), whole.numpy(), atol=1e-6,
                                   rtol=0)


def test_packed_attention_bfloat16_plain_returns_input_type():
    rng = np.random.default_rng(10)
    qkv4 = torch.from_numpy(rng.standard_normal((1, 64, 6, 16))
                            .astype(np.float32))
    valid = torch.ones(64, dtype=torch.bool)
    ref = apk.packed_flash_attention(qkv4, valid, 2, 0.25)
    got = apk.packed_flash_attention(qkv4.bfloat16(), valid, 2, 0.25)
    assert got.dtype == torch.bfloat16
    assert apk.error_ratio(got, ref) <= 1


def test_packed_attention_no_valid_key_gives_zeros():
    qkv4 = torch.randn(1, 10, 6, 16,
                       generator=torch.Generator().manual_seed(0))
    got = apk.packed_flash_attention(qkv4, torch.zeros(10, dtype=torch.bool),
                                     2, 1.0)
    assert torch.equal(got, torch.zeros(1, 10, 2, 16))


def test_packed_attention_rejects_arguments_on_two_devices():
    qkv4 = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="several devices"):
        apk.packed_flash_attention(qkv4, torch.ones(8, device="meta"), 1,
                                   1.0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        apk.packed_flash_attention(qkv4.to("meta"),
                                   torch.ones(8, device="meta"), 1, 1.0)


def test_pad_multiple_divides_the_kernels_key_tile():
    """The kernel classes whole 128-key tiles (kBK in the core's source,
    KEY_TILE here, which ``key_tile_classes`` uses) and the ViT pads each
    view to a multiple that divides it, so a view's pads are one run at
    its end and only the tiles a view ends in, or a pad run starts in,
    are mixed."""
    from metric_depth_video_toolbox_tpu_torch.ops import blockcausal as bcm
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC_DIR / "flash_sm90.cuh").read_text()
    assert f"constexpr int kBK = {bcm.KEY_TILE};" in src
    assert bcm.KEY_TILE % apk.PAD_MULTIPLE == 0
    # DA3_L: 2305 tokens per view padded to 2368 over 52 views; every
    # mixed tile holds a view's end
    valid = np.tile(np.arange(2368) < 2305, 52)
    classes = apk.key_tile_classes(torch.from_numpy(valid)).numpy()
    assert len(classes) == 962 and (classes == 0).sum() == 0
    assert (classes == 2).sum() == 52


def key_tile_classes_brute(valid, tile):
    out = []
    for t0 in range(0, len(valid), tile):
        keys = [bool(valid[j]) if j < len(valid) else False
                for j in range(t0, t0 + tile)]
        out.append(1 if all(keys) else 2 if any(keys) else 0)
    return out


@pytest.mark.parametrize("name,n,runs", [
    ("interleaved", 1000, ((100, 128), (300, 420), (700, 705))),
    ("leading_all_pad_run", 700, ((0, 300),)),
    ("ragged_tail", 777, ()),
    ("ragged_tail_pads", 777, ((700, 777),)),
    ("no_valid_key", 300, ((0, 300),)),
    ("one_tile", 128, ()),
])
def test_key_tile_classes_match_brute_force(name, n, runs):
    """The wrapper's per-tile classes (0 no valid key, 1 all valid, 2
    mixed; keys past N count as invalid) against a loop over the keys."""
    valid = pads(n, *runs)
    for tile in (128, 64):
        got = apk.key_tile_classes(torch.from_numpy(valid), tile)
        assert got.dtype == torch.int8
        assert got.tolist() == key_tile_classes_brute(valid, tile)


@pytest.mark.parametrize("name,n,runs", [
    ("interleaved", 1000, ((100, 128), (300, 420), (700, 705))),
    ("leading_all_pad_run", 700, ((0, 300),)),
    ("ragged_tail", 777, ()),
])
def test_key_bits_match_brute_force(name, n, runs):
    """The bitmap the kernel's masked tiles read (bit b of byte i = key
    8 i + b, zero past N up to a whole 128-key tile) against the keys."""
    valid = pads(n, *runs)
    got = apk.key_bits(torch.from_numpy(valid)).numpy()
    assert got.dtype == np.uint8 and len(got) == -(-n // 128) * 16
    bits = np.unpackbits(got, bitorder="little").astype(bool)
    assert np.array_equal(bits[:n], valid) and not bits[n:].any()


@pytest.mark.parametrize("d", [16, 32, 48, 80, 112])
def test_head_dim_padding_keeps_attention(d):
    """The bf16 kernel runs head dims 64 and 128 only; the wrapper pads
    qkv4 with zero columns (``pad_head_dim`` to ``kernel_head_dim``). The
    padded attention through the plain version, cut back to d columns,
    equals the unpadded one: zero columns change no dot product."""
    from metric_depth_video_toolbox_tpu_torch.ops import blockcausal as bcm

    rng = np.random.default_rng(d)
    qkv4 = torch.from_numpy(rng.standard_normal((2, 150, 9, d))
                            .astype(np.float32))
    valid = torch.from_numpy(pads(150, (40, 64), (140, 150)))
    dk = bcm.kernel_head_dim(d)
    assert dk == (64 if d <= 64 else 128)
    padded = bcm.pad_head_dim(qkv4, dk)
    assert padded.shape == (2, 150, 9, dk)
    assert torch.equal(padded[..., :d], qkv4)
    assert not padded[..., d:].any()
    sm = d ** -0.5
    got = apk.packed_flash_attention_plain(padded, valid, 3, sm)[..., :d]
    want = apk.packed_flash_attention_plain(qkv4, valid, 3, sm)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)
    assert bcm.pad_head_dim(padded, dk) is padded
