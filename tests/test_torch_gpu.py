"""Tests that need a CUDA card: each kernel of the port against its plain
PyTorch version. They skip without a card. This file imports neither JAX
nor the JAX package, so it also runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu_torch.ops import blockcausal as bcm
from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def scene_planes(rng, h, w, num_planes):
    """A piecewise-smooth depth map and a uniform inverse-depth plane set
    over its range, with a stereo-eye disparity per plane."""
    yy = np.linspace(0, 1, h)[:, None]
    depth = np.tile(3 + 20 * yy, (1, w)).astype(np.float32)
    depth[h // 5:3 * h // 5, w // 8:w // 3] = 2.5
    depth[2 * h // 5:9 * h // 10, w // 2:5 * w // 6] = 7.0
    depth *= 1 + 0.01 * rng.standard_normal((h, w)).astype(np.float32)
    inv_near = np.float32(1 / depth.min())
    d_inv = np.float32((1 / depth.min() - 1 / depth.max())
                       / (num_planes - 1))
    pz = (1 / (inv_near - d_inv * np.arange(num_planes, dtype=np.float32))
          ).astype(np.float32)
    tol = (1.6 * pz * pz * d_inv + 1e-4).astype(np.float32)
    disp = np.clip(-15.75 * (1 / pz - 0.1), -254, 254).astype(np.float32)
    return depth, inv_near, d_inv, pz, tol, disp


@pytest.mark.gpu
@pytest.mark.parametrize("n_chan,num_planes", [(3, 128), (6, 32)])
def test_disparity_sweep_kernel_matches_plain(cuda, n_chan, num_planes):
    """The CUDA kernel equals the plain version bit for bit (found, z,
    payload), and counts one launch."""
    rng = np.random.default_rng(9)
    h, w = 200, 320
    cases = [scene_planes(rng, h, w, num_planes) for _ in range(3)]

    def stack(i):
        return torch.from_numpy(np.stack([c[i] for c in cases])).to(cuda)
    disp = stack(5)
    pad_l, pad_r = ws.pad_widths(w, 256)
    d = stack(0)
    args = (torch.nn.functional.pad(d, (pad_l, pad_r)),
            torch.nn.functional.pad(
                torch.rand(3, n_chan, h, w, device=cuda), (pad_l, pad_r)),
            torch.floor(disp).to(torch.int32), disp - torch.floor(disp),
            stack(3), stack(4), num_planes, pad_l,
            ws.plane_activity(d, stack(1), stack(2), num_planes))
    before = ws.LAUNCHES["disparity_sweep"]
    got = ws.disparity_sweep(*args)
    torch.cuda.synchronize()
    assert ws.LAUNCHES["disparity_sweep"] == before + 1
    want = ws.disparity_sweep_plain(*args)
    assert want[2].float().mean() > 0.9
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_disparity_sweep_rejects_bad_arguments(cuda):
    z = torch.zeros(1, 2, 300, device=cuda)
    args = [z, torch.zeros(1, 3, 2, 300, device=cuda),
            torch.zeros(1, 1, dtype=torch.int64, device=cuda),
            torch.zeros(1, 1, device=cuda), torch.ones(1, 1, device=cuda),
            torch.ones(1, 1, device=cuda)]
    with pytest.raises(ValueError, match="disp_int"):
        ws.disparity_sweep(*args, 1, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,block", [(1000, 64, 150), (777, 128, 100),
                                       (2113, 128, 520), (64, 16, 64)])
def test_block_causal_kernel_matches_plain(cuda, dtype, n, d, block):
    """Ragged N (not a multiple of either tile), block boundaries inside
    tiles, several (b, h): the kernel equals the plain version, run in
    float32 on the same inputs, within ``bcm.error_ratio``'s limit (float32
    2e-5; bfloat16 2**-8 of each value plus 2**-5 of the output's RMS),
    and counts one launch."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    q, k, v = (torch.randn(2, 3, n, d, generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    ids = (torch.arange(n, device=cuda) // block).to(torch.int32)
    before = bcm.LAUNCHES["block_causal_attention"]
    got = bcm.block_causal_attention(q, k, v, ids, d ** -0.5)
    torch.cuda.synchronize()
    assert bcm.LAUNCHES["block_causal_attention"] == before + 1
    want = bcm.block_causal_attention_plain(q.float(), k.float(), v.float(),
                                            ids, d ** -0.5)
    assert got.dtype == dtype and torch.isfinite(got).all()
    ratio = bcm.error_ratio(got, want)
    assert ratio <= 1, ratio


# planted faults of csrc/block_causal_attention.cu, each (text, its
# replacement); "unchanged" builds the source as it is
_TILE_LANDED = ("    cp_async_wait_one();       // this tile's copies have "
                "landed\n")
B3_FAULTS = {
    "unchanged": ("", ""),
    # query tile 100 of (b, h) 0 leaves out its second live key tile
    "one_key_tile_skipped": (_TILE_LANDED, _TILE_LANDED + (
        "    if (cur == 1 && blockIdx.x == 100 && blockIdx.y == 0) {\n"
        "      __syncthreads(); cur = nxt; continue;\n    }\n")),
    "mask_ignored": ("        if (!full) {\n", "        if (false) {\n"),
    # a key tile counts as seen whole when the block's last query sees it
    "whole_tile_test_on_qmax": ("kid[tid] <= qmin));", "kid[tid] <= qmax));"),
}


@pytest.fixture(scope="module")
def b3_variants(tmp_path_factory):
    """-> {fault: ctypes library} of B3 with each planted fault, all
    built at once in a temporary directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import ctypes

    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC_DIR / "block_causal_attention.cu").read_text()
    tmp = tmp_path_factory.mktemp("b3_faults")
    for fault, (old, new) in B3_FAULTS.items():
        text = src.replace(old, new) if old else src
        assert (text != src) == bool(old), fault
        (tmp / f"b3_{fault}.cu").write_text(text)
    patch = pytest.MonkeyPatch()
    patch.setattr(cuda_build, "CSRC_DIR", tmp)
    patch.setattr(cuda_build, "BUILD_DIR", tmp / "build")
    try:
        cuda_build.build([f"b3_{f}" for f in B3_FAULTS])
        return {f: ctypes.CDLL(str(cuda_build.library_path(f"b3_{f}")))
                for f in B3_FAULTS}
    finally:
        patch.undo()


@pytest.mark.gpu
@pytest.mark.parametrize("fault", list(B3_FAULTS))
def test_block_causal_tolerance_fails_planted_faults(cuda, b3_variants,
                                                     monkeypatch, fault):
    """At the infill's shape (1, 12, 18720, 128) in bfloat16, 4 causal
    blocks, ``bcm.error_ratio``'s limit passes the kernel built unchanged
    and fails each planted fault of its source."""
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "load", lambda name: b3_variants[fault])
    n, d = 18720, 128
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(1, 12, n, d, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    ids = (torch.arange(n, device=cuda) // (n // 4)).to(torch.int32)
    got = bcm.block_causal_attention(q, k, v, ids, d ** -0.5)
    want = bcm.block_causal_attention_plain(q.float(), k.float(), v.float(),
                                            ids, d ** -0.5)
    ratio = bcm.error_ratio(got, want)
    print(f"B3 {fault}: max abs err "
          f"{(got.float() - want).abs().max().item():.3e}, error ratio "
          f"{ratio:.3f}")
    assert (ratio <= 1) == (fault == "unchanged"), ratio


@pytest.mark.gpu
def test_block_causal_kernel_pad_convention(cuda):
    """Padded with the JAX package's convention, the real rows equal the
    unpadded attention."""
    n_real, n = 300, 384
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(1, 2, n, 64, generator=gen, device=cuda)
               for _ in range(3))
    ids = (torch.arange(n_real, device=cuda) // 50).to(torch.int32)
    ids_pad = torch.cat([ids, torch.full((n - n_real,), int(ids.max()) + 1,
                                         dtype=torch.int32, device=cuda)])
    got = bcm.block_causal_attention(q, k, v, ids_pad, 0.125)
    want = bcm.block_causal_attention_plain(
        q[:, :, :n_real], k[:, :, :n_real], v[:, :, :n_real], ids, 0.125)
    assert (got[:, :, :n_real] - want).abs().max().item() <= 2e-5


@pytest.mark.gpu
def test_block_causal_rejects_bad_arguments(cuda):
    q = torch.zeros(1, 1, 8, 12, device=cuda)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        bcm.block_causal_attention(q, q, q, ids, 1.0)
    q = torch.zeros(1, 1, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        bcm.block_causal_attention(q, q, q, ids, 1.0)


@pytest.mark.gpu
def test_lhm_color_transfer_card_matches_cpu(cuda):
    """Near-grey frames (channels that move together, 1% grain) give the
    reference covariance eigenvalues three orders apart; the colour match
    on the card equals the CPU's within 1e-2 on [0, 255]."""
    from metric_depth_video_toolbox_tpu_torch.ops import infill as iops

    rng = np.random.default_rng(4)
    t, h, w = 9, 270, 480
    ramp = np.linspace(40, 220, w, dtype=np.float32)[None, None, :, None]
    tex = 18 * np.sin(np.arange(h, dtype=np.float32) / 7)[None, :, None, None]
    ref = np.clip(ramp * np.array([1.0, 0.95, 0.9], np.float32) + tex
                  + 2.5 * rng.standard_normal((t, h, w, 3)), 0, 255)
    ref = np.floor(ref).astype(np.float32)
    gen = (120 + 40 * rng.standard_normal((t, h, w, 3))).astype(np.float32)
    weights = (rng.random((t, h, w)) > 0.25).astype(np.float32)
    args = [torch.from_numpy(a) for a in (gen, ref, weights)]
    want = iops.lhm_color_transfer(*args)
    got = iops.lhm_color_transfer(*(a.to(cuda) for a in args)).cpu()
    assert (got - want).abs().max().item() <= 1e-2
