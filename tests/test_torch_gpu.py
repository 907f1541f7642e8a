"""Tests that need a CUDA card: each kernel of the port against its plain
PyTorch version. They skip without a card. This file imports neither JAX
nor the JAX package, so it also runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu_torch.ops import attention_packed as apk
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


def dual_sweep_args(cuda, n_shared=3, n_extra=3, num_planes=128, b=3,
                    h=200, w=320):
    """``b`` scenes whose depth splits into a main stream and a sparse
    edge stream (the columns beside each depth step), with both bitmaps.
    -> (dual arguments, the single sweep's arguments for the main stream)"""
    rng = np.random.default_rng(12)
    cases = [scene_planes(rng, h, w, num_planes) for _ in range(b)]

    def stack(i):
        return torch.from_numpy(np.stack([c[i] for c in cases])).to(cuda)
    d = stack(0)
    step = torch.zeros_like(d, dtype=torch.bool)
    step[:, :, 1:] = (d[:, :, 1:] - d[:, :, :-1]).abs() > 1.0
    step[:, :, :-1] |= step[:, :, 1:].clone()
    main = torch.where(step, torch.zeros_like(d), d)
    edge = torch.where(step, d, torch.zeros_like(d))
    disp = stack(5)
    pad_l, pad_r = ws.pad_widths(w, 256)

    def pad(t):
        return torch.nn.functional.pad(t, (pad_l, pad_r))
    shared = pad(torch.rand(b, n_shared, h, w, device=cuda))
    extra = pad(torch.rand(b, n_extra, h, w, device=cuda))
    planes = (torch.floor(disp).to(torch.int32), disp - torch.floor(disp),
              stack(3), stack(4))
    acts = [ws.plane_activity(t, stack(1), stack(2), num_planes,
                              block_rows=ws.DUAL_BLOCK_ROWS)
            for t in (main, edge)]
    dual = (pad(main), pad(edge), shared, extra, *planes, *acts, num_planes,
            pad_l)
    single = (pad(main), shared, *planes, num_planes, pad_l,
              ws.plane_activity(main, stack(1), stack(2), num_planes))
    return dual, single


@pytest.mark.gpu
@pytest.mark.parametrize("n_shared,n_extra", [(3, 3), (1, 2), (3, 0)])
def test_disparity_sweep_dual_kernel_matches_plain(cuda, n_shared, n_extra):
    """The fused CUDA kernel equals its plain version bit for bit on all
    six outputs, its main surface equals the single sweep's kernel on the
    main stream under the same bitmap, and it counts one launch."""
    dual, single = dual_sweep_args(cuda, n_shared, n_extra)
    before = ws.LAUNCHES["disparity_sweep_dual"]
    got = ws.disparity_sweep_dual(*dual)
    torch.cuda.synchronize()
    assert ws.LAUNCHES["disparity_sweep_dual"] == before + 1
    want = ws.disparity_sweep_dual_plain(*dual)
    assert want[2].float().mean() > 0.8 and want[5].float().mean() > 0.005
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    # the single sweep's bitmap has 64-row tiles: the same bitmap in the
    # fused sweep's 32-row tiles is each of its rows twice
    coarse = single[-1].repeat_interleave(2, dim=1)[
        :, :dual[8].shape[1]].contiguous()
    got = ws.disparity_sweep_dual(*dual[:8], coarse, *dual[9:])
    for a, b in zip(got[:3], ws.disparity_sweep(*single)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_disparity_sweep_dual_rejects_bad_arguments(cuda):
    dual, _ = dual_sweep_args(cuda)
    bad = list(dual)
    bad[1] = bad[1][:, :-1]
    with pytest.raises(ValueError, match="edepth_pad"):
        ws.disparity_sweep_dual(*bad)
    bad = list(dual)
    bad[3] = bad[3].double()
    with pytest.raises(ValueError, match="extra_pad"):
        ws.disparity_sweep_dual(*bad)


def ragged_planes(rng, h, w, num_planes):
    """scene_planes, or for one plane a plane at the scene's mean depth
    with a wide tolerance."""
    if num_planes > 1:
        return scene_planes(rng, h, w, num_planes)
    depth = scene_planes(rng, h, w, 2)[0]
    z = np.float32(depth.mean())
    return (depth, np.float32(1 / depth.min()), np.float32(0), np.array(
        [z], np.float32), np.array([0.3 * z], np.float32),
        np.array([-3.5], np.float32))


def ragged_sweep_args(cuda, b, h, w, num_planes, n_chan, bitmap, disp,
                      seed=0):
    """The single sweep's arguments at a ragged shape. ``bitmap``:
    computed, ones, or empty_tile (computed, with the second row tile's
    list empty). ``disp``: scene (the stereo step's zero padding), or
    last_column / beyond (padding filled with depth and payload, and a
    third of the planes moved to read the last padded column at the last
    pixel, or past either end of the row)."""
    rng = np.random.default_rng(seed + 100 * b + num_planes)
    cases = [ragged_planes(rng, h, w, num_planes) for _ in range(b)]

    def stack(i):
        return torch.from_numpy(np.stack([c[i] for c in cases])).to(cuda)
    d = stack(0)
    pad_l, pad_r = ws.pad_widths(w, 256)
    depth_pad = torch.nn.functional.pad(d, (pad_l, pad_r))
    color_pad = torch.nn.functional.pad(
        torch.rand(b, n_chan, h, w, device=cuda), (pad_l, pad_r))
    dv = stack(5)
    di, df = torch.floor(dv).to(torch.int32), dv - torch.floor(dv)
    if disp != "scene":
        wp = depth_pad.shape[-1]
        reps = -(-wp // w)
        depth_pad = d.repeat(1, 1, reps)[..., :wp].contiguous()
        color_pad = torch.rand(b, n_chan, h, wp, device=cuda)
        moved = torch.arange(num_planes, device=cuda) % 3 == 1
        far = pad_l + 255 if disp == "last_column" else pad_l + 300
        near = -pad_l - 40 if disp == "beyond" else di
        di = torch.where(moved, torch.full_like(di, far), di)
        if disp == "beyond":
            di = torch.where(torch.arange(num_planes, device=cuda) % 3 == 2,
                             torch.full_like(di, near), di)
    if num_planes > 1:
        act = ws.plane_activity(d, stack(1), stack(2), num_planes)
    else:
        act = torch.ones(b, -(-h // ws.BLOCK_ROWS), 1, dtype=torch.int32,
                         device=cuda)
    if bitmap == "ones":
        act = torch.ones_like(act)
    elif bitmap == "empty_tile":
        act[:, 1] = 0
    return (depth_pad, color_pad, di, df, stack(3), stack(4), num_planes,
            pad_l, act)


# (B, H, W, P, C, bitmap, disparities): W not a multiple of 32 or of 4
# (333: the rows are not 16-byte multiples, so the producer copies them
# by hand), H not a multiple of the 4-row band or the 64-row tile
RAGGED = {
    "b1_p33_w333": (1, 70, 333, 33, 3, "computed", "scene"),
    "p1_ones": (2, 65, 300, 1, 3, "ones", "scene"),
    "p128_empty_tile": (3, 200, 320, 128, 3, "empty_tile", "scene"),
    "p128_all_ones_c6": (2, 131, 257, 128, 6, "ones", "scene"),
    "last_padded_column": (2, 70, 300, 33, 3, "ones", "last_column"),
    "beyond_padding": (2, 70, 333, 33, 3, "computed", "beyond"),
    "b17_p128": (17, 67, 300, 128, 3, "computed", "scene"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(RAGGED))
def test_disparity_sweep_kernel_matches_plain_ragged(cuda, case):
    """Ragged shapes, 1 to 128 planes, empty and full plane lists, reads
    of the last padded column and past the row: the kernel equals the
    plain version bit for bit on every output."""
    args = ragged_sweep_args(cuda, *RAGGED[case])
    got = ws.disparity_sweep(*args)
    torch.cuda.synchronize()
    want = ws.disparity_sweep_plain(*args)
    assert want[2].any()
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w,num_planes,bitmap", [
    (17, 67, 333, 33, "computed"), (1, 45, 300, 128, "ones"),
    (2, 70, 300, 128, "empty_tile")])
def test_disparity_sweep_dual_kernel_matches_plain_ragged(cuda, b, h, w,
                                                          num_planes,
                                                          bitmap):
    """The fused sweep at ragged shapes, B = 1 and 17, with full and empty
    plane lists: bit for bit on all six outputs, and its main surface equal
    to the single sweep's under the same bitmap."""
    dual, single = dual_sweep_args(cuda, num_planes=num_planes, b=b, h=h,
                                   w=w)
    dual, single = list(dual), list(single)
    if bitmap == "ones":
        dual[8], dual[9] = torch.ones_like(dual[8]), torch.ones_like(dual[9])
        single[-1] = torch.ones_like(single[-1])
    elif bitmap == "empty_tile":
        dual[8][:, 1] = 0
        dual[9][:, 0] = 0
        single[-1][:, 1] = 0
    got = ws.disparity_sweep_dual(*dual)
    torch.cuda.synchronize()
    want = ws.disparity_sweep_dual_plain(*dual)
    for a, b_ in zip(got, want):
        assert a.shape == b_.shape and torch.equal(a, b_)
    # the single sweep's 64-row bitmap as the fused sweep's 32-row tiles
    fine = single[-1].repeat_interleave(2, dim=1)[
        :, :dual[8].shape[1]].contiguous()
    got = ws.disparity_sweep_dual(*dual[:8], fine, *dual[9:])
    for a, b_ in zip(got[:3], ws.disparity_sweep(*single)):
        assert torch.equal(a, b_)


def adversarial_sweep_args(cuda):
    """Rows alternating a, b and one plane with f where the sweep core's
    float32 estimate fma(f, b - a, a) lies two or more floats from the
    blend d; z = d and tol just short of the gap: every pixel reading
    (a, b) hits, and a pre-test without its margin would reject them all."""
    rng = np.random.default_rng(8)
    n = 200_000
    a = torch.from_numpy(rng.uniform(0.1, 1, n).astype(np.float32))
    b = torch.from_numpy(rng.uniform(10, 100, n).astype(np.float32))
    f = torch.from_numpy(rng.random(n).astype(np.float32))
    d = ws.blend(a, b, f)
    est = ws._fma32(f, b - a, a)
    i = int(torch.nonzero((d.view(torch.int32) - est.view(torch.int32))
                          .abs() >= 2)[0])
    a, b, f, d, est = a[i], b[i], f[i], d[i], est[i]
    inf = torch.tensor(float("inf"))
    tol = (d - torch.nextafter(est, inf) if d > est
           else torch.nextafter(est, -inf) - d)
    h, w = 8, 64
    pad_l, pad_r = ws.pad_widths(w, 128)
    wp = w + pad_l + pad_r
    row = torch.where(torch.arange(wp) % 2 == 0, a, b)
    return (row.expand(1, h, wp).contiguous().to(cuda),
            torch.rand(1, 3, h, wp, device=cuda),
            torch.zeros(1, 1, dtype=torch.int32, device=cuda),
            f.reshape(1, 1).to(cuda), d.reshape(1, 1).to(cuda),
            tol.reshape(1, 1).to(cuda), 1, pad_l,
            torch.ones(1, 1, 1, dtype=torch.int32, device=cuda))


# planted faults of the sweep core (csrc/sweep_sm90.cuh, pasted into each
# source), each (text, its replacement, the input that must show it)
SWEEP_FAULTS = {
    "sweep_unchanged": ("", "", None),
    # the pre-test without its margin
    "pretest_margin_0": ("constexpr float kPreMargin = 0x1p-19f;",
                         "constexpr float kPreMargin = 0.0f;", "adversarial"),
    # the first entry of every plane list is skipped
    "list_entry_skipped": (
        "    if (may_hit(a, b, e) && exact_hit(a, b, e, exact[k], d)) {",
        "    if (k > 0 && may_hit(a, b, e) && "
        "exact_hit(a, b, e, exact[k], d)) {",
        "scene"),
}
DUAL_FAULTS = {
    "dual_unchanged": ("", "", None),
    # the main stream sweeps the edge stream's plane list
    "edge_list_for_main": ("    const int ls = s;  // the stream's own list",
                           "    const int ls = kStreams - 1;", "dual"),
}


@pytest.fixture(scope="module")
def sweep_variants(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sweep_faults")
    libs = build_variants("disparity_sweep",
                          {k: v[:2] for k, v in SWEEP_FAULTS.items()}, tmp,
                          inline_header="sweep_sm90.cuh")
    libs.update(build_variants("disparity_sweep_dual",
                               {k: v[:2] for k, v in DUAL_FAULTS.items()},
                               tmp, inline_header="sweep_sm90.cuh"))
    return libs


@pytest.mark.gpu
@pytest.mark.parametrize("fault", list(SWEEP_FAULTS) + list(DUAL_FAULTS))
def test_sweep_bit_equality_fails_planted_faults(cuda, sweep_variants,
                                                 monkeypatch, fault):
    """Bit-equality with the plain versions passes the core built
    unchanged, on an adversarial input for the pre-test's margin, the
    scene with its bitmaps and the fused sweep's inputs, and fails each
    planted fault on the input named beside it."""
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    shows = {**SWEEP_FAULTS, **DUAL_FAULTS}[fault][2]
    name = ("disparity_sweep_dual" if fault in DUAL_FAULTS
            else "disparity_sweep")
    libs = {name: sweep_variants[fault]}
    load = cuda_build.load
    monkeypatch.setattr(cuda_build, "load",
                        lambda name: libs[name] if name in libs else load(name))
    equal = {}
    if "disparity_sweep" in libs:
        for kind, args in (("adversarial", adversarial_sweep_args(cuda)),
                           ("scene", ragged_sweep_args(
                               cuda, 2, 200, 320, 128, 3, "computed",
                               "scene"))):
            want = ws.disparity_sweep_plain(*args)
            assert want[2].float().mean() > 0.45
            got = ws.disparity_sweep(*args)
            torch.cuda.synchronize()
            equal[kind] = all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        dual, _ = dual_sweep_args(cuda)
        got = ws.disparity_sweep_dual(*dual)
        torch.cuda.synchronize()
        want = ws.disparity_sweep_dual_plain(*dual)
        equal["dual"] = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"sweep fault {fault}: bit-equal by input {equal}")
    if shows is None:
        assert all(equal.values()), equal
    else:
        assert not equal[shows], equal


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


# planted faults of csrc/block_causal_attention.cu (its mask policy for
# the bf16 core), each (text, its replacement); "unchanged" builds the
# source as it is
B3_FAULTS = {
    "unchanged": ("", ""),
    # the per-element test on the masked tiles ignores the ids
    "mask_ignored": ("    return key < ctx;\n", "    return key < p.n;\n"),
    # query tile 10 of (b, h) 0 leaves out its second key tile
    "one_key_tile_skipped": (
        "    return kt;   // every tile below key_end",
        "    return kt + (qt == 10 && bh == 0 && kt == 1);   // every tile "
        "below key_end"),
    # a key tile counts as seen whole when the tile's last query sees it
    "whole_tile_test_on_last_query": (
        "    return (kt + 1) * kBK > p.full_end[qt];",
        "    return (kt + 1) * kBK > p.key_end[qt];"),
}


def build_variants(source, faults, tmp, inline_header=None):
    """-> {fault: ctypes library} of ``csrc/<source>.cu`` with each planted
    fault (text, its replacement), all built at once in ``tmp`` beside
    copies of the headers; with ``inline_header``, that header's text is
    pasted in place of its #include first, so a fault may lie in it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    import ctypes

    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC_DIR / f"{source}.cu").read_text()
    if inline_header:
        include = f'#include "{inline_header}"'
        assert include in src
        src = src.replace(include, (cuda_build.CSRC_DIR /
                                    inline_header).read_text())
    for header in cuda_build.CSRC_DIR.glob("*.cuh"):
        (tmp / header.name).write_text(header.read_text())
    for fault, (old, new) in faults.items():
        text = src.replace(old, new) if old else src
        assert (text != src) == bool(old), fault
        (tmp / f"{fault}.cu").write_text(text)
    patch = pytest.MonkeyPatch()
    patch.setattr(cuda_build, "CSRC_DIR", tmp)
    patch.setattr(cuda_build, "BUILD_DIR", tmp / "build")
    try:
        cuda_build.build(list(faults))
        return {f: ctypes.CDLL(str(cuda_build.library_path(f)))
                for f in faults}
    finally:
        patch.undo()


@pytest.fixture(scope="module")
def b3_variants(tmp_path_factory):
    return build_variants("block_causal_attention", B3_FAULTS,
                          tmp_path_factory.mktemp("b3_faults"))


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
@pytest.mark.parametrize("d", [64, 128])
def test_block_causal_kernel_reads_strided_views(cuda, d):
    """(B, N, H, D) tensors passed as transpose(1, 2) views, as the DiT
    does, give exactly the contiguous call's result: the kernel reads each
    operand at its own strides."""
    b, n, h = 2, 1500, 3
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn(b, n, h, d, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    ids = (torch.arange(n, device=cuda) // 400).to(torch.int32)
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = bcm.block_causal_attention(*views, ids, d ** -0.5)
    want = bcm.block_causal_attention(*(t.contiguous() for t in views), ids,
                                      d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ratio = bcm.error_ratio(got, bcm.block_causal_attention_plain(
        *(t.float() for t in views), ids, d ** -0.5))
    assert ratio <= 1, ratio


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


def view_valid(views, n_real, device):
    """The validity vector of ``views`` concatenated sequences of n_real
    real tokens, each padded to the ViT's multiple."""
    n_tok = -(-n_real // apk.PAD_MULTIPLE) * apk.PAD_MULTIPLE
    return (torch.arange(n_tok, device=device) < n_real).repeat(views)


def packed_valid(pattern, n, device):
    if pattern == "all":
        return torch.ones(n, dtype=torch.bool, device=device)
    if pattern == "tail":
        return torch.arange(n, device=device) < n - 37
    if pattern == "leading":        # the first 130 keys are pads
        return torch.arange(n, device=device) >= 130
    if pattern == "holes":          # interleaved runs, one all-pad tile
        idx = torch.arange(n, device=device)
        return ((idx % 97) < 61) & ~((idx >= 256) & (idx < 384))
    raise ValueError(pattern)


def check_packed(qkv4, valid, heads, sm):
    """Kernel vs the plain version in float32 on the same inputs: real
    query rows within ``error_ratio``'s limit, every row finite."""
    got = apk.packed_flash_attention(qkv4, valid, heads, sm)
    torch.cuda.synchronize()
    want = apk.packed_flash_attention_plain(qkv4.float(), valid, heads, sm)
    assert got.shape == want.shape and got.dtype == qkv4.dtype
    assert torch.isfinite(got).all()
    return apk.error_ratio(got[:, valid], want[:, valid])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,d,pattern", [
    (2, 1000, 3, 64, "holes"), (1, 777, 16, 64, "tail"),
    (3, 333, 4, 16, "leading"), (2, 640, 2, 128, "all"),
    (1, 2113, 5, 32, "holes")])
def test_packed_attention_kernel_matches_plain(cuda, dtype, b, n, h, d,
                                               pattern):
    """Ragged N, any head count, interleaved pads, a leading run of pads
    and an all-pad key tile: the kernel, reading q, k, v in place from the
    packed tensor, equals the plain version within ``error_ratio``'s limit
    (float32 2e-5; bfloat16 2**-8 of each value plus 2**-5 of the output's
    RMS) on the real rows, pad rows are finite, and it counts one
    launch."""
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    qkv4 = torch.randn(b, n, 3 * h, d, generator=gen, device=cuda).to(dtype)
    before = apk.LAUNCHES["packed_flash_attention"]
    ratio = check_packed(qkv4, packed_valid(pattern, n, cuda), h, d ** -0.5)
    assert apk.LAUNCHES["packed_flash_attention"] == before + 1
    assert ratio <= 1, ratio


@pytest.mark.gpu
def test_packed_attention_no_valid_key_gives_zeros(cuda):
    qkv4 = torch.randn(1, 100, 6, 32, device=cuda)
    none = torch.zeros(100, dtype=torch.bool, device=cuda)
    got = apk.packed_flash_attention(qkv4, none, 2, 1.0)
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(got, apk.packed_flash_attention_plain(qkv4, none, 2,
                                                             1.0))


# planted faults of csrc/packed_flash_attention.cu (its mask policy)
B4_FAULTS = {
    "b4_unchanged": ("", ""),
    # mixed tiles are masked by the tail only, not by validity
    "b4_validity_ignored": (
        "    return (bits >> bit) & 1u;   // 0 past N: the bitmap is padded "
        "with 0\n", "    return key < p.n;\n"),
    # query tile 10 of (b, h) 0 leaves out its second key tile
    "b4_one_key_tile_skipped": (
        "    while (kt < end && p.tile_class[kt] == 0) ++kt;\n",
        "    kt += qt == 10 && bh == 0 && kt == 1;\n"
        "    while (kt < end && p.tile_class[kt] == 0) ++kt;\n"),
}


@pytest.fixture(scope="module")
def b4_variants(tmp_path_factory):
    return build_variants("packed_flash_attention", B4_FAULTS,
                          tmp_path_factory.mktemp("b4_faults"))


@pytest.mark.gpu
@pytest.mark.parametrize("fault", list(B4_FAULTS))
def test_packed_attention_tolerance_fails_planted_faults(cuda, b4_variants,
                                                         monkeypatch, fault):
    """Four DA3_L views in one cross-view sequence (1, 4 x 2368, 48, 64),
    bfloat16, 2305 real tokens per view: ``error_ratio``'s limit passes the
    kernel built unchanged and fails each planted fault of its source."""
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "load", lambda name: b4_variants[fault])
    valid = view_valid(4, 2305, cuda)
    gen = torch.Generator(device=cuda).manual_seed(13)
    qkv4 = torch.randn(1, valid.numel(), 48, 64, generator=gen,
                       device=cuda).to(torch.bfloat16)
    ratio = check_packed(qkv4, valid, 16, 0.125)
    print(f"B4 {fault}: error ratio {ratio:.3f}")
    assert (ratio <= 1) == (fault == "b4_unchanged"), ratio


@pytest.mark.gpu
def test_packed_attention_more_than_65535_heads(cuda):
    """B * H = 65568 (batch 2049, 32 heads) in one launch: the persistent
    grid walks (query tile, b * h) work tiles, so no grid dimension is
    bounded by B * H."""
    b, n, h, d = 2049, 40, 32, 64
    gen = torch.Generator(device=cuda).manual_seed(21)
    qkv4 = torch.randn(b, n, 3 * h, d, generator=gen,
                       device=cuda).to(torch.bfloat16)
    valid = torch.arange(n, device=cuda) < 33
    before = apk.LAUNCHES["packed_flash_attention"]
    ratio = check_packed(qkv4, valid, h, d ** -0.5)
    assert apk.LAUNCHES["packed_flash_attention"] == before + 1
    assert ratio <= 1, ratio


@pytest.mark.gpu
def test_packed_attention_rejects_bad_arguments(cuda):
    ok = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        apk.packed_flash_attention(torch.zeros(1, 8, 3, 12, device=cuda),
                                   ok, 1, 1.0)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        apk.packed_flash_attention(
            torch.zeros(1, 8, 3, 16, device=cuda, dtype=torch.float16), ok,
            1, 1.0)
    with pytest.raises(ValueError, match="3 \\* 2"):
        apk.packed_flash_attention(torch.zeros(1, 8, 3, 16, device=cuda),
                                   ok, 2, 1.0)
    with pytest.raises(ValueError, match="valid must be"):
        apk.packed_flash_attention(torch.zeros(1, 8, 3, 16, device=cuda),
                                   ok[:4], 1, 1.0)


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


@pytest.fixture
def no_tf32():
    """float32 convolutions and products in full float32 on the card."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = old


@pytest.mark.gpu
def test_mask_engine_card_matches_cpu(cuda, no_tf32):
    """U²-Net SEG_TINY in float32 (the same seeded weights) on the card
    and on the CPU: probabilities within 1e-4, masks differing only where
    the probability is within 1e-3 of the threshold."""
    from metric_depth_video_toolbox_tpu_torch.models import segmentation
    from metric_depth_video_toolbox_tpu_torch.pipeline import masks

    frames = np.random.default_rng(5).integers(0, 256, (4, 90, 160, 3),
                                               np.uint8)
    engines = {where: masks.MaskEngine(cfg=segmentation.SEG_TINY, work=64,
                                       device=where)
               for where in ("cpu", cuda)}
    p = {k: e.probabilities(frames).cpu() for k, e in engines.items()}
    assert (p[cuda] - p["cpu"]).abs().max().item() <= 1e-4
    m = {k: e.masks_for(frames) for k, e in engines.items()}
    flips = m[cuda] != m["cpu"]
    assert (np.abs(p["cpu"].numpy()[flips] - 0.5) < 1e-3).all()


@pytest.mark.gpu
def test_basic_infill_frame_card_matches_cpu(cuda):
    """The march (which pixel each hole copies) bit for bit, the blurred
    frames within one code."""
    from metric_depth_video_toolbox_tpu_torch.ops import infill as iops
    from metric_depth_video_toolbox_tpu_torch.pipeline import infill_video

    rng = np.random.default_rng(6)
    sbs = torch.from_numpy(rng.integers(0, 256, (3, 120, 320, 3), np.uint8))
    mask = rng.integers(0, 256, (3, 120, 320, 3), np.uint8)
    mask[rng.random((3, 120, 320)) < 0.8] = 0
    mask[:, 30:60, 100:130] = (0, 255, 0)
    mask = torch.from_numpy(mask)
    hole = mask.ne(0).any(-1)
    normals = mask.float() / 255.0 * 2.0 - 1.0
    want = iops.normal_march_infill(sbs, hole, normals)
    got = iops.normal_march_infill(sbs.to(cuda), hole.to(cuda),
                                   normals.to(cuda)).cpu()
    assert torch.equal(got, want)
    want = infill_video.basic_infill_frame(sbs, mask)
    got = infill_video.basic_infill_frame(sbs.to(cuda), mask.to(cuda)).cpu()
    assert (got.int() - want.int()).abs().max().item() <= 1


@pytest.mark.gpu
def test_movie_to_3d_on_the_card_launches_the_sweep(cuda, tmp_path):
    """``movie_to_3d`` at a tiny size on the card (two 16-frame scenes,
    VDA vitt, SEG_TINY masks, the basic infill, stereo batches of 4): the
    disparity sweep runs twice per stereo batch, and no other kernel of
    the port runs."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu_torch.io import mkv
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import segmentation
    from metric_depth_video_toolbox_tpu_torch.pipeline import masks, movie

    rng = np.random.default_rng(7)
    scenes = []
    for tint in ((120, 0, 0), (0, 40, 120)):
        base = rng.integers(0, 120, (14, 48, 3)) + np.array(tint)
        tex = np.kron(base.astype(np.uint8), np.ones((4, 4, 1), np.uint8))
        scenes.append(np.stack([tex[:48, 2 * i:2 * i + 64]
                                for i in range(16)]))
    clip = str(tmp_path / "clip.mkv")
    vio.save_rgb_video(np.concatenate(scenes), clip, 24)
    tables = (ws.LAUNCHES, bcm.LAUNCHES, apk.LAUNCHES)
    for table in tables:
        for key in table:
            table[key] = 0
    out = movie.movie_to_3d(
        clip, xfov=60.0, batch_size=4, device=cuda,
        engine_kwargs={"size": "vitt", "input_size": 42, "window": 8,
                       "overlap": 2},
        mask_engine=masks.MaskEngine(cfg=segmentation.SEG_TINY, work=40,
                                     device=cuda))
    counts = {k: v for table in tables for k, v in table.items() if v}
    assert counts == {"disparity_sweep": 2 * 2 * 4}
    with vio.VideoReader(out) as r:
        assert (r.frame_count, r.width) == (32, 128)
    assert mkv.get_stereo_mode(out) == mkv.STEREO_SBS_LEFT_FIRST


@pytest.mark.gpu
@pytest.mark.parametrize("graph", ["diffusion_tiny", "svd_tiny_clip"])
def test_diffusion_infill_engine_card_matches_cpu(cuda, no_tf32, graph):
    """``DiffusionInfillEngine.infill_chunk`` in float32 on the same weights
    and noise on the card and on the CPU (DIFFUSION_TINY with mono
    conditioning; SVD_TINY with a CLIP_TINY context): the sampled latents
    within 1e-4 of their largest value, the uint8 frames within 1 LSB on at
    most 0.5% of bytes, the pixels outside the holes unchanged."""
    from metric_depth_video_toolbox_tpu_torch.models import clip, diffusion
    from metric_depth_video_toolbox_tpu_torch.models import svd
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as idf

    kw = dict(work_hw=(64, 96), chunk=5)
    if graph == "svd_tiny_clip":
        tower = diffusion.init_weights(clip.CLIPVisionTower(clip.CLIP_TINY),
                                       torch.Generator().manual_seed(2))
        kw.update(cfg=svd.SVD_TINY, vae_cfg=svd.SVD_VAE_TINY,
                  clip_cfg=clip.CLIP_TINY, clip_params=tower.state_dict())
    else:
        kw.update(mono_conditioning=True)
    rng = np.random.default_rng(8)
    frames = rng.integers(0, 256, (5, 90, 160, 3), np.uint8)
    hole = np.zeros((5, 90, 160), bool)
    hole[:, 20:60, 30:90] = True
    mono = rng.integers(0, 256, (5, 90, 160, 3), np.uint8)
    cpu = idf.DiffusionInfillEngine(device="cpu", **kw)
    cpu._ensure()
    card = idf.DiffusionInfillEngine(device=cuda, params=cpu.model
                                     .state_dict(), **kw)
    with torch.no_grad():
        lat = cpu.model.encode(torch.zeros((5, 64, 96, 3))).shape
    noise = torch.randn(lat, generator=torch.Generator().manual_seed(3))
    z, out = {}, {}
    for name, eng in (("cpu", cpu), ("card", card)):
        eng.on_latents = lambda v, name=name: z.setdefault(name, v.cpu())
        out[name] = eng.infill_chunk(frames, hole, mono, noise=noise)
    err = (z["card"] - z["cpu"]).abs().max() / z["cpu"].abs().max()
    assert err.item() <= 1e-4
    d = np.abs(out["card"].astype(int) - out["cpu"].astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005
    np.testing.assert_array_equal(out["card"][~hole], frames[~hole])
