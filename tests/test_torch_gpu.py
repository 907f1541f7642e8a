"""Tests that need a CUDA card: each kernel of the port against its plain
PyTorch version. They skip without a card. This file imports neither JAX
nor the JAX package, so it also runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

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
