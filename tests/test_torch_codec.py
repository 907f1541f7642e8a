"""The port's depth codec against the JAX package's: the same bytes for the
linear codec in both packings, NaN/inf/out-of-range included, and the same
decodes. The log codec is evaluated in float64 in the port (as upstream
numpy does); XLA's float32 log1p is not correctly rounded, so there the
codes may differ by one on a small share of values (stated below)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from metric_depth_video_toolbox_tpu.ops import codec as jcodec
from metric_depth_video_toolbox_tpu_torch.ops import codec as tcodec

SPECIALS = np.array([0.0, 100.0, 150.0, -1.0, np.inf, -np.inf, np.nan,
                     1e-7, 99.9999, 20.0, 7.3], np.float32)


def _depths(seed, max_depth):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.1 * max_depth, 1.2 * max_depth, 50000)
    return np.concatenate([d.astype(np.float32), SPECIALS])


@pytest.mark.parametrize("max_depth", [100.0, 20.0, 7.3])
@pytest.mark.parametrize("bit16", [True, False])
def test_linear_encode_bytes_identical(max_depth, bit16):
    d = _depths(0, max_depth)
    want = np.asarray(jcodec.encode_depth_frame(jnp.asarray(d), max_depth,
                                                bit16=bit16))
    got = tcodec.encode_depth_frame(torch.from_numpy(d), max_depth,
                                    bit16=bit16).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bit16", [True, False])
@pytest.mark.parametrize("average_rg", [False, True])
def test_linear_decode_identical(bit16, average_rg):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (4, 16, 24, 3), dtype=np.uint8)
    want = np.asarray(jcodec.decode_depth_frame(
        jnp.asarray(rgb), 100.0, bit16=bit16, average_rg=average_rg))
    got = tcodec.decode_depth_frame(torch.from_numpy(rgb), 100.0,
                                    bit16=bit16,
                                    average_rg=average_rg).numpy()
    np.testing.assert_array_equal(got, want)


def test_nan_and_limits_encode_as_documented():
    d = torch.tensor([np.nan, 0.0, -1.0, 1e-7, 100.0, 150.0, np.inf,
                      99.9999])
    rgb = tcodec.encode_depth_frame(d, 100.0).numpy()
    assert (rgb[:4] == 0).all()
    assert (rgb[4:] == [252, 252, 5]).all()


def test_log_codec_within_one_code():
    """Codes within 1 of the JAX package's, on at most 0.5% of values
    (measured: 0.15% here); decodes within 4 float32 ulps relative
    (measured: 3.2e-7)."""
    d = _depths(2, 100.0)
    want = np.asarray(jcodec.encode_depth_to_uint32_log(
        jnp.asarray(d), 100.0)).astype(np.int64)
    got = tcodec.encode_depth_to_uint32_log(torch.from_numpy(d),
                                            100.0).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 5e-3
    for bit16 in (True, False):
        rgb = np.asarray(jcodec.encode_depth_frame(
            jnp.asarray(d), 100.0, bit16=bit16, log=True))
        dec_j = np.asarray(jcodec.decode_depth_frame(
            jnp.asarray(rgb), 100.0, bit16=bit16, log=True))
        dec_t = tcodec.decode_depth_frame(torch.from_numpy(rgb), 100.0,
                                          bit16=bit16, log=True).numpy()
        np.testing.assert_allclose(dec_t, dec_j, rtol=5e-7, atol=1e-12)


def test_quantization_step_matches():
    for bit16 in (True, False):
        assert tcodec.quantization_step(100.0, bit16) == \
            jcodec.quantization_step(100.0, bit16)


def test_depth_file_decodes_identically_across_packages(tmp_path):
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.io import video as jvio
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 60.0, (3, 24, 32)).astype(np.float32)
    pj = str(tmp_path / "jax_depth.mkv")
    pt = str(tmp_path / "torch_depth.mkv")
    jvio.save_depth_video(depth, pj, 24, 100.0)
    tvio.save_depth_video(depth, pt, 24, 100.0)
    out = {}
    for path in (pj, pt):
        r_t = tvio.DepthVideoReader(path, 100.0)
        r_j = jvio.DepthVideoReader(path, 100.0)
        a, b = r_t.read_depth_batch(8), r_j.read_depth_batch(8)
        r_t.close()
        r_j.close()
        np.testing.assert_array_equal(a, b)
        out[path] = a
    np.testing.assert_array_equal(out[pj], out[pt])
