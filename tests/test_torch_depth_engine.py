"""The slice as a whole against the JAX package: the VDA engine (vitt,
float32, window 8, overlap 2) on a 10-frame 48x64 clip with the same
weights in both packages, then the depth codec and the movie-configuration
stereo step on the result.

Tolerances:
- relative disparity within 1e-4 of its largest magnitude (measured
  ~2e-6 relative);
- the metric anchor runs in bfloat16 in both packages (the JAX engine
  keeps the anchor preset's bfloat16 even with ``fp32=True``, and the
  port does the same), and bfloat16 rounds at other places in XLA and
  PyTorch: anchor depth within 3e-2 of its largest magnitude (measured
  1.2e-2), and metric depth fitted against it within 15% relative
  (measured 8.9%: with random weights the anchor is near zero and the fit
  amplifies it), counted where the fitted inverse depth is not within 1%
  of the largest of zero (1/inv amplifies any rounding without bound);
- metric depth fitted against a reference depth video (float32 end to
  end) within 1e-4 relative (measured 2.6e-6);
- encoded depth codes within one step on 99% of pixels, and the SBS u8
  frames to the stereo budget of test_torch_stereo.py (1 LSB on at most
  0.5% of bytes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.models import video_depth as jvd
from metric_depth_video_toolbox_tpu.ops import codec as jcodec
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu.pipeline import stereo as jst
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.ops import codec as tcodec
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from metric_depth_video_toolbox_tpu_torch.pipeline import stereo as tst
from port_helpers import _one_torch_thread  # noqa: F401

T, H, W = 10, 48, 64
INPUT_SIZE = 42          # working resolution 42x56: the shrinking path
ENGINE = dict(size="vitt", fp32=True, window=8, overlap=2,
              input_size=INPUT_SIZE)


def clip():
    """A panning textured scene (uint8 frames)."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 200, (H // 4 + 2, W // 4 + 2 * T, 3), np.uint8)
    tex = np.kron(base, np.ones((4, 4, 1), np.uint8))
    return np.stack([tex[:H, 2 * i:2 * i + W] for i in range(T)])


@pytest.fixture(scope="module")
def engines():
    frames = clip()
    jeng = jdepth.VDAEngine(data_parallel=False, **ENGINE)
    work = jda.working_resolution(H, W, INPUT_SIZE, 14)
    jeng._ensure_params(work)
    teng = tdepth.VDAEngine(
        device="cpu", params=from_jax.flax_to_state_dict(jeng._params),
        anchor_params=from_jax.flax_to_state_dict(jeng._anchor_params),
        **ENGINE)
    return frames, work, jeng, teng


def test_relative_disparity_and_anchor_match(engines):
    frames, work, jeng, teng = engines
    want = jvd.infer_video_depth(jeng._apply, jeng._params, frames, work,
                                 (H, W), window=8, overlap=2)
    model, anchor = teng.models(work)
    got = tdepth.vd.infer_video_depth(model, frames, work, (H, W),
                                      window=8, overlap=2, device="cpu")
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=0)
    want_a = np.asarray(jda.infer_depth(jeng._anchor_apply,
                                        jeng._anchor_params,
                                        jnp.asarray(frames[:4]), (H, W),
                                        work))
    got_a = tdepth.da.infer_depth(anchor, torch.from_numpy(frames[:4]),
                                  (H, W), work).numpy()
    np.testing.assert_allclose(got_a, want_a,
                               atol=3e-2 * np.abs(want_a).max(), rtol=0)


REFERENCE = (2.0 + 3.0 * np.random.default_rng(1).random((T, H, W))
             ).astype(np.float32)


@pytest.fixture(scope="module")
def metric(engines):
    """{anchor | reference: (JAX metric depth, port metric depth)}."""
    frames, _, jeng, teng = engines
    return {kind: (jeng.infer_video(frames, reference_depth=ref),
                   teng.infer_video(frames, reference_depth=ref))
            for kind, ref in (("anchor", None), ("reference", REFERENCE))}


@pytest.mark.parametrize("kind,rtol", [("anchor", 0.15),
                                       ("reference", 1e-4)])
def test_metric_depth_matches(metric, kind, rtol):
    want, got = metric[kind]
    assert got.shape == want.shape == (T, H, W)
    assert got.dtype == np.float32
    assert np.isfinite(got).all() and got.min() >= 0
    # pixels where 1/depth is well away from 0 and the clamp at max_depth
    inv = 1.0 / np.maximum(want, 1e-6)
    ok = (want < 100.0) & (inv > 0.01 * inv.max())
    assert ok.mean() > 0.95
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol)
    assert ((got >= 100.0) == (want >= 100.0)).mean() > 0.99


def test_slice_encode_and_stereo_match(metric):
    """The port's metric depth -> its codec -> its stereo step, held
    stage by stage: the codes against the JAX package's encoding of its
    own metric depth, then the SBS frames against the JAX stereo step on
    the same encoded frames (a code one step off moves a silhouette by a
    whole pixel, so the u8 budget is held on shared input)."""
    want_depth, got_depth = metric["reference"]
    want_rgb = np.asarray(jcodec.encode_depth_frame(
        jnp.asarray(want_depth[:2]), 100.0))
    got_rgb = tcodec.encode_depth_frame(torch.from_numpy(got_depth[:2]),
                                        100.0).numpy()
    # top code byte: identical wherever depth agrees to the tolerance
    code = lambda rgb: rgb[..., 0].astype(int) * 256 + rgb[..., 2]
    assert (np.abs(code(got_rgb) - code(want_rgb)) <= 1).mean() > 0.99
    frames = clip()[:2]
    k = np.asarray(jst.geo.camera_matrix_from_fov(W, H, xfov_deg=60.0),
                   np.float32)
    cfg = dict(width=W, height=H, max_depth=100.0, remove_edges=True,
               place_edge_points=True, make_infill_mask=True,
               has_convergence=True)
    # op by op, as in test_torch_stereo.py
    step = jax.vmap(lambda d, c: jst.stereo_frame(
        d, c, jnp.asarray(k), jnp.asarray(k), jnp.eye(4), jnp.asarray(2.0),
        jnp.asarray(1.0), cfg=jst.StereoConfig(
            out_width=W, out_height=H, **cfg)))
    want = step(jnp.asarray(got_rgb), jnp.asarray(frames))
    kt = torch.from_numpy(k).expand(2, 3, 3)
    got = tst.stereo_frame(torch.from_numpy(got_rgb),
                           torch.from_numpy(frames), kt, kt,
                           torch.eye(4).expand(2, 4, 4),
                           torch.full((2,), 2.0), torch.ones(2),
                           tst.StereoConfig(**cfg))
    for key in ("image", "infill_mask"):
        a, b = got[key].numpy(), np.asarray(want[key])
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 0.005, (key, d.max())


def test_unported_engine_options_raise():
    with pytest.raises(NotImplementedError, match="A16"):
        tdepth.VDAEngine(data_parallel=True, device="cpu")


def test_depth_cli_flags_and_defaults_match():
    from metric_depth_video_toolbox_tpu.cli import video_metric_convert as jc
    from metric_depth_video_toolbox_tpu_torch.cli import \
        video_metric_convert as tc

    def key(a):
        return (tuple(a.option_strings), a.dest, a.default, a.type,
                a.required, tuple(a.choices or ()))
    assert sorted(map(key, jc.build_parser()._actions), key=str) == \
        sorted(map(key, tc.build_parser()._actions), key=str)


def test_depth_file_to_file(tmp_path, engines):
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    frames, _, _, teng = engines
    path = str(tmp_path / "clip.mkv")
    tvio.save_rgb_video(frames, path, 24)
    out = tdepth.run_vda(path, engine=teng)
    with tvio.DepthVideoReader(out, 100.0) as r:
        depth = r.read_depth_batch(64)
    assert depth.shape == (T, H, W)
    want = teng.infer_video(frames)
    assert np.abs(depth - want).max() <= tcodec.quantization_step(100.0)


def test_rolling_average_path_matches(engines):
    """Rolling-average alignment against a reference depth video (float32
    end to end): within 1e-4 relative, as the first-frames fit."""
    frames, _, jeng, teng = engines
    jeng.rolling_average = teng.rolling_average = 4
    jeng.anchor_stride = teng.anchor_stride = 3
    try:
        want = jeng.infer_video(frames, reference_depth=REFERENCE)
        got = teng.infer_video(frames, reference_depth=REFERENCE)
    finally:
        jeng.rolling_average = teng.rolling_average = 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_rolling_scale_shift_matches():
    """Within 1e-4 relative: the 2x2 normal equations cancel (det =
    a00*a11 - a01^2), so float32 sums taken in another order move the
    shift by ~2e-5 relative (measured)."""
    from metric_depth_video_toolbox_tpu.ops import solvers as jsol
    from metric_depth_video_toolbox_tpu_torch.ops import solvers as tsol

    rng = np.random.default_rng(4)
    disp = rng.random((4, 12, 16)).astype(np.float32) + 0.5
    inv = 2.0 * disp + 0.3 + 0.01 * rng.standard_normal(disp.shape)
    inv = inv.astype(np.float32)
    idx = np.array([0, 3, 6, 9])
    want = jsol.rolling_scale_shift(disp, inv, idx, 11, window=4)
    got = tsol.rolling_scale_shift(torch.from_numpy(disp),
                                   torch.from_numpy(inv), idx, 11, window=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-4)
