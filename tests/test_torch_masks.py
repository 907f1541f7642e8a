"""The port's subject masks and convergence depths against the JAX
package's: U²-Net, ``MaskEngine``, ``generate_video_mask``,
``masked_mean_depth`` and ``find_convergence_depths``.

Tolerances:
- U²-Net SEG_TINY float32 probabilities within 1e-5 absolute (measured
  ~2e-7; float32 sums of the convolutions in another order);
- ``MaskEngine`` probabilities within 1e-5, and a mask pixel may differ
  only where the JAX probability lies within 1e-4 of the threshold;
- convergence depths within rtol 1e-5 (float32 sums over a frame in
  another order), NaN exactly where the JAX package gives NaN.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu.models import segmentation as jseg
from metric_depth_video_toolbox_tpu.pipeline import convergence as jconv
from metric_depth_video_toolbox_tpu.pipeline import masks as jmasks
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import segmentation as tseg
from metric_depth_video_toolbox_tpu_torch.pipeline import convergence as tconv
from metric_depth_video_toolbox_tpu_torch.pipeline import masks as tmasks

WORK = 40
FLIP = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU ops while this module runs:
    its tensors are small, and in the parallel test run the spinning
    thread pools of several processes on the same cores slow its work
    several times over."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _precise_matmul():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield
    jax.config.update("jax_default_matmul_precision", old)


# one compiled program per input shape (an eager apply takes ~9 s)
_apply = jax.jit(jseg.U2Net(jseg.SEG_TINY).apply)


@pytest.fixture(scope="module")
def flax_params():
    """SEG_TINY's Flax tree, shared by every test of the module, drawn
    with numpy: LeCun-normal kernels, and biases, scales and running
    statistics away from their initial values."""
    ref = jax.eval_shape(jseg.U2Net(jseg.SEG_TINY).init,
                         jax.random.PRNGKey(0), jnp.zeros((1, WORK, WORK, 3)))
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, leaf.shape)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape)
        return rng.normal(0, 0.1, leaf.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: draw(p, a).astype(np.float32), ref)


def _port(params):
    return from_jax.load_flax_params(tseg.U2Net(tseg.SEG_TINY), params)


def test_u2net_tiny_matches_flax(flax_params):
    x = np.random.default_rng(1).random((2, 37, 45, 3)).astype(np.float32)
    want = np.asarray(_apply(flax_params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(flax_params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 37, 45)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_u2net_tiny_matches_converted_upstream_state_dict():
    """A synthetic u2net-layout state dict (random weights and running
    statistics) through the JAX package's ``convert_u2net``: the port on
    the converted tree against the Flax model on it."""
    from test_weight_exact_u2net import TU2NET

    tmodel = TU2NET(jseg.SEG_TINY)
    g = torch.Generator().manual_seed(17)
    sd = {}
    for k, v in tmodel.state_dict().items():
        if not v.dtype.is_floating_point:
            sd[k] = v.numpy()
        elif k.endswith("running_var"):
            sd[k] = (torch.rand(v.shape, generator=g) + 0.5).numpy()
        elif k.endswith("running_mean"):
            sd[k] = (torch.randn(v.shape, generator=g) * 0.1).numpy()
        else:
            sd[k] = (torch.randn(v.shape, generator=g) * 0.05).numpy()
    params = jconvert.convert_u2net(sd)
    x = np.random.default_rng(23).uniform(
        0.05, 1.0, (2, 37, 45, 3)).astype(np.float32)
    want = np.asarray(_apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_u2net_small_layer_shapes():
    """SEG_SMALL (the u2netp layout): every Flax leaf maps onto a port
    parameter or buffer of the same shape, and nothing is left over."""
    ref = jax.eval_shape(jseg.U2Net(jseg.SEG_SMALL).init,
                         jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), ref)
    want = {k: tuple(v.shape)
            for k, v in from_jax.flax_to_state_dict(zeros).items()}
    model = tseg.U2Net(tseg.SEG_SMALL)
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert got["stage1.rebnconvin.conv.weight"] == (64, 3, 3, 3)
    assert got["stage6.rebnconv4.bn.var"] == (16,)
    assert got["outconv.weight"] == (1, 6, 1, 1)
    from_jax.load_flax_params(model, zeros)


def _jax_probabilities(params, frames, work):
    """The JAX MaskEngine's probability map before its threshold."""
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0
    b, h, w = frames.shape[:3]
    x = jax.image.resize(x, (b, work, work, 3), "bilinear")
    p = _apply(params, x)
    return np.asarray(jax.image.resize(p, (b, h, w), "bilinear"))


def _gap_threshold(p):
    """A threshold in the widest gap between the middle half of the
    probabilities, so that masks have both values and no pixel lies near
    it."""
    s = np.sort(p.reshape(-1))
    mid = s[len(s) // 4: 3 * len(s) // 4]
    i = int(np.argmax(np.diff(mid)))
    return float((mid[i] + mid[i + 1]) / 2)


@pytest.fixture(scope="module")
def mask_case(flax_params):
    """Odd frame sizes: 29 -> 40 rows (up) and 53 -> 40 columns (down),
    then back."""
    frames = np.random.default_rng(2).integers(0, 256, (3, 29, 53, 3),
                                               np.uint8)
    p = _jax_probabilities(flax_params, frames, WORK)
    thr = _gap_threshold(p)
    jeng = jmasks.MaskEngine(cfg=jseg.SEG_TINY, params=flax_params,
                             work=WORK, threshold=thr)
    teng = tmasks.MaskEngine(cfg=tseg.SEG_TINY, work=WORK, threshold=thr,
                             params=from_jax.flax_to_state_dict(flax_params),
                             device="cpu")
    return frames, p, thr, jeng, teng


def test_mask_engine_probabilities_match(mask_case):
    frames, want, _, _, teng = mask_case
    got = teng.probabilities(frames).numpy()
    assert got.shape == want.shape == (3, 29, 53)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_mask_engine_masks_match(mask_case):
    frames, p, thr, jeng, teng = mask_case
    want = np.asarray(jeng.masks_for(frames))
    got = teng.masks_for(frames)
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    assert 0 < (want == 255).mean() < 1
    flips = got != want
    assert (np.abs(p[flips] - thr) < FLIP).all()


def test_generate_video_mask_file_bytes(tmp_path, mask_case):
    """The same frame bytes, decoded, and files of the same size (the
    Matroska muxer draws its UIDs at random, so the files themselves
    differ in those bytes)."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.io import video as jvio
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    frames, _, _, jeng, teng = mask_case
    clip = str(tmp_path / "clip.mkv")
    jvio.save_rgb_video(np.concatenate([frames, frames[::-1]]), clip, 24)
    want = jmasks.generate_video_mask(clip, output=str(tmp_path / "j.mkv"),
                                      batch_size=3, engine=jeng)
    got = tmasks.generate_video_mask(clip, output=str(tmp_path / "t.mkv"),
                                     batch_size=3, engine=teng)
    frames_of = {}
    for path in (want, got):
        with tvio.VideoReader(path) as r:
            frames_of[path] = r.read_all()
    assert frames_of[got].shape == frames_of[want].shape
    assert frames_of[got].shape[0] == 6
    assert 0 < frames_of[got].mean() < 255
    assert frames_of[got].tobytes() == frames_of[want].tobytes()
    import os
    assert os.path.getsize(got) == os.path.getsize(want)


def test_masked_mean_depth_matches():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 30.0, (4, 20, 28)).astype(np.float32)
    weight = (rng.random((4, 20, 28)) > 0.6).astype(np.float32)
    weight[2] = 0.0
    want = np.asarray(jconv.masked_mean_depth(jnp.asarray(depth),
                                              jnp.asarray(weight)))
    got = tconv.masked_mean_depth(torch.from_numpy(depth),
                                  torch.from_numpy(weight)).numpy()
    assert np.isnan(got[2]) and np.isnan(want).tolist() == \
        np.isnan(got).tolist()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("mask", ["none", "short"])
def test_find_convergence_depths_json_matches(tmp_path, mask):
    """A 7-frame depth video; the mask video, when there is one, has 4
    frames (the rest count as white), the second of them empty (NaN) and
    the third grey at 240 (not above the cut) with a patch at 241."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.io import video as jvio

    rng = np.random.default_rng(4)
    depth = rng.uniform(1.0, 40.0, (7, 24, 32)).astype(np.float32)
    dpath = str(tmp_path / "d.mkv")
    jvio.save_depth_video(depth, dpath, 24, 100.0)
    mpath = None
    if mask == "short":
        m = np.zeros((4, 24, 32), np.uint8)
        m[0, 4:20, 6:26] = 255
        m[2] = 240
        m[2, 2:9, 3:12] = 241
        m[3] = (rng.random((24, 32)) > 0.5) * 255
        mpath = str(tmp_path / "m.mkv")
        jvio.save_rgb_video(np.repeat(m[..., None], 3, -1), mpath, 24)
    out = {}
    for name, mod, kw in (("jax", jconv, {}),
                          ("torch", tconv, {"device": "cpu"})):
        path = mod.find_convergence_depths(
            dpath, mask_video=mpath, batch_size=3,
            output=str(tmp_path / f"{name}.json"), **kw)
        with open(path, encoding="utf-8") as f:
            out[name] = np.asarray(json.load(f), np.float64)
    want, got = out["jax"], out["torch"]
    assert got.shape == want.shape == (7,)
    assert np.isnan(got).tolist() == np.isnan(want).tolist()
    assert np.isnan(want).sum() == (1 if mask == "short" else 0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("kind", ["convergence", "tracking"])
def test_sidecars_byte_equal(tmp_path, kind):
    """The convergence and tracking sidecars: the same bytes as the JAX
    package's, read back alike, and the dense tracking layout."""
    from metric_depth_video_toolbox_tpu.io import sidecar as jside
    from metric_depth_video_toolbox_tpu_torch.io import sidecar as tside

    rng = np.random.default_rng(5)
    if kind == "convergence":
        data = rng.uniform(1, 30, 6).astype(np.float32)
        data[2] = np.nan
        save, load = "save_convergence_depths", "load_convergence_depths"
    else:
        data = [np.c_[rng.choice(50, n, replace=False),
                      rng.uniform(0, 640, (n, 2))].astype(np.float32)
                for n in (3, 0, 5)]
        save, load = "save_tracking", "load_tracking"
    jp, tp = tmp_path / "j.json", tmp_path / "t.json"
    getattr(jside, save)(str(jp), data)
    getattr(tside, save)(str(tp), data)
    assert jp.read_bytes() == tp.read_bytes()
    got, want = getattr(tside, load)(str(tp)), getattr(jside, load)(str(tp))
    if kind == "convergence":
        np.testing.assert_array_equal(got, want)
        return
    assert len(got) == 3 and all(a.dtype == np.float32 for a in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for cap in (None, 4):
        for a, b in zip(tside.tracking_to_dense(got, max_tracks=cap),
                        jside.tracking_to_dense(want, max_tracks=cap)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_video_helpers_match_jax(tmp_path):
    """``save_grayscale_video`` (the same decoded frames), ``video_info``
    and ``VideoReader.read_frame`` of the port against the JAX package's."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.io import video as jvio
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    frames = np.random.default_rng(6).uniform(-1, 12, (5, 24, 32, 1))
    frames = frames.astype(np.float32)
    out = {}
    for name, mod in (("jax", jvio), ("torch", tvio)):
        path = str(tmp_path / f"{name}.mkv")
        mod.save_grayscale_video(frames, path, 24, 10.0)
        assert tvio.video_info(path) == jvio.video_info(path)
        with tvio.VideoReader(path) as r:
            out[name] = r.read_all()
        with tvio.VideoReader(path) as r, jvio.VideoReader(path) as j:
            np.testing.assert_array_equal(r.read_frame(3), j.read_frame(3))
            assert r.read_frame(9) is None
    assert out["torch"].shape == (5, 24, 32, 3)
    np.testing.assert_array_equal(out["torch"], out["jax"])
