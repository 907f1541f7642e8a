"""Frame data parallelism in the port's engines and the movie's threaded
scene renders, against the unsharded port and the JAX package.

The port splits a batch or a window's time axis over a frame mesh of
replicas (``parallel.sharding.FrameReplicas``); here the mesh is two CPU
replicas (``parallel.mesh.replicas`` patched, the seam the chip run uses on
one card). The JAX engines run with ``data_parallel=True`` on the 8
virtual CPU devices of ``tests/conftest.py``.

Tolerances, none looser than ``tests/test_parallel.py``'s between the JAX
package's sharded and unsharded engines:
- the port with a mesh against the port without one: within 1e-6 of the
  largest value (the replicas' matmuls and convolutions run on fewer
  frames, which can change their float32 summation order; measured up to
  2e-6 relative for the single-frame engine, exact for the others on this
  CPU), the SVD graph's latents within 1e-5 of the largest (measured
  1.9e-6) and the uint8 chunks within ``assert_u8_budget``;
- against the JAX sharded engine, in float32: VDA's metric depth fitted to
  a reference video within 1e-4 relative (JAX: 1e-2 mean absolute),
  single-frame depth within 1e-4 of the largest (JAX: 5e-3 mean, 5e-2
  max), MVS depth within 1e-4 of the largest (the JAX engine's batch is
  rounded up to 8), the diffusion chunk's uint8 frames within 1 LSB on at
  most 0.5% of bytes (JAX: 2 LSB), given the JAX engine's noise;
- the threaded step 5's SBS and infill-mask frames byte for byte against
  the serial one's (two writes of the same frames differ in their
  container headers' ids and dates).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.models import diffusion as jd
from metric_depth_video_toolbox_tpu.pipeline import depth as jdepth
from metric_depth_video_toolbox_tpu.pipeline import infill_diffusion as jid
from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as tda
from metric_depth_video_toolbox_tpu_torch.models import diffusion as td
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import svd as ts
from metric_depth_video_toolbox_tpu_torch.parallel import mesh as tmesh
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from metric_depth_video_toolbox_tpu_torch.pipeline import \
    infill_diffusion as tid
from metric_depth_video_toolbox_tpu_torch.pipeline import movie as tmovie
from port_helpers import (_one_torch_thread, float32_presets,  # noqa: F401
                          init_like)
from test_torch_diffusion import flax_like
from test_torch_mvs import float32_mvs, mvs_tree, poses  # noqa: F401
from test_torch_mvs import clip as mvs_clip
from test_torch_stereo import assert_u8_budget

REPLICAS = 2


@pytest.fixture
def mesh2(monkeypatch):
    """Every engine built in the test spans two CPU replicas."""
    monkeypatch.setattr(tmesh, "replicas",
                        lambda device: tmesh.frame_mesh(REPLICAS, device))


def frames_of(t, h=28, w=28, seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (t, h, w, 3)).astype(np.uint8)


def test_eight_virtual_devices_and_one_cpu():
    assert jax.device_count() >= 8
    assert tmesh.replicas("cpu") == [torch.device("cpu")]
    assert tmesh.engine_mesh("cpu") is None


def test_engine_mesh_cut_to_a_divisor(monkeypatch, capsys):
    monkeypatch.setattr(tmesh, "replicas",
                        lambda device: tmesh.frame_mesh(3, device))
    assert len(tmesh.engine_mesh("cpu", 8, "window")) == 2
    assert "frame mesh: 2 of 3 devices (window 8)" in capsys.readouterr().out
    assert tmesh.engine_mesh("cpu", 7, "chunk") is None
    assert len(tmesh.engine_mesh("cpu")) == 3


VDA = dict(size="vitt", input_size=28, window=8, overlap=2, max_depth=10.0,
           metric_anchor_frames=4, fp32=True)


def test_vda_window_over_the_frame_mesh(mesh2):
    frames = frames_of(10)
    ref = (2.0 + 3.0 * np.random.default_rng(1).random((10, 28, 28))
           ).astype(np.float32)
    jeng = jdepth.VDAEngine(data_parallel=True, **VDA)
    assert jeng._mesh is not None and jeng._mesh.devices.size == 8
    jeng._params = init_like(jeng.model, 0, jnp.zeros((8, 28, 28, 3)))
    jeng._anchor_params = init_like(jeng.anchor, 1,
                                    jnp.zeros((1, 28, 28, 3)))
    kw = dict(VDA, device="cpu",
              params=from_jax.flax_to_state_dict(jeng._params),
              anchor_params=from_jax.flax_to_state_dict(jeng._anchor_params))
    sharded = tdepth.VDAEngine(**kw)
    assert sharded._mesh == [torch.device("cpu")] * REPLICAS
    plain = tdepth.VDAEngine(data_parallel=False, **kw)
    assert plain._mesh is None
    got = sharded.infer_video(frames, reference_depth=ref)
    one = plain.infer_video(frames, reference_depth=ref)
    np.testing.assert_allclose(got, one, atol=1e-6 * one.max(), rtol=0)
    # the motion modules gathered the window: without the gather the
    # replicas' windows are half as long and the result moves
    from metric_depth_video_toolbox_tpu_torch.parallel import sharding
    work = (28, 28)
    no_gather = tdepth.VDAEngine(**kw)
    no_gather._replicas[work] = sharding.FrameReplicas(
        no_gather.models(work)[0], no_gather._mesh)
    assert np.abs(no_gather.infer_video(frames, reference_depth=ref)
                  - one).max() > 1e-4
    want = jeng.infer_video(frames, reference_depth=ref)
    assert got.shape == want.shape == (10, 28, 28)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_single_frame_batch_over_the_frame_mesh(mesh2, monkeypatch):
    float32_presets(monkeypatch, jda, tda)
    frames = frames_of(9)
    jeng = jdepth.SingleFrameEngine(size="vitt", max_depth=10.0,
                                    input_size=28, data_parallel=True)
    jeng._params = init_like(jeng.model, 0, jnp.zeros((1, 28, 28, 3)))
    want = jeng.infer_video(frames, batch=8)
    kw = dict(size="vitt", max_depth=10.0, input_size=28, device="cpu",
              params=jax.tree.map(np.asarray, jeng._params))
    sharded = tdepth.SingleFrameEngine(**kw)
    assert len(sharded._mesh) == REPLICAS
    got = sharded.infer_video(frames, batch=3)    # rounded to 2
    one = tdepth.SingleFrameEngine(data_parallel=False, **kw).infer_video(
        frames, batch=8)
    np.testing.assert_allclose(got, one, atol=1e-6 * np.abs(one).max(),
                               rtol=0)
    assert got.shape == want.shape == (9, 28, 28)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def test_mvs_batch_over_the_frame_mesh(mesh2, float32_mvs):  # noqa: F811
    tree = mvs_tree(4)
    kw = dict(size="tiny", window=3, resize_w=32, batch=3, params=tree)
    jeng = jdepth.MVSEngine(data_parallel=True, **kw)
    assert jeng.batch == 8
    frames, c2w = mvs_clip(), poses(5)
    want = jeng.infer_video(frames, c2w, 60.0)
    sharded = tdepth.MVSEngine(device="cpu", **kw)
    assert sharded.batch == 2 and len(sharded._mesh) == REPLICAS
    got = sharded.infer_video(frames, c2w, 60.0)
    one = tdepth.MVSEngine(device="cpu", data_parallel=False,
                           **kw).infer_video(frames, c2w, 60.0)
    np.testing.assert_allclose(got, one, atol=1e-6 * np.abs(one).max(),
                               rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(),
                               rtol=0)


def _chunk(t, seed, h=32, w=32):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (t, h, w, 3)).astype(np.uint8)
    hole = np.zeros((t, h, w), bool)
    hole[:, :, 10:16] = True
    return frames, hole


def test_diffusion_chunk_over_the_frame_mesh(mesh2):
    """DIFFUSION_TINY, chunk 8: the port's mesh against no mesh (the same
    generator draws) and against the JAX engine sharded over 8 devices
    (fed the JAX noise)."""
    t, work = 8, (32, 32)
    frames, hole = _chunk(t, 0)
    f = jnp.zeros((t,) + work + (3,))
    tree = flax_like(jax.eval_shape(lambda: jd.VideoInpainter(
        jd.DIFFUSION_TINY).init(jax.random.PRNGKey(0), f, f[..., 0])), 30)
    je = jid.DiffusionInfillEngine(cfg=jd.DIFFUSION_TINY, params=tree,
                                   work_hw=work, chunk=t, overlap=2,
                                   data_parallel=True, rng_seed=7)
    assert je._mesh is not None
    kw = dict(cfg=td.DIFFUSION_TINY, params=tree, work_hw=work, chunk=t,
              overlap=2, rng_seed=7, device="cpu")
    sharded = tid.DiffusionInfillEngine(**kw)
    assert len(sharded._mesh) == REPLICAS
    got = sharded.infill_chunk(frames, hole)
    one = tid.DiffusionInfillEngine(data_parallel=False, **kw).infill_chunk(
        frames, hole)
    assert_u8_budget(got, one)
    lat = (t, work[0] // 8, work[1] // 8, jd.DIFFUSION_TINY.latent_channels)
    _, sub = jax.random.split(je._rng)
    noise = np.array(jax.random.normal(sub, lat, jnp.float32))
    want = np.asarray(je.infill_chunk(frames, hole))
    got = sharded.infill_chunk(frames, hole, noise=torch.from_numpy(noise))
    assert_u8_budget(got, want)
    np.testing.assert_array_equal(got[~hole], frames[~hole])


def test_svd_chunk_over_the_frame_mesh(mesh2):
    """The SVD graph (SVD_TINY, its temporal VAE decoder): its temporal
    resnet blocks, spatio-temporal transformers and the decoder's time
    convolution gather the chunk; against the same engine without a
    mesh."""
    from metric_depth_video_toolbox_tpu.models import svd as js

    t, work = 6, (32, 48)
    frames, hole = _chunk(t, 1, 40, 72)
    f = jnp.zeros((t,) + work + (3,))
    tree = flax_like(jax.eval_shape(lambda: js.SVDInpainter(
        js.SVD_TINY, js.SVD_VAE_TINY).init(
            jax.random.PRNGKey(0), f, f[..., 0])), 30)
    kw = dict(cfg=ts.SVD_TINY, vae_cfg=ts.SVD_VAE_TINY, params=tree,
              work_hw=work, chunk=t, device="cpu")
    sharded = tid.DiffusionInfillEngine(**kw)
    assert len(sharded._mesh) == REPLICAS
    z = [[], []]
    sharded.on_latents = z[0].append
    got = sharded.infill_chunk(frames, hole)
    plain = tid.DiffusionInfillEngine(data_parallel=False, **kw)
    plain.on_latents = z[1].append
    one = plain.infill_chunk(frames, hole)
    a, b = z[0][0].numpy(), z[1][0].numpy()
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert_u8_budget(got, one)


# --- the movie's threaded step 5 ---------------------------------------------

SCENE, H, W = 6, 32, 48


def _scenes(root, n=2):
    """``n`` scenes of SCENE frames with colour and depth videos and
    convergence files, as steps 1-4 leave them."""
    os.makedirs(root, exist_ok=True)
    scenes = tmovie.plan_scene_files(
        [{"Scene Number": str(i + 1), "Length (frames)": str(SCENE)}
         for i in range(n)], str(root))
    rng = np.random.default_rng(5)
    for i, s in enumerate(scenes):
        tex = np.kron(rng.integers(0, 200, (H // 4, W // 4 + SCENE, 3),
                                   dtype=np.uint8), np.ones((4, 4, 1),
                                                            np.uint8))
        tvio.save_rgb_video(np.stack([tex[:, j:j + W] for j in range(SCENE)]),
                            s["scene_video_file"], 24)
        depth = np.broadcast_to(np.linspace(1.5 + i, 6.0, W, dtype=np.float32),
                                (SCENE, H, W)).copy()
        depth[:, 8:20, 12:30] = 1.0 + i
        tvio.save_depth_video(depth, s["depth_video_file"], 24, 100.0)
        sidecar.save_convergence_depths(s["convergence_file"],
                                        np.full(SCENE, 2.5, np.float32))
    return scenes


def _frames(path):
    return tvio.read_video_frames(path)[0]


def test_step5_threaded_equals_serial(tmp_path):
    pytest.importorskip("cv2")
    serial = _scenes(tmp_path / "serial")
    tmovie.step5_render_sbs(serial, xfov=60.0, batch_size=4, device="cpu")
    threaded = _scenes(tmp_path / "threaded")
    tmovie.step5_render_sbs(threaded, xfov=60.0, batch_size=4, parallel=2,
                            device="cpu")
    for a, b in zip(serial, threaded):
        for key in ("sbs", "sbs_infill"):
            np.testing.assert_array_equal(_frames(a[key]), _frames(b[key]))
        assert tvio.video_info(b["sbs"])[:3] == (SCENE, 2 * W, H)


def test_step5_threaded_failure_after_the_other_scenes(tmp_path):
    pytest.importorskip("cv2")
    scenes = _scenes(tmp_path / "m", n=3)
    os.remove(scenes[1]["depth_video_file"])
    with pytest.raises(RuntimeError, match="^1 scene renders failed"):
        tmovie.step5_render_sbs(scenes, xfov=60.0, batch_size=4, parallel=2,
                                device="cpu")
    assert os.path.exists(scenes[0]["sbs"]) and os.path.exists(
        scenes[2]["sbs"])
    assert not os.path.exists(scenes[1]["sbs"])
