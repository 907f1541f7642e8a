"""The port's ``parallel/`` mesh, sharding and train step against the JAX
package and against its own unsharded runs.

Tolerances:
- ``param_spec`` splits exactly the Linear layers JAX's splits, with the
  same orientation (Flax's (in, out) kernel is ``nn.Linear``'s (out, in)
  weight: ``P(None, "model")`` is ``Shard(0)``);
- ``ssi_loss`` within 1e-6 relative of JAX's;
- one train step from parameters carried over from a Flax tree, in
  float32: the loss within 1e-5 relative of JAX's; AdamW's first step is
  lr * g / (|g| + eps) ~ lr * sign(g), so an element whose gradient is
  under 1e-6 in magnitude may take a step of the other sign when the sum
  runs in another order: those are held within 2 lr, every other
  parameter within 1e-6;
- the 2-rank gloo DP (mesh 2 x 1) and TP (mesh 1 x 2) steps against the
  port's unsharded step: the loss within 1e-6 relative, the parameters as
  above;
- the ViT-L layout's forward (embed 1024, 16 heads, depth 2) under TP over
  2 ranks against the unsharded forward: mean < 1e-3 and max < 0.05, the
  JAX package's bounds;
- the movie-configuration stereo step split over 2 frame replicas: exact.

The 2-rank cases run once per module (``tests/parallel_worker.py``) with
a deadline, after which the ranks are killed and the cases fail.
"""

import copy
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from metric_depth_video_toolbox_tpu.models import depth_anything as jda
from metric_depth_video_toolbox_tpu.models import dpt as jdpt
from metric_depth_video_toolbox_tpu.models import vit as jvit
from metric_depth_video_toolbox_tpu.parallel import sharding as jshr
from metric_depth_video_toolbox_tpu.parallel import train as jtrain
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import vit as tvit
from metric_depth_video_toolbox_tpu_torch.parallel import mesh as tmesh
from metric_depth_video_toolbox_tpu_torch.parallel import sharding as tshr
from metric_depth_video_toolbox_tpu_torch.parallel import train as ttrain
from port_helpers import _one_torch_thread, init_like  # noqa: F401

import parallel_worker as worker

DEADLINE_S = 240


# --- param_spec ----------------------------------------------------------

def _jax_tiny_da():
    return jda.DepthAnything(jda.DepthAnythingConfig(
        vit=jvit.ViTConfig(patch_size=14, embed_dim=64, depth=2, num_heads=4,
                           out_indices=(0, 1, 1, 1), dtype="float32"),
        dpt=dataclasses.replace(jdpt.DPT_TINY, dtype="float32"),
        metric=False))


def _jax_splits(tree):
    """{"colwise" | "rowwise": {module path}} of JAX's param_spec."""
    out = {"colwise": set(), "rowwise": set()}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = jshr.param_spec(path, leaf)
        names = [str(getattr(k, "key", k)) for k in path]
        if names[0] == "params":
            names = names[1:]
        if spec == P(None, "model"):
            out["colwise"].add(".".join(names[:-1]))
        elif spec == P("model", None):
            out["rowwise"].add(".".join(names[:-1]))
        else:
            assert spec == P(), (names, spec)
    return out


def _port_splits(module):
    out = {"colwise": set(), "rowwise": set()}
    for name, p in module.named_parameters():
        spec = tshr.param_spec(name, p)
        if spec == tshr.Shard(0):
            out["colwise"].add(name.rsplit(".", 1)[0])
        elif spec == tshr.Shard(1):
            out["rowwise"].add(name.rsplit(".", 1)[0])
    return out


@pytest.mark.parametrize("kind", ["vit_tiny", "depth_anything_tiny"])
def test_param_spec_splits_the_jax_names(kind):
    x = jnp.zeros((1, 28, 28, 3))
    if kind == "vit_tiny":
        jm, tm = jvit.ViT(jvit.VIT_TINY), tvit.ViT(tvit.VIT_TINY, 4)
    else:
        jm, tm = _jax_tiny_da(), worker.seeded(worker.tiny_config(),
                                               (28, 28), 0)
    tree = init_like(jm, 0, x)
    from_jax.load_params(tm, tree)          # the same names in both
    want, got = _jax_splits(tree), _port_splits(tm)
    assert got == want
    prefix = "" if kind == "vit_tiny" else "backbone."
    assert want == {
        "colwise": {f"{prefix}block{i}.{m}" for i in range(len(
            [k for k in got["colwise"] if k.endswith("qkv")]))
            for m in ("attn.qkv", "mlp.fc1")},
        "rowwise": {f"{prefix}block{i}.{m}" for i in range(len(
            [k for k in got["rowwise"] if k.endswith("proj")]))
            for m in ("attn.proj", "mlp.fc2")}}
    assert len(want["colwise"]) == 2 * (4 if kind == "vit_tiny" else 2)


def test_frame_mesh_and_pad_to_multiple():
    assert tmesh.frame_mesh(3, "cpu") == [torch.device("cpu")] * 3
    x = np.arange(5 * 2).reshape(5, 2)
    padded, n = tmesh.pad_to_multiple(x, 4)
    assert n == 5 and padded.shape == (8, 2)
    np.testing.assert_array_equal(padded[5:], np.repeat(x[-1:], 3, 0))
    t, n = tmesh.pad_to_multiple(torch.from_numpy(x), 4, axis=0)
    np.testing.assert_array_equal(t.numpy(), padded)
    assert tmesh.pad_to_multiple(x, 5)[0] is x


@pytest.mark.parametrize("count,device,current,want", [
    (2, "cuda:0", 0, [0, 1]), (2, "cuda:1", 0, [1, 0]),
    (3, "cuda:2", 0, [2, 0, 1]), (2, "cuda", 1, [1, 0])])
def test_replicas_start_on_the_engines_card(monkeypatch, count, device,
                                            current, want):
    """An engine's frame mesh starts with the engine's own card (the
    current card for a bare "cuda"), then the others in order: FrameReplicas
    keeps the engine's module on the mesh's first device, so on a machine
    of several cards the model stays where the caller put it."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    cards = [torch.device("cuda", i) for i in want]
    assert tmesh.replicas(device) == cards
    assert tmesh.engine_mesh(device) == cards
    assert tmesh.engine_mesh(device, divides=2) == cards[:2]


# --- the loss and the train step against JAX -------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_ssi_loss_matches_jax(masked):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.1, 2.0, (3, 16, 20)).astype(np.float32)
    depth = rng.uniform(0.5, 9.0, (3, 16, 20)).astype(np.float32)
    valid = ((rng.random((3, 16, 20)) > 0.3).astype(np.float32)
             if masked else None)
    want = float(jtrain.ssi_loss(jnp.asarray(pred), jnp.asarray(depth),
                                 None if valid is None else jnp.asarray(
                                     valid)))
    got = float(ttrain.ssi_loss(torch.from_numpy(pred),
                                torch.from_numpy(depth),
                                None if valid is None else torch.from_numpy(
                                    valid)))
    assert got == pytest.approx(want, rel=1e-6)


def test_train_step_matches_jax():
    """One jitted JAX step; the gradients that classify AdamW's near-zero
    elements are the port's, in the Flax layout."""
    model = _jax_tiny_da()
    images, depth = (t.numpy() for t in worker.batch())
    params = init_like(model, 5, jnp.asarray(images))
    opt = jtrain.make_optimizer(worker.LR)
    step = jax.jit(jtrain.make_train_step(lambda p, x: model.apply(p, x),
                                          opt))
    want_p, _, want_loss = step(params, opt.init(params), jnp.asarray(images),
                                jnp.asarray(depth))
    tm = worker.seeded(worker.tiny_config(), (28, 28), 0)
    from_jax.load_params(tm, params)
    loss = ttrain.make_train_step(tm, ttrain.make_optimizer(worker.LR))(
        torch.from_numpy(images), torch.from_numpy(depth))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    got = from_jax.to_flax_params(tm)
    grads = copy.deepcopy(tm)
    for g, p in zip(grads.parameters(), tm.parameters()):
        g.data = p.grad
    grads = from_jax.to_flax_params(grads)
    want_p = want_p.get("params", want_p)
    for path, w in jax.tree_util.tree_flatten_with_path(want_p)[0]:
        node, g = got, grads
        for k in path:
            node, g = node[k.key], g[k.key]
        d = np.abs(node - np.asarray(w))
        near = np.abs(g) < worker.NEAR_ZERO
        assert d[~near].max(initial=0) <= 1e-6, path
        assert d[near].max(initial=0) <= 2 * worker.LR, path
    # the step moved the parameters by about lr
    assert np.abs(got["backbone"]["block0"]["attn"]["qkv"]["kernel"]
                  - np.asarray(params["params"]["backbone"]["block0"]["attn"]
                               ["qkv"]["kernel"])).max() > 0.5 * worker.LR


# --- 2 gloo ranks -------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    out = tmp / "result.pt"
    ctx = mp.spawn(worker.run, args=(2, str(tmp / "store"), str(out)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the 2 gloo ranks ran past {DEADLINE_S}"
                                   f" s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return torch.load(out)


def test_make_mesh_shapes(two_ranks):
    assert two_ranks["dp"]["mesh"] == (2, 1)
    assert two_ranks["tp"]["mesh"] == (1, 2)
    assert "data(2) * model(2) != devices(2)" in two_ranks["bad_mesh"]
    assert "does not split over 2 data ranks" in two_ranks["odd_batch"]
    for case in ("dp", "tp"):
        assert two_ranks[case]["layouts"] == (
            (tshr.Shard(0), tshr.Replicate()),
            (tshr.Replicate(), tshr.Replicate()))


@pytest.mark.parametrize("case", ["dp", "tp"])
def test_sharded_step_equals_unsharded(two_ranks, case):
    r = two_ranks[case]
    assert r["loss"] == pytest.approx(r["loss_unsharded"], rel=1e-6)
    assert r["tight"] <= 1e-6
    assert r["near"] <= 2 * worker.LR
    # the fused qkv (3 x 64 rows) is split over "model" by heads
    assert r["qkv_split"] == [(192 // (2 if case == "tp" else 1), 64)]


def test_vitl_layout_tensor_parallel_forward(two_ranks):
    r = two_ranks["vitl"]
    assert r["scale"] > 0
    assert r["mean"] < 1e-3 and r["max"] < 0.05, r


# --- the stereo step over frame replicas --------------------------------------

class _StereoStep(torch.nn.Module):
    def __init__(self, cfg, k):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("k", k)

    def forward(self, rgb, color, conv, scale):
        from metric_depth_video_toolbox_tpu_torch.pipeline import stereo
        b = rgb.shape[0]
        k = self.k.expand(b, 3, 3)
        return stereo.stereo_frame(rgb, color, k, k,
                                   torch.eye(4).expand(b, 4, 4), conv, scale,
                                   self.cfg)


def test_stereo_batch_over_frame_replicas():
    """The movie configuration (sweep warp, edge anchors, infill mask) on
    8 frames of 48 x 64: split over 2 replicas, exactly the unsharded
    step (the JAX package's shard_map dry run)."""
    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    hh, ww, n = 48, 64, 8
    cfg = stereo.StereoConfig(width=ww, height=hh, out_width=ww,
                              out_height=hh, max_depth=100.0,
                              remove_edges=True, place_edge_points=True,
                              make_infill_mask=True, warp_method="sweep",
                              num_planes=16, has_convergence=True)
    rng = np.random.default_rng(0)
    depth = np.full((n, hh, ww), 8.0, np.float32)
    depth[:, 16:32, 24:40] = 3.0
    depth *= 1.0 + 0.01 * rng.standard_normal(depth.shape).astype(np.float32)
    rgb = codec.encode_depth_frame(torch.from_numpy(depth), 100.0)
    color = torch.from_numpy(rng.integers(0, 255, (n, hh, ww, 3)).astype(
        np.uint8))
    conv, scale = torch.full((n,), 4.0), torch.ones(n)
    step = _StereoStep(cfg, torch.as_tensor(np.asarray(
        geo.camera_matrix_from_fov(ww, hh, xfov_deg=60.0), np.float32)))
    with torch.no_grad():
        want = step(rgb, color, conv, scale)
        got = tshr.FrameReplicas(step, tmesh.frame_mesh(2, "cpu"))(
            lambda m, *b: m(*b), rgb, color, conv, scale)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
