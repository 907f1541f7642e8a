"""Helpers shared by the port's test modules (``tests/test_torch_*.py``).

- ``_one_torch_thread``: a module-scoped autouse fixture; a module that
  imports it runs PyTorch on one intra-op thread. Its tensors are small,
  and in the parallel test run the spinning thread pools of several
  processes on the same cores slow its work several times over.
- ``perturbed_like``: numpy values for a Flax parameter tree of shapes
  (``jax.eval_shape`` of a model's ``init``), drawn like Flax's
  initializers by leaf name and then perturbed, so that biases and norms
  are not at their trivial values. It stands in for a jitted ``init``,
  which costs 10-20 s of compilation per model on the CPU.
- ``float32_presets``, ``upstream_style_point_maps``: the single-frame
  engines of both packages in float32, and their point heads' output
  mapped onto upstream-style point maps (for a clear focal solve).
"""

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# leaves that Flax initializes to ones, to zeros, and by LeCun-normal
# (every other leaf, e.g. position embeddings, class tokens, Wan's
# modulations: N(0, 0.02))
_ONES = ("scale", "var", "gamma")
_ZEROS = ("bias", "mean")


def perturbed_like(tree, seed, noise=0.05):
    """Flax-init-like values for a tree of shapes, + ``noise`` * N(0, 1) on
    every leaf; float32 numpy leaves (jnp arrays are not needed: Flax
    ``apply`` and ``models.from_jax`` both take numpy)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) or 1
            base = rng.normal(0.0, fan_in ** -0.5, shape)
        elif name in _ONES:
            base = np.ones(shape)
        elif name in _ZEROS:
            base = np.zeros(shape)
        else:
            base = rng.normal(0.0, 0.02, shape)
        return (base + noise * rng.standard_normal(shape)).astype(
            np.dtype(leaf.dtype))
    return jax.tree_util.tree_map_with_path(draw, tree)


def init_like(model, seed, *inputs, **kwargs):
    """``perturbed_like`` of ``model.init(PRNGKey(seed), *inputs)``'s
    shapes."""
    return perturbed_like(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(seed), *inputs, **kwargs)),
        seed)


def float32_presets(monkeypatch, *modules):
    """``depth_anything.preset`` of each module returns its configuration
    in float32 (ViT and DPT head), so that engines that build their model
    from a preset compare in float32."""
    import dataclasses

    for mod in modules:
        def preset(*a, _orig=mod.preset, **kw):
            c = _orig(*a, **kw)
            return dataclasses.replace(
                c, vit=dataclasses.replace(c.vit, dtype="float32"),
                dpt=dataclasses.replace(c.dpt, dtype="float32"))
        monkeypatch.setattr(mod, "preset", preset)


# the pinhole that upstream-style point maps come from: normalized focal
# and z offset (ops/geometry.py's normalized_uv convention)
UPSTREAM_FOCAL, UPSTREAM_SHIFT = 1.2, 1.0


def upstream_points_jax(pts, mlogit):
    """A raw point map (B, H, W, 3) -> one like an upstream model's: a
    pinhole's (x, y, z) over depths of 2-3.5 taken from the raw z, with
    the raw x, y as 1 cm noise, z offset by -UPSTREAM_SHIFT. With random
    weights a raw map reprojects onto nothing, the focal and shift solve
    has no clear minimum, and float32 rounding picks between near-equal
    candidates; on these maps it has one."""
    import jax.numpy as jnp

    from metric_depth_video_toolbox_tpu.ops import geometry as geo

    uv = geo.normalized_uv(pts.shape[-3], pts.shape[-2])
    z = 2.0 + 1.5 * jax.nn.sigmoid(pts[..., 2])
    x = uv[..., 0] * z / UPSTREAM_FOCAL + 0.01 * jnp.tanh(pts[..., 0])
    y = uv[..., 1] * z / UPSTREAM_FOCAL + 0.01 * jnp.tanh(pts[..., 1])
    return jnp.stack([x, y, z - UPSTREAM_SHIFT], -1), mlogit


def upstream_points_torch(pts, mlogit):
    """:func:`upstream_points_jax` in PyTorch."""
    from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo

    uv = geo.normalized_uv(pts.shape[-3], pts.shape[-2], device=pts.device)
    z = 2.0 + 1.5 * torch.sigmoid(pts[..., 2])
    x = uv[..., 0] * z / UPSTREAM_FOCAL + 0.01 * torch.tanh(pts[..., 0])
    y = uv[..., 1] * z / UPSTREAM_FOCAL + 0.01 * torch.tanh(pts[..., 1])
    return torch.stack([x, y, z - UPSTREAM_SHIFT], -1), mlogit


class _UpstreamStyle(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, *args):
        return upstream_points_torch(*self.inner(*args))


def upstream_style_point_maps(monkeypatch, jdepth, tdepth):
    """Both packages' single-frame engines with a point head (MoGe, UniK3D
    and their stand-ins) see their model's output through
    :func:`upstream_points_jax` / :func:`upstream_points_torch`."""
    jinit = jdepth.SingleFrameEngine.__init__

    def init(self, *a, **kw):
        jinit(self, *a, **kw)
        if self.cfg.point_head:
            apply = self._apply
            self._apply = lambda params, *args: upstream_points_jax(
                *apply(params, *args))
    monkeypatch.setattr(jdepth.SingleFrameEngine, "__init__", init)

    tmodel = tdepth.SingleFrameEngine.model

    def model(self, work_hw):
        m = tmodel(self, work_hw)
        if self.cfg.point_head and not isinstance(m, _UpstreamStyle):
            m = self._models[tuple(work_hw)] = _UpstreamStyle(m)
        return m
    monkeypatch.setattr(tdepth.SingleFrameEngine, "model", model)
