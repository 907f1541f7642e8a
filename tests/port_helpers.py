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
