"""Meshes (PyTorch port of ``parallel/mesh.py``).

PyTorch splits what one ``jax.sharding.Mesh`` does in the JAX package into
two objects:

  - :func:`make_mesh`: a ``torch.distributed`` ``DeviceMesh`` with dims
    ("data", "model") over the process group, one process per card (the
    train step's DP x TP layout; ``torchrun --nproc_per_node N``).
  - :func:`frame_mesh`: the list of devices the inference engines of one
    process split a frame batch or a window's time axis over
    (``parallel.sharding.FrameReplicas``).

:func:`replicas` is the frame mesh an engine builds with
``data_parallel=True``: every card for a CUDA device, the engine's own
first, so on one card none. It is the one seam tests patch to get several
replicas on the CPU or on one card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def make_mesh(n_devices=None, data=None, model=1, device=None,
              axis_names=("data", "model")):
    """A 2-D ``DeviceMesh`` (data, model) over the process group.

    Under ``torchrun`` (``WORLD_SIZE`` > 1) it joins the launched group;
    alone it makes a group of one (NCCL on a card, gloo on the CPU), so
    every sharded program also runs on one card. ``data * model`` must be
    the world size; ``data`` defaults to world size // ``model``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if int(os.environ.get("WORLD_SIZE", 1)) > 1:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    world = dist.get_world_size()
    n = n_devices or world
    if data is None:
        data = n // model
    if data * model != n or n != world:
        raise ValueError(f"data({data}) * model({model}) != devices({n}) "
                         f"of a world of {world}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=tuple(axis_names))


def frame_mesh(n_devices=None, device=None):
    """The devices of a 1-D frame mesh: the cards ``cuda:0`` ..
    ``cuda:n-1`` (``n`` defaults to ``torch.cuda.device_count()``), or,
    with ``device``, ``n`` replicas of that one device (default 1)."""
    if device is not None:
        return [torch.device(device)] * (n_devices or 1)
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"a frame mesh of {n} cards on a machine with "
                         f"{count}")
    return [torch.device("cuda", i) for i in range(n)]


def replicas(device):
    """The frame mesh an engine on ``device`` spans with
    ``data_parallel=True``: for a CUDA device every card, the engine's
    own first (its module stays where the caller put it), then the others
    in order; the CPU alone for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return frame_mesh(1, device)
    cards = frame_mesh()
    if len(cards) < 2:
        return cards
    own = device.index if device.index is not None \
        else torch.cuda.current_device()
    return [cards[own]] + cards[:own] + cards[own + 1:]


def engine_mesh(device, divides=None, what="batch"):
    """An engine's frame mesh, or None on one device: :func:`replicas` of
    ``device``, cut to the largest count that divides ``divides`` (the
    window or the chunk) when given; the count used is printed when it was
    cut."""
    devices = replicas(device)
    n = len(devices)
    if divides:
        while divides % n:
            n -= 1
        if n < len(devices):
            print(f"frame mesh: {n} of {len(devices)} devices "
                  f"({what} {divides})")
    return devices[:n] if n > 1 else None


def pad_to_multiple(batch, multiple, axis=0):
    """Pad a frame batch (numpy or torch) with its edge value along
    ``axis`` to a multiple of ``multiple``. -> (padded, original length)."""
    n = batch.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    if torch.is_tensor(batch):
        edge = batch.narrow(axis, n - 1, 1)
        shape = list(batch.shape)
        shape[axis] = rem
        return torch.cat([batch, edge.expand(shape)], dim=axis), n
    pad = [(0, 0)] * batch.ndim
    pad[axis] = (0, rem)
    return np.pad(batch, pad, mode="edge"), n
