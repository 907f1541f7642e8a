"""Layouts: TP over heads and MLP hidden dims, DP over frames (PyTorch
port of ``parallel/sharding.py``).

:func:`param_spec` keeps the JAX package's rules, keyed by substrings of
the parameter's path (the port's names follow the Flax tree): the weights
of ``qkv``, ``fc1``, ``query``, ``key`` and ``value`` Linear layers shard
their output dim over "model" (column-parallel), those of ``proj``,
``fc2`` and ``out`` their input dim (row-parallel); everything else
replicates. A Flax kernel is (in, out) and ``nn.Linear.weight`` (out,
in), so the JAX package's ``P(None, "model")`` is ``Shard(0)`` here.

A fused ``qkv`` is laid out [q | k | v]; a plain split of its rows would
give a rank all of q and part of k. :func:`shard_params` first permutes
the rows so that each rank's block holds the q, k and v of its heads
(``models.vit.Attention`` reads its head count from the block's width);
:func:`gather_params` undoes the permutation.

:class:`FrameReplicas` is the inference engines' frame data parallelism in
one process: a module replicated over a frame mesh
(``parallel.mesh.frame_mesh``), each replica running on its own thread on
its slice of the leading (frame) axis. Modules that mix frames (a
window's motion modules, a UNet's temporal layers) see the whole axis:
each gathers its inputs from every replica before it runs and keeps its
own replica's slice of the result.
"""

from __future__ import annotations

import copy
import threading

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

_COLWISE = ("qkv/", "fc1/", "query/", "key/", "value/")
_ROWWISE = ("proj/", "fc2/", "out/")


def param_spec(name, param):
    """The placement of one parameter over the "model" dim: ``Shard(0)``
    (column-parallel), ``Shard(1)`` (row-parallel) or ``Replicate()``,
    by its dotted name."""
    parts = name.split(".")
    if parts[-1] != "weight" or param.ndim != 2:
        return Replicate()   # biases, norms, embeddings, convolutions
    joined = "/".join(parts)
    if any(t in joined for t in _COLWISE):
        return Shard(0)
    if any(t in joined for t in _ROWWISE):
        return Shard(1)
    return Replicate()


def tp_plan(module):
    """The ``parallelize_module`` plan of a module: ``ColwiseParallel``
    or ``RowwiseParallel`` for each Linear layer :func:`param_spec`
    splits."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel)

    plan = {}
    for name, mod in module.named_modules():
        if isinstance(mod, torch.nn.Linear):
            spec = param_spec(f"{name}.weight", mod.weight)
            if spec == Shard(0):
                plan[name] = ColwiseParallel()
            elif spec == Shard(1):
                plan[name] = RowwiseParallel()
    return plan


def _head_order(heads, hd, ranks):
    """Row order of a fused [q | k | v] weight that gives each of
    ``ranks`` contiguous blocks the q, k and v rows of its heads."""
    d, per = heads * hd, heads // ranks
    return torch.tensor([part * d + h * hd + j
                         for r in range(ranks)
                         for part in range(3)
                         for h in range(r * per, (r + 1) * per)
                         for j in range(hd)])


@torch.no_grad()
def shard_params(mesh, module):
    """Tensor-parallel ``module`` over ``mesh["model"]`` by
    :func:`tp_plan`, in place (fused ``qkv`` rows permuted by heads
    first); returns it."""
    from torch.distributed.tensor.parallel import parallelize_module

    from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod

    tp = mesh["model"]
    m = tp.size()
    if m > 1:
        for mod in module.modules():
            if isinstance(mod, vit_mod.Attention):
                heads = mod.cfg.num_heads
                if heads % m:
                    raise ValueError(f"{heads} heads do not split over "
                                     f"{m} model ranks")
                order = _head_order(heads, mod.cfg.embed_dim // heads,
                                    m).to(mod.qkv.weight.device)
                mod.qkv.weight.copy_(mod.qkv.weight[order])
                if mod.qkv.bias is not None:
                    mod.qkv.bias.copy_(mod.qkv.bias[order])
                mod.qkv.head_order = order
    return parallelize_module(module, tp, tp_plan(module))


@torch.no_grad()
def gather_params(module):
    """``{name: full tensor}`` of a module's parameters, sharded or not:
    DTensors gathered, a fused ``qkv``'s head order undone."""
    out = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            full = p.full_tensor() if isinstance(p, DTensor) else p
            order = getattr(mod, "head_order", None)
            if order is not None:
                full = full[torch.argsort(order).to(full.device)]
            out[f"{mname}.{pname}" if mname else pname] = full.detach()
    return out


def batch_sharding(mesh, ndim=4):
    """The leading-axis (frame) layout over ("data", "model"): ``ndim`` is
    kept for the JAX package's signature."""
    del ndim
    return (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)


def replicated(mesh):
    return (Replicate(),) * mesh.ndim


def shard_batch(mesh, batch):
    """This rank's slice of a batch (a tensor, or a tuple / list / dict of
    them) along its leading axis over ``mesh["data"]``; the axis must
    divide evenly."""
    n = mesh["data"].size()
    rank = mesh.get_local_rank("data")

    def take(x):
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{n} data ranks")
        return x.chunk(n)[rank]
    return _map(take, batch)


def _map(fn, x):
    if x is None:
        return None
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return x


def _gather(parts, device):
    """Per-replica outputs (the same structure each) -> one, concatenated
    along the leading axis on ``device``."""
    first = parts[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, dict):
        return {k: _gather([p[k] for p in parts], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_gather([p[i] for p in parts], device)
                           for i in range(len(first)))
    return first


_local = threading.local()


class _Exchange:
    """The all-gather of the time axis between the replicas' threads."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def gather(self, rank, tensors, dims):
        self.slots[rank] = tensors
        self.barrier.wait()
        dev = next(t.device for t in tensors if t is not None)
        full = tuple(None if t is None else torch.cat(
            [s[i].to(dev) for s in self.slots], dim=d)
            for i, (t, d) in enumerate(zip(tensors, dims)))
        sizes = [s[0].shape[dims[0]] for s in self.slots]
        self.barrier.wait()       # every replica has read every slot
        return full, sum(sizes[:rank]), sizes[rank]


def _pre_hook(dims, module, args):
    ex = getattr(_local, "exchange", None)
    stack = _local.__dict__.setdefault("stack", [])
    if ex is None or stack:      # unsharded, or inside a gathered module
        stack.append(None)
        return None
    full, start, size = ex.gather(_local.rank, args[:len(dims)], dims)
    stack.append((dims[0], start, size))
    return full + tuple(args[len(dims):])


def _post_hook(module, args, out):
    keep = _local.stack.pop()
    if keep is None:
        return None
    dim, start, size = keep
    return out.narrow(dim, start, size)


class FrameReplicas:
    """``module`` replicated over the devices of a frame mesh (the first
    replica is ``module`` itself; a device may repeat). ``temporal``:
    ``{module class: dims}`` of the submodules that mix frames, with the
    frame dim of each of their leading positional inputs (None inputs pass
    through); they see every replica's frames (:class:`_Exchange`)."""

    def __init__(self, module, devices, temporal=None):
        self.devices = [torch.device(d) for d in devices]
        temporal = temporal or {}
        for mod in module.modules():
            dims = temporal.get(type(mod))
            if dims is not None:
                mod.register_forward_pre_hook(
                    lambda m, a, _d=tuple(dims): _pre_hook(_d, m, a))
                mod.register_forward_hook(_post_hook)
        self.modules = [module.to(self.devices[0])] + [
            copy.deepcopy(module).to(d) for d in self.devices[1:]]

    def __len__(self):
        return len(self.devices)

    def __call__(self, fn, *batches):
        """``fn(replica, *slices)`` on each replica's thread, with each of
        ``batches`` (tensors with a common leading axis, or None) split
        along it and moved to the replica's device; the results are
        concatenated along the leading axis on the first batch's device.
        A replica that fails raises here, after the others stopped."""
        home = next(b.device for b in batches if b is not None)
        t = next(b.shape[0] for b in batches if b is not None)
        n = min(len(self.devices), t)
        shards = [[None if b is None else s.to(self.devices[i])
                   for i, s in enumerate(_split(b, n))]
                  for b in batches]
        exchange = _Exchange(n)
        results, errors = [None] * n, [None] * n
        grad = torch.is_grad_enabled()     # a thread starts with its own

        def work(i):
            _local.exchange, _local.rank, _local.stack = exchange, i, []
            try:
                with torch.set_grad_enabled(grad):
                    results[i] = fn(self.modules[i],
                                    *[s[i] for s in shards])
            except BaseException as e:   # noqa: BLE001 - re-raised below
                errors[i] = e
                exchange.barrier.abort()
            finally:
                _local.exchange = None

        threads = [threading.Thread(target=work, args=(i,), daemon=True)
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        failed = [e for e in errors if e is not None]
        if failed:
            first = next((e for e in failed
                          if not isinstance(e, threading.BrokenBarrierError)),
                         failed[0])
            raise RuntimeError(f"a frame replica failed: {first!r}") \
                from first
        return _gather(results, home)


def _split(x, n):
    return [None] * n if x is None else list(torch.tensor_split(x, n))
