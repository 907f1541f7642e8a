"""The depth models' train step, DP x TP over a mesh (PyTorch port of
``parallel/train.py``).

The loss is the scale-shift-invariant disparity loss with gradient
matching. :func:`sharded_train_step` shards the parameters over "model" by
``parallel.sharding.shard_params`` (TP) and the batch over "data" (DP),
and averages the gradients over "data" before the update; it runs on
autograd through the plain modules and SDPA (no kernel of the port has a
backward, as none of the JAX package's has).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from metric_depth_video_toolbox_tpu_torch.parallel import sharding as shr


def ssi_loss(pred_disp, target_depth, valid=None, grad_weight=0.5):
    """Scale-shift-invariant disparity loss with gradient matching:
    prediction and target disparity each normalised per image (weighted
    mean and mean absolute deviation over the last two axes), their mean
    absolute difference, plus ``grad_weight`` times the mean absolute
    finite differences of that difference."""
    target_disp = 1.0 / torch.clamp(target_depth, min=1e-3)
    w = (torch.ones_like(target_disp) if valid is None
         else valid.to(target_disp.dtype))
    wsum = w.sum(dim=(-2, -1), keepdim=True) + 1e-6

    def norm(d):
        mu = (d * w).sum(dim=(-2, -1), keepdim=True) / wsum
        s = ((d - mu).abs() * w).sum(dim=(-2, -1), keepdim=True) / wsum
        return (d - mu) / (s + 1e-6)

    diff = norm(pred_disp) - norm(target_disp)
    data_term = (diff.abs() * w).sum() / (w.sum() + 1e-6)
    grads = (diff.diff(dim=-1).abs().mean()
             + diff.diff(dim=-2).abs().mean())
    return data_term + grad_weight * grads


def make_optimizer(lr=1e-4, weight_decay=0.01):
    """optax ``adamw``'s defaults as ``torch.optim.AdamW`` (betas 0.9 /
    0.999, eps 1e-8, decoupled decay on every parameter): a callable of
    the parameters, as optax's transformation is not yet bound to them."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def make_train_step(model, optimizer):
    """-> ``step(images, depth)``: one update of ``model`` (the optimizer
    made by ``optimizer(model.parameters())``) on the SSI loss of
    ``model(images)`` against ``depth``; returns the loss, detached."""
    opt = optimizer(model.parameters())

    def step(images, depth):
        opt.zero_grad(set_to_none=True)
        loss = ssi_loss(model(images), depth)
        loss.backward()
        opt.step()
        return loss.detach()

    step.optimizer = opt
    return step


def sharded_train_step(mesh, model, optimizer):
    """-> ``step(images, depth)`` over a ("data", "model") ``DeviceMesh``:
    ``model`` tensor-parallel over "model" (in place), each data rank's
    slice of the global batch (which must divide evenly: padding would
    change the loss), the gradients averaged over "data". The optimizer's
    state follows the parameters' layout. Returns the global batch's loss
    (the mean of the data ranks' losses), detached."""
    shr.shard_params(mesh, model)
    # one parameter group per kind: the fused (foreach) update, the
    # default on a card, takes no mix of DTensors and tensors
    params = list(model.parameters())
    groups = [[p for p in params if isinstance(p, DTensor)],
              [p for p in params if not isinstance(p, DTensor)]]
    opt = optimizer([{"params": g} for g in groups if g])
    dp = mesh["data"]
    n = dp.size()

    def step(images, depth):
        x, y = shr.shard_batch(mesh, (images, depth))
        opt.zero_grad(set_to_none=True)
        loss = ssi_loss(model(x), y)
        loss.backward()
        loss = loss.detach().clone()
        if n > 1:
            group = dp.get_group()
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is None:
                        continue
                    g = (p.grad.to_local() if isinstance(p.grad, DTensor)
                         else p.grad)
                    dist.all_reduce(g, group=group)
                    g.div_(n)
            dist.all_reduce(loss, group=group)
            loss /= n
        opt.step()
        return loss

    step.optimizer = opt
    return step
