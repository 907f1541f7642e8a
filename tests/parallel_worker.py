"""The distributed cases of ``tests/test_torch_parallel.py``, run by each
rank of a 2-process gloo group (``torch.multiprocessing.spawn``). It
imports torch and the port only, so that a rank starts in seconds; rank 0
saves what the test asserts with ``torch.save``.

Each case builds a module from a seed, runs it unsharded, then builds it
again from the same seed and runs it sharded:
  - ``dp``: the train step with the batch over "data" (mesh 2 x 1);
  - ``tp``: the train step tensor-parallel over "model" (mesh 1 x 2);
  - ``vitl``: the forward of the ViT-L layout (embed 1024, 16 heads, depth
    2) tensor-parallel over "model", the check of the fused qkv's split by
    heads.
"""

import dataclasses
import functools

import torch
import torch.distributed as dist

from metric_depth_video_toolbox_tpu_torch.models import depth_anything as da
from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.parallel import mesh as mm
from metric_depth_video_toolbox_tpu_torch.parallel import sharding as shr
from metric_depth_video_toolbox_tpu_torch.parallel import train

LR = 1e-4
# |gradient| below which AdamW's first step (~ lr * sign(g)) may flip
# between two summation orders
NEAR_ZERO = 1e-6


def tiny_config(embed=64, heads=4):
    """The JAX package's dry-run model: ViT (patch 14, depth 2), DPT_TINY,
    relative depth; float32 throughout (the dry run keeps DPT_TINY's
    bfloat16 head)."""
    return da.DepthAnythingConfig(
        vit=vit_mod.ViTConfig(patch_size=14, embed_dim=embed, depth=2,
                              num_heads=heads, out_indices=(0, 1, 1, 1),
                              dtype="float32"),
        dpt=dataclasses.replace(dpt_mod.DPT_TINY, dtype="float32"),
        metric=False)


def seeded(cfg, hw, seed):
    model = da.DepthAnything(cfg, hw)
    vit_mod.seeded_init(model, torch.Generator().manual_seed(seed), 1.0)
    return model


def batch(b=4, hw=(28, 28), seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((b,) + hw + (3,), generator=g),
            1.0 + 5.0 * torch.rand((b,) + hw, generator=g))


def compare_params(got, want, grads):
    """(largest difference where |g| >= NEAR_ZERO, largest elsewhere)."""
    tight = near = 0.0
    for name, w in want.items():
        d = (got[name] - w).abs()
        small = grads[name].abs() < NEAR_ZERO
        tight = max(tight, float(d[~small].max()) if (~small).any() else 0.)
        near = max(near, float(d[small].max()) if small.any() else 0.)
    return tight, near


def run(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {}
        try:
            mm.make_mesh(data=2, model=2, device="cpu")
        except ValueError as e:
            res["bad_mesh"] = str(e)
        cfg, hw = tiny_config(), (28, 28)
        images, depth = batch()
        ref = seeded(cfg, hw, 1)
        loss = train.make_train_step(ref, train.make_optimizer(LR))(
            images, depth)
        want = shr.gather_params(ref)
        grads = {n: p.grad for n, p in ref.named_parameters()}
        steps = {}
        for case, shape in (("dp", (2, 1)), ("tp", (1, 2))):
            mesh = mm.make_mesh(data=shape[0], model=shape[1], device="cpu")
            model = seeded(cfg, hw, 1)
            # the fused (foreach) update, a card's default, in one case
            opt = functools.partial(train.make_optimizer(LR),
                                    foreach=case == "tp")
            step = train.sharded_train_step(mesh, model, opt)
            got = step(images, depth)
            steps[case] = step
            tight, near = compare_params(shr.gather_params(model), want,
                                         grads)
            res[case] = {"mesh": tuple(mesh.shape), "loss": float(got),
                         "layouts": (shr.batch_sharding(mesh),
                                     shr.replicated(mesh)),
                         "loss_unsharded": float(loss), "tight": tight,
                         "near": near,
                         "qkv_split": [tuple(p.to_local().shape) for n, p
                                       in model.named_parameters()
                                       if n.endswith("block0.attn.qkv.weight")
                                       ]}
        try:
            steps["dp"](images[:3], depth[:3])
        except ValueError as e:
            res["odd_batch"] = str(e)
        cfg_l = tiny_config(embed=1024, heads=16)
        hw_l = (84, 84)
        images_l = torch.rand((2,) + hw_l + (3,),
                              generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            model = seeded(cfg_l, hw_l, 2).eval()
            want_l = model(images_l)
            shr.shard_params(mm.make_mesh(data=1, model=2, device="cpu"),
                             model)
            got_l = model(images_l)
        d = (got_l - want_l).abs()
        res["vitl"] = {"mean": float(d.mean()), "max": float(d.max()),
                       "scale": float(want_l.abs().max())}
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()
