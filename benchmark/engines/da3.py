"""DA3 through the port's ``DA3PipelineEngine`` (``models/da3.py``
``DA3Engine``): the upstream toolbox's default depth engine for the
movie, at the widths of the configuration file. Depth, cameras and a
per-frame FOV, which the stereo stage takes."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from counts import flops
from engines import common
from engines import vda
from reference import pipelines


class Adapter:
    xfov_from_engine = True

    def __init__(self, cfg, seed, device, quantize=None):
        from metric_depth_video_toolbox_tpu_torch.models import da3
        from metric_depth_video_toolbox_tpu_torch.pipeline import depth

        self.cfg = cfg
        e = cfg["engine"]
        base = da3.DA3_L
        vit = common.vit_config(base.vit, cfg["vit"], cfg["dtype"])
        self.model_cfg = dataclasses.replace(
            base, max_depth=e["max_depth"],
            vit=dataclasses.replace(vit, attention_impl=e["attention"]),
            dpt=dataclasses.replace(
                base.dpt, dtype=cfg["dtype"],
                features=cfg["dpt"]["features"],
                out_channels=tuple(cfg["dpt"]["out_channels"])))
        self._kw = dict(cfg=self.model_cfg, quantize=quantize,
                        images_per_batch=e["images_per_batch"],
                        overlap=e["overlap"],
                        num_ref_frames=e["num_ref_frames"],
                        resolution=e["resolution"], device=device)
        self._da3 = da3
        self._depth = depth
        self.device = device
        self._seed = seed
        self.work_hw = None
        self.engine = None

    def prepare(self, h, w):
        da3 = self._da3
        from metric_depth_video_toolbox_tpu_torch.models import \
            depth_anything as da
        c = self.cfg
        self.work_hw = da.working_resolution(
            h, w, c["engine"]["resolution"], c["vit"]["patch_size"])
        gen = common.weight_generator(self._seed, self.device)
        self.state = common.seeded_state(common.meta_state_shapes(
            lambda: da3.DA3(self.model_cfg, self.work_hw)), gen, self.device,
            c["init"]["layerscale"])
        init = c["init"]
        self.state["head.depth.head_conv3.bias"].fill_(init["head_bias"])
        self.state["head.depth.head_conv3.weight"].mul_(
            init["head_out_scale"])
        self.state["head.ray.head_conv3.bias"].copy_(torch.tensor(
            init["ray_bias"], dtype=torch.float32))
        pipe = self._depth.DA3PipelineEngine(params=self.state, **self._kw)
        self.engine = pipe.engine
        model = self.engine.model(self.work_hw)
        want = common.vit_shapes("backbone.", c["vit"])
        want.update(common.dpt_shapes("head.depth.", c["dpt"],
                                      c["vit"]["embed_dim"]))
        want.update(common.dpt_shapes("head.ray.", c["dpt"],
                                      c["vit"]["embed_dim"], n_out=6))
        common.expect_shapes(model, want)
        common.expect_depth(model, "backbone.", c["vit"]["depth"])
        v = self.engine.cfg.vit
        got = (v.num_heads, tuple(v.cross_view_indices), v.dtype,
               v.attention_impl)
        need = (c["vit"]["num_heads"], tuple(c["vit"]["cross_view_indices"]),
                c["dtype"], c["engine"]["attention"])
        if got != need:
            raise RuntimeError(f"heads, cross-view blocks, type and "
                               f"attention {got}, the configuration states "
                               f"{need}")

    def warm_lengths(self, lengths):
        """Shot lengths whose windows have every view count the shots'
        have: a short shot is one window of its own length, a longer one
        windows of the full count."""
        ipb = self.cfg["engine"]["images_per_batch"]
        return sorted({t if t <= ipb else ipb + 1 for t in lengths})

    def depth(self, frames_u8):
        d, c2w, xfov = self.engine.infer_video(frames_u8)
        return {"depth": d, "c2w": c2w, "xfov": xfov}

    def scene_flops(self, frames):
        return flops.da3_scene_flops(self.cfg, self.work_hw, frames)

    def release(self):
        """Drop the engine and with it the program's model."""
        self.engine = None

    def reference(self, frames_u8):
        d, c2w, xfov = pipelines.da3_depth(self.state, np.asarray(frames_u8),
                                           self.cfg, self.device)
        return {"depth": d, "c2w": c2w, "xfov": xfov}


def _angle_deg(r):
    """Rotation angles (N,) of (N, 3, 3) rotations, in degrees."""
    tr = np.clip((np.trace(r, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def compare(program, ref, device):
    """The depth's numbers (``vda.depth_numbers``), the largest FOV gap in degrees,
    the largest gap of camera orientation in degrees and of camera centre
    as a share of the reference trajectory's extent (at least 1 m)."""
    out = vda.depth_numbers(torch.as_tensor(program["depth"]).to(device),
                            ref["depth"])
    pc = np.asarray(program["c2w"], np.float64)
    rc = np.asarray(ref["c2w"], np.float64)
    rot = np.einsum("nji,njk->nik", rc[:, :3, :3], pc[:, :3, :3])
    extent = max(float(np.ptp(rc[:, :3, 3], axis=0).max()), 1.0)
    return {**out,
            "xfov_gap_deg": float(np.abs(np.asarray(program["xfov"])
                                         - ref["xfov"]).max()),
            "rot_gap_deg": float(_angle_deg(rot).max()),
            "centre_gap": float(np.linalg.norm(pc[:, :3, 3] - rc[:, :3, 3],
                                               axis=1).max() / extent)}
