"""Video Depth Anything through the port's ``VDAEngine``: the movie's
``--depth_engine vda``, with its metric anchor, at the widths of the
configuration file."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from counts import flops
from engines import common
from reference import pipelines


class Adapter:
    """Weights on the device from the seed, the port's engine built with
    them at the configuration's widths, and its depth stage."""

    xfov_from_engine = False

    def __init__(self, cfg, seed, device, quantize=None):
        from metric_depth_video_toolbox_tpu_torch.models import \
            depth_anything as da
        from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
        from metric_depth_video_toolbox_tpu_torch.models import \
            video_depth as vd
        from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod

        self.cfg = cfg
        self.quantize = quantize
        e = cfg["engine"]
        # the published head widths, which the engine's size preset lacks,
        # go in through its config fields (``cfg``, ``anchor_cfg``)
        vit = common.vit_config(vit_mod.PRESETS["vitl"], cfg["vit"],
                                cfg["dtype"])
        if quantize:
            vit = dataclasses.replace(vit, quant=quantize)
        self.video_cfg = vd.VideoDepthConfig(
            vit=vit, dpt=dataclasses.replace(
                dpt_mod.DPTConfig(), dtype=cfg["dtype"],
                features=cfg["dpt"]["features"],
                out_channels=tuple(cfg["dpt"]["out_channels"])),
            temporal_heads=cfg["temporal"]["heads"],
            temporal_layers=cfg["temporal"]["layers"],
            norm_groups=cfg["temporal"]["norm_groups"],
            window=e["window"], overlap=e["overlap"])
        a = cfg["anchor"]
        base = da.preset("vitl", metric=True, max_depth=a["max_depth"])
        self.anchor_cfg = dataclasses.replace(
            base, vit=common.vit_config(base.vit, a["vit"], cfg["dtype"]),
            dpt=dataclasses.replace(
                base.dpt, dtype=cfg["dtype"],
                features=a["dpt"]["features"],
                out_channels=tuple(a["dpt"]["out_channels"])))
        self.engine = None
        self.device = device
        self.work_hw = None
        self._vd, self._da = vd, da
        self._seed = seed

    def prepare(self, h, w):
        """Draw the weights for frames of (h, w), build the port's engine
        with them and its models at the configuration's widths."""
        from metric_depth_video_toolbox_tpu_torch.pipeline import depth

        vd, da = self._vd, self._da
        c, e = self.cfg, self.cfg["engine"]
        self.work_hw = da.working_resolution(h, w, e["input_size"],
                                             c["vit"]["patch_size"])
        gen = common.weight_generator(self._seed, self.device)
        video = common.seeded_state(common.meta_state_shapes(
            lambda: vd.VideoDepthAnything(self.video_cfg, self.work_hw)),
            gen, self.device, c["init"]["layerscale"])
        video["head.head_conv3.bias"].fill_(c["init"]["head_bias"])
        video["head.head_conv3.weight"].mul_(c["init"]["head_out_scale"])
        self.state = {"video": video,
                      "anchor": anchor_state(video, common.meta_state_shapes(
                          lambda: da.DepthAnything(self.anchor_cfg,
                                                   self.work_hw)),
                          c["init"])}
        eng = depth.VDAEngine(size="vitl", input_size=e["input_size"],
                              window=e["window"], overlap=e["overlap"],
                              params=self.state["video"],
                              anchor_params=self.state["anchor"],
                              metric_anchor_frames=e["anchor_frames"],
                              max_depth=e["max_depth"],
                              quantize=self.quantize, device=self.device)
        eng.cfg, eng.anchor_cfg = self.video_cfg, self.anchor_cfg
        self.engine = eng
        model, anchor = eng.models(self.work_hw)
        self.check_widths(model, anchor, eng)

    def check_widths(self, model, anchor, eng):
        c = self.cfg
        want = common.vit_shapes("backbone.", c["vit"])
        want.update(common.dpt_shapes("head.", c["dpt"],
                                      c["vit"]["embed_dim"]))
        dims = (c["dpt"]["out_channels"][2], c["dpt"]["out_channels"][3],
                c["dpt"]["features"], c["dpt"]["features"])
        for i, dim in enumerate(dims):
            want[f"head.motion{i}.proj_in.weight"] = (dim, dim)
            want[f"head.motion{i}.block0.geglu.weight"] = (8 * dim, dim)
        common.expect_shapes(model, want)
        common.expect_depth(model, "backbone.", c["vit"]["depth"])
        a = c["anchor"]
        want = common.vit_shapes("backbone.", a["vit"])
        want.update(common.dpt_shapes("head.", a["dpt"],
                                      a["vit"]["embed_dim"]))
        common.expect_shapes(anchor, want)
        common.expect_depth(anchor, "backbone.", a["vit"]["depth"])
        got = (eng.cfg.vit.num_heads, eng.cfg.temporal_heads,
               eng.anchor_cfg.vit.num_heads, eng.cfg.vit.dtype)
        need = (c["vit"]["num_heads"], c["temporal"]["heads"],
                a["vit"]["num_heads"], c["dtype"])
        if got != need:
            raise RuntimeError(f"heads and type {got}, the configuration "
                               f"states {need}")

    def warm_lengths(self, lengths):
        """Shot lengths whose depth stage runs every shape the shots do:
        the window is always full; the anchor runs in chunks of 16 and a
        remainder."""
        n = self.cfg["engine"]["anchor_frames"]
        return sorted({16 + min(t, n) % 16 for t in lengths})

    def depth(self, frames_u8):
        """-> {"depth": (T, H, W) float32 numpy, "xfov": None}"""
        return {"depth": self.engine.infer_video(frames_u8), "xfov": None}

    def scene_flops(self, frames):
        return flops.vda_scene_flops(self.cfg, self.work_hw, frames)

    def release(self):
        """Drop the engine and with it the program's models."""
        self.engine = None

    def reference(self, frames_u8):
        """The plain float32 depth of the same shot from the same weights:
        {"depth": (T, H, W) float32 on the device}."""
        d = pipelines.vda_depth(self.state["video"], self.state["anchor"],
                                np.asarray(frames_u8), self.cfg,
                                self.device)
        return {"depth": d}


def anchor_state(video, shapes, init):
    """The metric anchor's weights: the video model's tensors wherever the
    two models have a tensor of one name and shape (both are fine-tunes of
    one encoder and head), the last convolution negated and both heads'
    outputs lifted by ``head_bias`` past the relu (the video model's last
    convolution already scaled by ``head_out_scale``). So the anchor's depth
    falls where the video model's disparity rises, as the two outputs of a
    trained pair do, and neither output is clipped to zero."""
    state = {}
    for k, s in shapes:
        if k in video and tuple(video[k].shape) == tuple(s):
            state[k] = video[k]
    missing = [k for k, _ in shapes if k not in state]
    if missing:
        raise RuntimeError(f"anchor tensors the video model lacks: "
                           f"{missing[:8]}")
    state["head.head_conv3.weight"] = -video["head.head_conv3.weight"]
    state["head.head_conv3.bias"] = torch.full_like(
        video["head.head_conv3.bias"], init["head_bias"])
    return state


def compare(program, ref, device):
    """The depth's numbers (``depth_numbers``)."""
    return depth_numbers(torch.as_tensor(program["depth"]).to(device),
                         ref["depth"])


def depth_numbers(d, r):
    """``depth_err``: the mean absolute gap over the shot's pixels as a
    share of the reference's mean depth. ``depth_shape_err``: the RMS gap
    of inverse depth left once the program's inverse depth is mapped onto
    the reference's by the best scale and shift, as a share of the
    reference's spread of inverse depth (the per-pixel error, apart from
    the shot's metric fit)."""
    d = d.to(torch.float64)
    r = r.to(torch.float64)
    err = float((d - r).abs().mean() / r.abs().mean())
    x = 1.0 / d.clamp(min=1e-6)
    y = 1.0 / r.clamp(min=1e-6)
    xm, ym = x.mean(), y.mean()
    xc, yc = x - xm, y - ym
    a = (xc * yc).sum() / (xc * xc).sum().clamp(min=1e-30)
    resid = yc - a * xc
    shape = float(resid.pow(2).mean().sqrt() / yc.pow(2).mean().sqrt()
                  .clamp(min=1e-30))
    return {"depth_err": err, "depth_shape_err": shape}
