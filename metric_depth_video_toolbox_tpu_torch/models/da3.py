"""DA3-class multi-view depth + pose estimation (PyTorch port of
``models/da3.py``).

- Cross-view self-attention: a plain DINOv2 ViT whose odd blocks attend
  over the concatenated tokens of all views of the window (no new
  parameters; ``models.vit`` ``cross_view_indices`` + ``view_group``).
- Dual-DPT head: metric depth (1 channel, relu) and a per-pixel ray map
  (6 channels: world-frame ray origin + direction).
- Cameras solved from the ray map in closed form
  (:func:`cameras_from_raymap`), not a learned pose head.

:class:`DA3Engine` runs a whole video in windows: windows of N frames plus a
few reference frames spanning the clip and the previous window's tail,
stitched by a least-squares depth scale on the shared frames, an Umeyama
similarity over the shared camera centers and a last-frame weld.
Outputs per clip: metric depth (T, H, W), camera-to-world transforms
(T, 4, 4), xfovs (T,).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from metric_depth_video_toolbox_tpu_torch.models import depth_anything as da
from metric_depth_video_toolbox_tpu_torch.models import dpt as dpt_mod
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
from metric_depth_video_toolbox_tpu_torch.ops import solvers
from metric_depth_video_toolbox_tpu_torch.ops.image import resize_nchw
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def _cv_vit(base):
    """The DA3 backbone: the plain ViT with cross-view attention in every
    odd block."""
    return dataclasses.replace(
        base, cross_view_indices=tuple(range(1, base.depth, 2)))


@dataclasses.dataclass(frozen=True)
class DA3Config:
    vit: vit_mod.ViTConfig = _cv_vit(vit_mod.VIT_L)
    dpt: dpt_mod.DPTConfig = dpt_mod.DPTConfig()
    ray_head: bool = True
    max_depth: float = 100.0


DA3_TINY = DA3Config(vit=_cv_vit(vit_mod.VIT_TINY), dpt=dpt_mod.DPT_TINY)
DA3_S = DA3Config(vit=_cv_vit(vit_mod.VIT_S), dpt=dpt_mod.DPTConfig())
DA3_L = DA3Config()   # the default: ViT-L, odd blocks cross-view
DA3_G = DA3Config(vit=_cv_vit(vit_mod.VIT_G))

PRESETS = {"vitt": DA3_TINY, "vits": DA3_S, "vitb": DA3_S,
           "vitl": DA3_L, "vitg": DA3_G}


def preset(name):
    return PRESETS.get(name, DA3_L)


class DualDPT(nn.Module):
    """Two DPT decodes over the shared backbone features: depth (1
    channel, relu) and, with ``cfg.ray_head``, the ray map (6 raw
    channels)."""

    def __init__(self, cfg: DA3Config):
        super().__init__()
        d, p = cfg.vit.embed_dim, cfg.vit.patch_size
        self.depth = dpt_mod.DPTHead(cfg.dpt, d, p)
        if cfg.ray_head:
            ray_cfg = dataclasses.replace(cfg.dpt, head_act="none", n_out=6)
            self.ray = dpt_mod.DPTHead(ray_cfg, d, p)

    def forward(self, feats):
        out = {"depth": self.depth(feats)[..., 0]}
        if hasattr(self, "ray"):
            out["rays"] = self.ray(feats)
        return out


def cameras_from_raymap(rays, img_w, min_focal_frac=0.1):
    """Closed-form cameras from a predicted ray map.

    rays: (V, h, w, 6) world-frame ray origins + directions on any regular
    pixel grid; img_w: the full image width in pixels, so that the focal
    converts to the x-FOV of the actual image. Per view: center = mean
    origin; focal = argmin_f sum r (r - f tan(theta))^2 with theta the
    angle between a ray and the mean direction and r the pixel radius;
    rotation = rotation-only Procrustes from the canonical camera rays at
    that focal to the predicted rays. Returns (w2c (V, 4, 4), xfov_deg
    (V,)), float32."""
    v, h, w, _ = rays.shape
    dev = rays.device
    o = rays[..., :3].reshape(v, h * w, 3).to(torch.float32)
    d = rays[..., 3:6].reshape(v, h * w, 3).to(torch.float32)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-6)
    center = torch.mean(o, dim=1)

    z = torch.mean(d, dim=1)
    z = z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                        min=1e-6)

    # pixel offsets about the image center, in full-image pixel units
    sx = img_w / w
    uu = (torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2) * sx
    vv = (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2) * sx
    du = uu[None, :].expand(h, w).reshape(-1)
    dv = vv[:, None].expand(h, w).reshape(-1)
    r = torch.sqrt(du * du + dv * dv)

    cos = torch.clamp(torch.einsum("vnc,vc->vn", d, z), -1.0, 1.0)
    tan = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0)) \
        / torch.clamp(cos, min=1e-3)
    f = (torch.sum(r * r[None] * tan, dim=1)
         / torch.clamp(torch.sum(r * tan * tan, dim=1), min=1e-6))
    f = torch.clamp(f, min=min_focal_frac * img_w)

    # canonical camera rays at that focal (+z forward, y down, x right)
    g = torch.stack([du[None].expand(v, -1) / f[:, None],
                     dv[None].expand(v, -1) / f[:, None],
                     torch.ones((v, h * w), dtype=torch.float32, device=dev)],
                    dim=-1)
    g = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    r_w2c = solvers.rigid_transform(g, d, zero_centroid=True)[
        :, :3, :3].transpose(1, 2)

    w2c = torch.eye(4, dtype=torch.float32, device=dev).repeat(v, 1, 1)
    w2c[:, :3, :3] = r_w2c
    w2c[:, :3, 3] = -torch.einsum("vij,vj->vi", r_w2c, center)
    xfov = 2.0 * torch.rad2deg(torch.atan2(
        torch.full_like(f, img_w / 2.0), f))
    return w2c, xfov


class DA3(nn.Module):
    """frames (V, H, W, 3) in [0, 1] at ``work_hw`` -> dict with depth
    (V, H, W), w2c (V, 4, 4), xfov_deg (V,), and rays (V, H, W, 6) when
    ``cfg.ray_head``; all float32.

    ``cam_rays``: optional (V, gh, gw, 3) unit camera-ray directions at
    patch centers (known intrinsics), embedded into the patch tokens before
    the backbone so that the cross-view attention sees them. The embedding
    layer exists only in a model built with ``ray_cond=True``."""

    def __init__(self, cfg: DA3Config, work_hw, ray_cond=False):
        super().__init__()
        self.cfg = cfg
        p = cfg.vit.patch_size
        if ray_cond:
            self.ray_embed = vit_mod.Dense(3, cfg.vit.embed_dim,
                                           cfg.vit.compute_dtype)
        self.backbone = vit_mod.ViT(cfg.vit,
                                    (work_hw[0] // p) * (work_hw[1] // p))
        self.head = DualDPT(cfg)

    def forward(self, frames, cam_rays=None):
        c = self.cfg
        v = frames.shape[0]
        cond = None
        if cam_rays is not None:
            cond = self.ray_embed(cam_rays.to(c.vit.compute_dtype))
        feats, _ = self.backbone(frames, cond=cond, view_group=v)
        heads = self.head(feats)
        out = {"depth": torch.clamp(heads["depth"].to(torch.float32), 0.0,
                                    c.max_depth)}
        if c.ray_head:
            rays = heads["rays"].to(torch.float32)
            out["rays"] = rays
            # the solve does not depend on the grid: pool to the patch grid
            p = c.vit.patch_size
            gh, gw = rays.shape[1] // p, rays.shape[2] // p
            pooled = rays.reshape(v, gh, p, gw, p, 6).mean(dim=(2, 4))
            out["w2c"], out["xfov_deg"] = cameras_from_raymap(
                pooled, float(rays.shape[2]))
        else:
            out["w2c"] = torch.eye(4, device=frames.device).repeat(v, 1, 1)
            out["xfov_deg"] = torch.full((v,), 50.0, device=frames.device)
        return out


class DA3Engine:
    """Runs a video in windows with overlap stitching.

    ``cfg``: a :class:`DA3Config` (default DA3_L); its ``vit.attention_impl``
    chooses the attention route. ``params``: a state dict of :class:`DA3`
    at the clip's working resolution (e.g. ``from_jax.flax_to_state_dict``
    of the JAX package's tree); None draws seeded weights (``rng_seed``).
    ``backbone``: a ViT parameter tree to graft (see :meth:`load_backbone`).
    ``xfov``/``yfov``/``xfovs``: known intrinsics, scalar or per frame."""

    def __init__(self, cfg=None, params=None, images_per_batch=40,
                 overlap=6, num_ref_frames=6, resolution=504, rng_seed=0,
                 backbone=None, xfov=None, yfov=None, xfovs=None,
                 device=None):
        self.cfg = cfg or DA3_L
        self.images_per_batch = images_per_batch
        self.overlap = overlap
        self.num_ref_frames = num_ref_frames
        self.resolution = resolution
        self.device = resolve_device(device)
        self.xfov, self.yfov = xfov, yfov
        self.xfovs = None if xfovs is None else np.asarray(xfovs, np.float32)
        self._params = params
        self._seed = rng_seed
        self._backbone = None
        self._models = {}
        if backbone is not None:
            self.load_backbone(backbone)

    def load_backbone(self, source):
        """Graft DINOv2 ViT weights into the DA3 backbone. ``source`` is a
        parameter tree in the JAX package's layout (nested dicts of arrays:
        the ViT subtree, or a full tree holding ``backbone``, with or
        without the outer ``params``). Position embeddings are resampled
        to each model's grid. Models built before the call are rebuilt."""
        if isinstance(source, str):
            raise NotImplementedError(
                "not ported yet: a backbone checkpoint given as a path "
                "(ROADMAP A5: needs the DINOv2 converter and a converted "
                "checkpoint); pass a parameter tree")
        bb = source["params"] if "params" in source else source
        self._backbone = bb["backbone"] if "backbone" in bb else bb
        self._models.clear()

    def _graft_backbone(self, model):
        bb = dict(self._backbone)
        pe_s = np.asarray(bb["pos_embed"])
        nt = model.backbone.pos_embed.shape[1] - 1
        if pe_s.shape[1] - 1 != nt:
            ns = pe_s.shape[1] - 1
            gs = int(round(ns ** 0.5))
            gt = int(round(nt ** 0.5))
            bb["pos_embed"] = vit_mod.interpolate_pos_embed(
                pe_s, (gs, ns // gs), (gt, nt // gt))
        sd = from_jax.flax_to_state_dict(bb)
        want = model.backbone.state_dict()
        mism = sorted(k for k in want.keys() | sd.keys()
                      if k not in sd or k not in want
                      or sd[k].shape != want[k].shape)
        if mism:
            raise ValueError(
                f"backbone shape mismatch at {mism[:8]}: the tree was made "
                f"for another ViT config than {self.cfg.vit}")
        model.backbone.load_state_dict(sd, strict=True)

    def _work_hw(self, h, w):
        return da.working_resolution(h, w, self.resolution,
                                     self.cfg.vit.patch_size)

    def model(self, work_hw, ray_cond=False):
        """The DA3 module at a working resolution, with or without the
        ray-embedding layer; built once per (resolution, conditioning)."""
        key = (tuple(work_hw), bool(ray_cond))
        if key not in self._models:
            model = DA3(self.cfg, work_hw, ray_cond=ray_cond)
            if self._params is None:
                vit_mod.seeded_init(
                    model, torch.Generator().manual_seed(self._seed),
                    self.cfg.vit.layerscale_init)
            else:
                model.load_state_dict(self._params, strict=True)
            if self._backbone is not None:
                self._graft_backbone(model)
            self._models[key] = model.to(self.device).eval()
        return self._models[key]

    @staticmethod
    def _run_window(model, batch_u8, rays, out_hw, work_hw):
        """One window: uint8 frames (V, H, W, 3) on the device -> (depth
        (V, H, W) on the device, w2c and xfov as numpy)."""
        x = batch_u8.to(torch.float32).permute(0, 3, 1, 2) / 255.0
        x = resize_nchw(x, work_hw).permute(0, 2, 3, 1)
        out = model(x, rays)
        d = resize_nchw(out["depth"][:, None], out_hw)[:, 0]
        return d, out["w2c"].cpu().numpy(), out["xfov_deg"].cpu().numpy()

    @torch.no_grad()
    def infer_video(self, frames_u8):
        """(T, H, W, 3) uint8 -> numpy (depth (T, H, W), c2w (T, 4, 4),
        xfov (T,))."""
        t, h, w = frames_u8.shape[:3]
        wh, ww = self._work_hw(h, w)
        windowed = t > self.images_per_batch
        n_batch = min(self.images_per_batch, t)
        n_ref = min(self.num_ref_frames, t) if windowed else 0
        v_total = n_batch + n_ref + (self.overlap if windowed else 0)

        # known-intrinsics conditioning: per-frame patch-center rays
        patch = self.cfg.vit.patch_size
        gh, gw = wh // patch, ww // patch
        known_fovs = None
        if self.xfovs is not None:
            known_fovs = np.resize(self.xfovs, t).astype(np.float32)
        elif self.xfov is not None or self.yfov is not None:
            xf = self.xfov if self.xfov is not None else \
                float(np.degrees(2 * np.arctan(
                    np.tan(np.radians(self.yfov) / 2) * w / h)))
            known_fovs = np.full(t, xf, np.float32)
        all_rays = None
        if known_fovs is not None:
            all_rays = np.stack([da.patch_center_rays(float(f), gh, gw)
                                 for f in known_fovs])      # (T, gh, gw, 3)
        model = self.model((wh, ww), ray_cond=all_rays is not None)

        # reference frames spanning the video
        ref_ids = (np.linspace(0, t - 1, n_ref).astype(int).tolist()
                   if n_ref else [])
        depth_out = np.zeros((t, h, w), np.float32)
        c2w_out = np.zeros((t, 4, 4), np.float32)
        fov_out = np.zeros(t, np.float32)

        align_depths = None      # the first window's reference depths
        tail_ids = []
        tail_c2w = None
        tail_depth = None        # on the device, like align_depths

        start = 0
        step = max(n_batch - (self.overlap if windowed else 0), 1)
        while start < t:
            batch_ids = list(range(start, min(start + n_batch, t)))
            n_pre = len(ref_ids) + len(tail_ids)
            idx = np.asarray(ref_ids + tail_ids + batch_ids)
            if v_total > idx.size:     # every window runs at one size
                idx = np.concatenate(
                    [idx, np.full(v_total - idx.size, idx[-1])])
            d, w2c, fov = self._run_window(
                model, torch.as_tensor(frames_u8[idx]).to(self.device),
                None if all_rays is None
                else torch.as_tensor(all_rays[idx]).to(self.device),
                (h, w), (wh, ww))
            c2w = np.linalg.inv(w2c)         # the model's extrinsics are w2c

            if align_depths is None and n_pre:
                align_depths = d[:len(ref_ids)]

            # depth-scale stitch on the shared frames' depths
            if tail_depth is not None and n_pre:
                anchor = tail_depth if align_depths is None else \
                    torch.cat([align_depths, tail_depth], dim=0)
                s = float(solvers.least_squares_scale(anchor, d[:n_pre]))
                d = d * s
                c2w[:, :3, 3] *= s

            # pose stitch: Umeyama over the shared camera centers, then a
            # weld on the last shared frame
            if tail_c2w is not None and tail_ids:
                cur_centers = c2w[len(ref_ids):n_pre, :3, 3]
                if cur_centers.shape[0] >= 3:
                    s3, r3, t3 = (x.numpy() for x in solvers.umeyama_sim3(
                        torch.as_tensor(cur_centers),
                        torch.as_tensor(tail_c2w[:, :3, 3])))
                    sim = np.eye(4, dtype=np.float32)
                    sim[:3, :3] = s3 * r3
                    sim[:3, 3] = t3
                    c2w = sim @ c2w
                c2w = tail_c2w[-1] @ np.linalg.inv(c2w[n_pre - 1]) @ c2w

            new = slice(n_pre, n_pre + len(batch_ids))
            depth_out[batch_ids] = d[new].cpu().numpy()
            c2w_out[batch_ids] = c2w[new]
            fov_out[batch_ids] = fov[new]

            tail_ids = batch_ids[-self.overlap:] if windowed else []
            if tail_ids:
                tail_c2w = c2w_out[tail_ids]
                tail_depth = d[new][-len(tail_ids):]
            else:
                tail_c2w = tail_depth = None
            if start + n_batch >= t:
                break
            start += step
        if known_fovs is not None:
            fov_out = known_fovs     # known intrinsics pass through verbatim
        return depth_out, c2w_out, fov_out
