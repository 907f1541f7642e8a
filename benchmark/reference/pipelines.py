"""The plain reference of the depth stage of each engine: how a shot's
frames become metric depth (and, for DA3, cameras), in float32, from the
same weights and frames as the program. A frozen copy of the windowing,
stitching and metric alignment of the port's ``VDAEngine.infer_video`` and
``DA3Engine.infer_video``; it imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import models as m


def _to_work(frames_u8, idx, work_hw, dev):
    x = torch.as_tensor(frames_u8[idx]).to(dev).to(torch.float32)
    return m.resize_nchw(x.permute(0, 3, 1, 2) / 255.0,
                         work_hw).permute(0, 2, 3, 1)


def scale_and_shift(pred, target):
    """(s, t) minimising sum (s * pred + t - target)^2, summed in float64;
    (1, 0) when singular."""
    p = pred.to(torch.float64)
    t = target.to(torch.float64)
    a00, a01, a11 = torch.sum(p * p), torch.sum(p), float(p.numel())
    b0, b1 = torch.sum(p * t), torch.sum(t)
    det = a00 * a11 - a01 * a01
    if float(det) == 0.0:
        return 1.0, 0.0
    return (float((a11 * b0 - a01 * b1) / det),
            float((-a01 * b0 + a00 * b1) / det))


@torch.no_grad()
def vda_depth(sd_video, sd_anchor, frames_u8, cfg, dev):
    """(T, H, W, 3) uint8 host frames -> (T, H, W) float32 metric depth
    on ``dev``: windows of ``window`` frames overlapping by ``overlap``
    (the last frame repeated past the end), each aligned to the previous
    by scale and shift on the overlap; then scale and shift against the
    inverse of the metric anchor's depth on the first ``anchor_frames``."""
    e = cfg["engine"]
    t, h, w = frames_u8.shape[:3]
    ps = cfg["vit"]["patch_size"]
    work = m.working_resolution(h, w, e["input_size"], ps)
    window, overlap = e["window"], e["overlap"]
    step = window - overlap
    starts = [0]
    while starts[-1] + window < t:
        starts.append(starts[-1] + step)
    out = None
    for s0 in starts:
        idx = np.minimum(np.arange(s0, s0 + window), t - 1)
        d = m.vda_forward(sd_video, _to_work(frames_u8, idx, work, dev), cfg)
        d = m.resize_nchw(d[:, None], (h, w))[:, 0][:min(window, t - s0)]
        if out is None:
            out = d
        else:
            s, o = scale_and_shift(d[:overlap], out[-overlap:])
            out = torch.cat([out, (d * s + o)[overlap:]])
        del d
    disp = out[:t]
    n = min(e["anchor_frames"], t)
    anchor_cfg = dict(cfg, vit=cfg["anchor"]["vit"],
                      max_depth=cfg["anchor"]["max_depth"])
    inv_anchor = []
    for a in range(0, n, 16):
        idx = np.arange(a, min(a + 16, n))
        da = m.depth_anything_metric(sd_anchor,
                                     _to_work(frames_u8, idx, work, dev),
                                     anchor_cfg)
        da = m.resize_nchw(da[:, None], (h, w))[:, 0]
        inv_anchor.append(1.0 / torch.clamp(da, min=1e-3))
    s, o = scale_and_shift(disp[:n], torch.cat(inv_anchor))
    inv = disp * s + o
    depth = 1.0 / torch.clamp(inv, min=1e-6)
    depth = torch.where(inv <= 0, torch.full_like(depth, e["max_depth"]),
                        depth)
    return torch.clamp(depth, 0.0, e["max_depth"])


def _umeyama(src, dst):
    """(scale, rot, trans) with dst ~ scale * rot @ src + trans, (N, 3)
    float64 numpy."""
    cs, cd = src.mean(0), dst.mean(0)
    sc, dc = src - cs, dst - cd
    var_s = (sc * sc).sum() / len(src)
    cov = dc.T @ sc / len(src)
    u, dd, vt = np.linalg.svd(cov)
    flip = np.array([1.0, 1.0, np.sign(np.linalg.det(u @ vt)) or 1.0])
    rot = u @ np.diag(flip) @ vt
    scale = (dd * flip).sum() / max(var_s, 1e-12)
    return scale, rot, cd - scale * rot @ cs


@torch.no_grad()
def da3_depth(sd, frames_u8, cfg, dev):
    """(T, H, W, 3) uint8 host frames -> (depth (T, H, W) on ``dev``,
    c2w (T, 4, 4) and xfov (T,) float64 numpy): windows of
    ``images_per_batch`` new views, with ``num_ref_frames`` reference
    views spread over the shot and the previous window's last ``overlap``
    views in front, every window padded to one size with its last view;
    each window's depth scaled by least squares on the shared views, its
    cameras moved by the similarity of the shared camera centres and welded
    at the last shared view."""
    e = cfg["engine"]
    t, h, w = frames_u8.shape[:3]
    ps = cfg["vit"]["patch_size"]
    work = m.working_resolution(h, w, e["resolution"], ps)
    windowed = t > e["images_per_batch"]
    n_batch = min(e["images_per_batch"], t)
    n_ref = min(e["num_ref_frames"], t) if windowed else 0
    ov = e["overlap"] if windowed else 0
    v_total = n_batch + n_ref + ov
    ref_ids = (np.linspace(0, t - 1, n_ref).astype(int).tolist()
               if n_ref else [])
    depth_out = torch.zeros((t, h, w), dtype=torch.float32, device=dev)
    c2w_out = np.zeros((t, 4, 4))
    fov_out = np.zeros(t)
    align = None
    tail_ids, tail_c2w, tail_depth = [], None, None
    start, step = 0, max(n_batch - ov, 1)
    while start < t:
        batch_ids = list(range(start, min(start + n_batch, t)))
        n_pre = len(ref_ids) + len(tail_ids)
        idx = np.asarray(ref_ids + tail_ids + batch_ids)
        if v_total > idx.size:
            idx = np.concatenate([idx, np.full(v_total - idx.size, idx[-1])])
        d, w2c, fov = m.da3_forward(sd, _to_work(frames_u8, idx, work, dev),
                                    cfg)
        d = m.resize_nchw(d[:, None], (h, w))[:, 0]
        c2w = np.linalg.inv(w2c.double().cpu().numpy())
        fov = fov.double().cpu().numpy()
        if align is None and n_pre:
            align = d[:len(ref_ids)]
        if tail_depth is not None and n_pre:
            anchor = torch.cat([align, tail_depth]) if align is not None \
                else tail_depth
            p = d[:n_pre].to(torch.float64)
            den = float(torch.sum(p * p))
            s = float(torch.sum(anchor.to(torch.float64) * p)) / den \
                if den else 1.0
            d = d * s
            c2w[:, :3, 3] *= s
        if tail_c2w is not None and tail_ids:
            cur = c2w[len(ref_ids):n_pre, :3, 3]
            if cur.shape[0] >= 3:
                s3, r3, t3 = _umeyama(cur, tail_c2w[:, :3, 3])
                sim = np.eye(4)
                sim[:3, :3] = s3 * r3
                sim[:3, 3] = t3
                c2w = sim @ c2w
            c2w = tail_c2w[-1] @ np.linalg.inv(c2w[n_pre - 1]) @ c2w
        new = slice(n_pre, n_pre + len(batch_ids))
        depth_out[batch_ids] = d[new]
        c2w_out[batch_ids] = c2w[new]
        fov_out[batch_ids] = fov[new]
        tail_ids = batch_ids[-e["overlap"]:] if windowed else []
        if tail_ids:
            tail_c2w = c2w_out[tail_ids]
            tail_depth = d[new][-len(tail_ids):]
        else:
            tail_c2w = tail_depth = None
        del d
        if start + n_batch >= t:
            break
        start += step
    return depth_out, c2w_out, fov_out
