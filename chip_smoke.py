#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card. Phases, each
of which fails the run on error:

  1. build      nvcc builds every kernel under
                metric_depth_video_toolbox_tpu_torch/csrc, one process per
                source, all started together.
  2. kernels    each kernel's wrapper against its plain PyTorch version
                on the card: the disparity sweep on the stereo path's own
                1080p inputs (bit-equal); block-causal attention at the
                infill phase's shape (1, 12, 18720, 128), 4 causal blocks,
                in bfloat16 and float32 (within the tolerance of
                ops/blockcausal.py::error_ratio), timed beside its plain
                version and scaled_dot_product_attention with the boolean
                block-causal mask; and at the production chunk's shape
                (1, 12, 88920, 128), 19 causal blocks, bfloat16.
  3. depth      the VDA engine (ViT-S, 518, bfloat16, seeded weights) on
                a synthetic 40-frame 1080p clip: two windows, stitched,
                made metric against the metric anchor.
  4. stereo     the movie-configuration stereo step (edge cull, edge
                anchors, infill mask, convergence), batch 8 at 1080p: all
                40 frames of the encoded phase-3 depth (kept as the infill
                input) and a synthetic scene. Phases 3-4 are the first
                main path: the launch counts are zeroed before phase 3 and
                read after phase 4.
  5. infill     the second main path: the InSpatio-World causal infill
                (WAN_1_3B, bfloat16, seeded weights, 480x832 working size,
                the inspatio_world preset's flags with chunk 40) on the
                phase-4 SBS frames and infill mask, with the synthetic
                clip as the source video; counts zeroed before, read
                after (960 block-causal launches: 2 eyes x 16 DiT forwards
                x 30 layers).
  6. reference  the depth engine, the stereo step and a narrow Wan infill
                chunk at a small size in float32 on the card and on the
                CPU: they must agree.
  7. files      depth -> stereo -> infill (--model_scale tiny) file to
                file through cli/main.py, where OpenCV is installed (else
                one line says it was skipped).
  8. profile    the stereo step, the depth engine and one eye's infill
                chunk under torch.profiler: device time, top kernels.

It then prints a JSON line of the kernels' launches, times and bounds,
the card's name and power limit, and last the device JSON line. Exits
non-zero, printing no result, when no CUDA card is present or the port's
package is not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "metric_depth_video_toolbox_tpu_torch"

H, W = 1080, 1920
BATCH = 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
F64_OPS_PER_S = 34e12          # H100 SXM float64 rate outside tensor cores
BF16_TC_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
WAN_N, WAN_BLOCKS = 18720, 4   # the infill phase's tokens and causal blocks
# the inspatio_world preset's 225-frame chunk: 57 latent frames of 30 x 52
PROD_N, PROD_BLOCKS = 88920, 19
INFILL_FRAMES = 40
# one (pixel, plane) test of the sweep: 1 - f, f * b, d - z, |.|, <, > in
# float32; (1 - f) * a + f * b in float64 (the fused lerp's rounding)
F32_PER_TEST, F64_PER_TEST = 6, 2


def log(msg):
    print(msg, flush=True)


def synth_scene(b, gen, device, h=None, w=None, shift_px=0):
    """Piecewise-smooth depth and film-like color on the device: a ground
    ramp, four slabs at staggered depths, 1% depth grain; smooth lighting,
    per-slab albedo, fine texture, sensor grain. ``shift_px`` pans the
    frames (frame i is shifted by i * shift_px columns)."""
    import torch

    h, w = h or H, w or W
    yy = torch.linspace(0.0, 1.0, h, device=device)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)
    objs = [(h // 5, 3 * h // 5, w // 8, w // 3, 3.0),
            (h // 3, 9 * h // 10, w // 2, 2 * w // 3, 6.5),
            (h // 2, 4 * h // 5, 3 * w // 4, 9 * w // 10, 12.0),
            (0, h // 4, 2 * w // 5, 3 * w // 5, 25.0)]
    albedo = [[25, -30, 10], [-35, 20, 30], [15, 25, -25], [-20, -15, 35]]
    depth = (8.0 + 42.0 * yy).expand(b, h, w).clone()
    base = (90 + 70 * yy[..., None]
            + 40 * (xs / (w - 1))[None, :, None]
            * torch.tensor([1.0, 0.8, 0.6], device=device))
    col = base.expand(b, h, w, 3).clone()
    for i in range(b):
        xx = ((xs + i * shift_px) / (w - 1))[None, :, None]
        col[i] += 18 * torch.sin(xx * 97.0 + yy[..., None] * 31.0) \
            * torch.cos(yy[..., None] * 211.0)
    for i, (t, bt, lf, rt, z) in enumerate(objs):
        depth[:, t:bt, lf:rt] = z * (1.0 + 0.05 * torch.sin(torch.tensor(
            float(i))).item())
        col[:, t:bt, lf:rt] += torch.tensor(albedo[i], device=device,
                                            dtype=torch.float32)
    depth *= 1.0 + 0.01 * torch.randn(depth.shape, generator=gen,
                                      device=device)
    col += 3.0 * torch.randn(col.shape, generator=gen, device=device)
    return (depth.clamp(1.0, 99.0),
            col.clamp(0, 255).to(torch.uint8))


def gpu_ms(fn, iters):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sweep_work(args, num_planes, pad_left):
    """(bytes, float32 ops, float64 ops) the sweep needs on these inputs.

    Bytes: the plane vectors and the bitmap read once; of the padded
    depth, once each column (per row) that some test reads; of the
    payload, once each column (per row, all C channels) that some hit
    blends; every output written once. Operations: the (pixel, active
    plane) tests up to each pixel's first hit, and the payload blend of
    each hit."""
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws

    depth_pad, color_pad, disp_int, disp_frac, plane_z, plane_tol = args[:6]
    active = args[-1]
    b, h, wp = depth_pad.shape
    c = color_pad.shape[1]
    w = wp - 2 * pad_left - 2 * ws.LANE
    dev = depth_pad.device
    nbytes = sum(t.numel() * t.element_size() for t in
                 (disp_int, disp_frac, plane_z, plane_tol, active))
    nbytes += b * h * w * (4 + 4 * c + 1)
    found = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    # per (element, row, padded column): reads by tests / by hit blends
    depth_reads = torch.zeros((b, h, wp), dtype=torch.int32, device=dev)
    payload_reads = torch.zeros((b, h, wp), dtype=torch.int32, device=dev)
    tests = 0
    row_tile = torch.arange(h, device=dev) // ws.BLOCK_ROWS
    x = torch.arange(w, device=dev)
    for p in range(num_planes):
        act = (active[:, row_tile, p] > 0)[:, :, None]
        tested = act & ~found
        tests += int(tested.sum())
        s = x[None, :] + (disp_int[:, p].long() + pad_left)[:, None]
        s = s[:, None, :].expand(b, h, w)
        gathered = []
        for idx in (s, s + 1):          # zero outside the padded row
            inside = (idx >= 0) & (idx < wp)
            idx = idx.clamp(0, wp - 1)
            gathered.append((idx, tested & inside, torch.where(
                inside, torch.gather(depth_pad, 2, idx), 0.0)))
        d = ws.blend(gathered[0][2], gathered[1][2],
                     disp_frac[:, p, None, None])
        hit = tested & (torch.abs(d - plane_z[:, p, None, None])
                        < plane_tol[:, p, None, None]) & (d > 1e-3)
        for idx, reads, _ in gathered:
            depth_reads.scatter_add_(2, idx, reads.int())
            payload_reads.scatter_add_(2, idx, (hit & reads).int())
        found |= hit
    hits = int(found.sum())
    nbytes += 4 * int((depth_reads > 0).sum())
    nbytes += 4 * c * int((payload_reads > 0).sum())
    return (nbytes, F32_PER_TEST * tests + 2 * c * hits,
            F64_PER_TEST * tests + 2 * c * hits)


def bound_ms(nbytes, f32_ops, f64_ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def movie_config(h, w):
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    return stereo.StereoConfig(width=w, height=h, max_depth=100.0,
                               remove_edges=True, place_edge_points=True,
                               make_infill_mask=True, has_convergence=True)


def stereo_inputs(depth_rgb, color, xfov=60.0, conv_depth=2.0):
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo

    b, h, w = depth_rgb.shape[:3]
    dev = depth_rgb.device
    k = geo.camera_matrix_from_fov(w, h, xfov_deg=xfov, device=dev)
    return (depth_rgb, color, k.expand(b, 3, 3), torch.eye(
        4, device=dev).expand(b, 4, 4), torch.full((b,), conv_depth,
                                                   device=dev),
            torch.ones(b, device=dev))


def phase_kernels(gen, dev):
    """Kernel vs plain on the inputs the main path gives the kernel."""
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    depth, color = synth_scene(BATCH, gen, dev)
    rgb = codec.encode_depth_frame(depth, 100.0)
    captured = []
    launch = ws.disparity_sweep

    def capture(*args):
        captured.append(args)
        return launch(*args)
    ws.disparity_sweep = capture
    try:
        stereo.stereo_step(movie_config(H, W), *stereo_inputs(rgb, color))
    finally:
        ws.disparity_sweep = launch
    if len(captured) != 2:
        raise RuntimeError(f"expected 2 sweep calls per step, saw "
                           f"{len(captured)}")
    results = {}
    for tag, args in zip(("main", "anchor"), captured):
        num_planes, pad_left = args[6], args[7]
        ref = ws.disparity_sweep_plain(*args)
        out = launch(*args)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(out, ref)]
        err = max(float((out[0] - ref[0]).abs().max()),
                  float((out[1] - ref[1]).abs().max()))
        if not all(same):
            raise RuntimeError(f"{tag} sweep: kernel != plain "
                               f"(z, color, found equal: {same}; max abs "
                               f"err {err})")
        ms = gpu_ms(lambda: launch(*args), 20)
        plain = gpu_ms(lambda: ws.disparity_sweep_plain(*args), 2)
        nbytes, ops32, ops64 = sweep_work(args, num_planes, pad_left)
        bnd, by = bound_ms(nbytes, ops32, ops64)
        shape = (f"B={args[0].shape[0]} H={args[0].shape[1]} "
                 f"WP={args[0].shape[2]} P={num_planes} "
                 f"C={args[1].shape[1]}")
        results[tag] = {"shape": shape, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd, "bound_by": by,
                        "bytes": nbytes, "f32_ops": ops32,
                        "f64_ops": ops64,
                        "max_abs_err": err,
                        "active_share": float(args[-1].float().mean())}
        log(f"[kernels] {tag}: {shape}: kernel == plain bit for bit; "
            f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bnd:.4f} "
            f"ms ({by}: {nbytes / 1e6:.1f} MB, {ops32 / 1e9:.3f} GOP "
            f"f32 + {ops64 / 1e9:.3f} GOP f64)")
    return results


def attention_work(ids, b, h, d, elem_bytes):
    """(bytes, bf16 tensor-core operations) block-causal attention needs
    on these ids: q, k, v read once and out written once; 4 D operations
    (QK^T and PV, multiply and add) per visible (query, key) pair."""
    import torch

    visible = int(torch.searchsorted(ids, ids, right=True).sum())
    n = ids.numel()
    return 4 * b * h * n * d * elem_bytes + 4 * n, 4 * d * b * h * visible


def attention_bound(ids, h, d):
    """-> (bound ms, bound by, bytes, operations) of bf16 B3 on these ids."""
    nbytes, ops = attention_work(ids, 1, h, d, 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_TC_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def check_attention(q, k, v, ids, sm, what):
    """Kernel vs the plain version in float32 on the same inputs, held to
    ``error_ratio`` <= 1; -> {max_abs_err, error_ratio}."""
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import blockcausal as bcm

    out = bcm.block_causal_attention(q, k, v, ids, sm)
    ref = bcm.block_causal_attention_plain(q.float(), k.float(), v.float(),
                                           ids, sm)
    torch.cuda.synchronize()
    r = {"max_abs_err": float((out.float() - ref).abs().max()),
         "error_ratio": bcm.error_ratio(out, ref)}
    if not r["error_ratio"] <= 1 or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"block_causal_attention {what}: kernel vs plain "
                           f"max abs err {r['max_abs_err']}, error ratio "
                           f"{r['error_ratio']} (limit 1)")
    return r


def phase_kernels_attention(gen, dev):
    """B3 against its plain version in float32 on the same inputs: at the
    infill phase's shape in bfloat16 (the infill's type) and float32,
    timed beside the plain version and SDPA with the boolean (N, N)
    block-causal mask; and at the production chunk's shape in bfloat16."""
    import torch
    import torch.nn.functional as F

    from metric_depth_video_toolbox_tpu_torch.ops import blockcausal as bcm

    d, h = 128, 12
    sm = d ** -0.5
    res = {}
    for n, blocks, dtypes in ((WAN_N, WAN_BLOCKS,
                               (torch.bfloat16, torch.float32)),
                              (PROD_N, PROD_BLOCKS, (torch.bfloat16,))):
        ids = (torch.arange(n, device=dev) // (n // blocks)).to(torch.int32)
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            tag = name if n == WAN_N else "production"
            q, k, v = (torch.randn(1, h, n, d, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            r = check_attention(q, k, v, ids, sm, f"{tag} (1, {h}, {n}, "
                                   f"{d}) {name}")
            msg = ""
            if dtype == torch.bfloat16:
                r["ms"] = gpu_ms(lambda: bcm.block_causal_attention(
                    q, k, v, ids, sm), 10 if n == WAN_N else 3)
                r["plain_ms"] = gpu_ms(
                    lambda: bcm.block_causal_attention_plain(
                        q, k, v, ids, sm), 2 if n == WAN_N else 1)
                r["bound_ms"], r["bound_by"], r["bytes"], r["ops"] = \
                    attention_bound(ids, h, d)
                if n == WAN_N:
                    # the (N, N) mask of the production length takes 7.9 GB
                    # and SDPA then falls back to materialising the scores
                    mask = ids[None, :] <= ids[:, None]
                    r["library_ms"] = gpu_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, scale=sm), 5)
                    del mask
                msg = (f"; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
                       f" ms" + (f", SDPA with the boolean mask "
                                 f"{r['library_ms']:.3f} ms"
                                 if "library_ms" in r else "")
                       + f", bound {r['bound_ms']:.3f} ms ({r['bound_by']}: "
                       f"{r['ops'] / 1e12:.3f} TFLOP bf16, "
                       f"{r['bytes'] / 1e6:.1f} MB)")
            del q, k, v
            res[tag] = r
            log(f"[kernels] block_causal_attention (1, {h}, {n}, {d}) {name},"
                f" {blocks} causal blocks: kernel vs plain (float32) max abs "
                f"err {r['max_abs_err']:.3e}, error ratio "
                f"{r['error_ratio']:.3f} (limit 1){msg}")
    return res


def phase_depth(gen, dev):
    import torch

    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage

    n = 40
    _, frames = synth_scene(n, gen, dev, shift_px=6)
    frames = frames.cpu().numpy()
    eng = dstage.VDAEngine(size="vits", input_size=518, device=dev,
                           rng_seed=0)
    eng.infer_video(frames[:8])           # warm-up: kernels, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metric = eng.infer_video(frames)
    dt = time.perf_counter() - t0
    finite = bool(torch.isfinite(torch.as_tensor(metric)).all())
    if metric.shape != (n, H, W) or not finite:
        raise RuntimeError(f"depth: shape {metric.shape}, finite {finite}")
    if metric.min() < 0 or metric.max() > eng.max_depth:
        raise RuntimeError(f"depth outside [0, max_depth]: "
                           f"{metric.min()}..{metric.max()}")
    fps = n / dt
    log(f"[depth] VDA-S 518 bf16, {n} frames 1080p (windows 32, overlap "
        f"8): {dt:.3f} s, {fps:.3f} frames/s; depth {metric.min():.3f}.."
        f"{metric.max():.3f} m")
    return metric, frames, fps


def phase_stereo(metric, frames, gen, dev):
    """The stereo step on all frames of the phase-3 depth (batches of 8,
    kept as the infill's input) and, 4 times over, on one synthetic batch.
    -> (frames/s by source, batches run, SBS frames, SBS infill mask)."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    cfg = movie_config(H, W)
    scene_depth, scene_color = synth_scene(BATCH, gen, dev)
    n = len(metric)
    clip = [stereo_inputs(codec.encode_depth_frame(torch.as_tensor(
        metric[i:i + BATCH], device=dev), 100.0), torch.as_tensor(
            frames[i:i + BATCH], device=dev)) for i in range(0, n, BATCH)]
    scene = stereo_inputs(codec.encode_depth_frame(scene_depth, 100.0),
                          scene_color)
    sources = {"phase-3 depth": clip, "synthetic scene": [scene] * 4}
    fps, batches, kept = {}, 0, None
    for name, runs in sources.items():
        out = stereo.stereo_step(cfg, *runs[0])       # warm-up and checks
        img, mask = out["image"], out["infill_mask"]
        if img.shape != (BATCH, H, 2 * W, 3) or mask.shape != img.shape:
            raise RuntimeError(f"stereo: image {img.shape}, mask "
                               f"{mask.shape}")
        hole_share = float((mask.max(-1) > 0).mean())
        if not 0.0 < hole_share < 0.5 or img.max() == 0:
            raise RuntimeError(f"stereo: implausible output (hole share "
                               f"{hole_share}, image max {img.max()})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [stereo.stereo_step(cfg, *args) for args in runs]
        dt = time.perf_counter() - t0
        batches += 1 + len(runs)
        fps[name] = len(runs) * BATCH / dt
        if kept is None:
            kept = (np.concatenate([o["image"] for o in outs]),
                    np.concatenate([o["infill_mask"] for o in outs]))
        log(f"[stereo] {name}: {len(runs)} batches of {BATCH} at 1080p, "
            f"movie config: {fps[name]:.3f} frames/s (u8 out on host); "
            f"hole share {hole_share:.4f}")
    return fps, batches, kept[0], kept[1]


def infill_engine(dev, chunk=INFILL_FRAMES):
    from metric_depth_video_toolbox_tpu_torch.models import wan as wan_mod
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as idf

    eng, drv = idf.make_engine("inspatio_world", cfg=wan_mod.WAN_1_3B,
                               device=dev, chunk=chunk)
    return eng, {k: drv[k] for k in ("mirror_left", "drift_correct",
                                      "apply_edge_blending")}


def phase_infill(eng, drv, sbs, mask_rgb, mono, dev):
    """The SBS chunk loop over both eyes (one 40-frame chunk each): the
    infill's frames/s, the sampler's latents finite, uint8 changed only
    inside the holes. The caller zeroes and reads the launch counts."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import wan as wan_mod
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as idf

    hole = np.any(mask_rgb != 0, axis=-1)
    finite = []
    eng.on_latents = lambda z: finite.append(bool(torch.isfinite(z).all()))
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = idf.infill_sbs_frames(sbs, hole, eng, mono=mono, **drv)
        dt = time.perf_counter() - t0
    finally:
        eng.on_latents = None
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = sbs.shape[0]
    if out.shape != sbs.shape or out.dtype != np.uint8:
        raise RuntimeError(f"infill: output {out.shape} {out.dtype}")
    if finite != [True, True]:
        raise RuntimeError(f"infill: sampler latents finite per eye: "
                           f"{finite}")
    if not np.array_equal(out[~hole], sbs[~hole]):
        raise RuntimeError("infill: pixels outside the holes changed")
    changed = float((out[hole] != sbs[hole]).any(-1).mean())
    if not changed > 0.5:
        raise RuntimeError(f"infill: only {changed:.3f} of hole pixels "
                           f"were filled")
    log(f"[infill] WAN_1_3B bf16, 2 eyes x {n} frames 1080x1920 -> 480x832 "
        f"(padded to {wan_mod.pad_to_valid_t(n)} frames, "
        f"{wan_mod.latent_frames(wan_mod.pad_to_valid_t(n))} latent "
        f"frames, {WAN_N} tokens): {dt:.3f} s, {2 * n / dt:.3f} eye-frames/s"
        f" ({n / dt:.3f} SBS frames/s); hole share "
        f"{float(hole.mean()):.4f}, {changed:.4f} of hole pixels changed, "
        f"outside holes unchanged; peak device memory {peak:.2f} GiB")
    return n / dt, dt, peak


def phase_reference_infill(sbs, mask_rgb, mono, dev):
    """A narrow Wan (dim 256, 2 heads of 128, 2 layers, float32) runs one
    infill chunk on the card and on the CPU with the same weights and
    noise: uint8 within 1 LSB on at most 1% of bytes, equal outside the
    holes."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import wan as wan_mod
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as idf

    cfg = wan_mod.WanConfig(dim=256, ffn_dim=512, layers=2, heads=2,
                            text_dim=64, n_prompt_tokens=4, freq_dim=64,
                            dtype="float32",
                            vae=wan_mod.WanVAEConfig(ch=16, dtype="float32"))
    # the 270x480 window of the right eye with the most holes
    hole = np.any(mask_rgb[:9, :, W:] != 0, -1)
    y0, x0 = max(((y, x) for y in range(0, H - 269, 270)
                  for x in range(0, W - 479, 480)),
                 key=lambda p: hole[:, p[0]:p[0] + 270,
                                    p[1]:p[1] + 480].sum())
    win = (slice(0, 9), slice(y0, y0 + 270))
    f = np.ascontiguousarray(sbs[win + (slice(W + x0, W + x0 + 480),)])
    m = np.ascontiguousarray(hole[win + (slice(x0, x0 + 480),)])
    mono = np.ascontiguousarray(mono[win + (slice(x0, x0 + 480),)])
    cpu = idf.CausalInfillEngine(cfg=cfg, work_hw=(64, 128), chunk=9,
                                 device="cpu")
    card = idf.CausalInfillEngine(cfg=cfg, work_hw=(64, 128), chunk=9,
                                  device=dev, params=cpu.params())
    noise = torch.randn((1, 3, 8, 16, 16),
                        generator=torch.Generator().manual_seed(5))
    got = {name: e.infill_chunk(f, m, mono, noise=noise)
           for name, e in (("cpu", cpu), ("card", card))}
    d = np.abs(got["cpu"].astype(int) - got["card"].astype(int))
    share = float((d > 0).mean())
    log(f"[reference] narrow Wan infill chunk (dim 256, 2x128 heads, 2 "
        f"layers, f32), 9 frames 270x480 -> 64x128, card vs CPU: max "
        f"{int(d.max())} LSB on {share:.5f} of bytes (limit 1 LSB on 1%); "
        f"hole share {float(m.mean()):.4f}")
    if d.max() > 1 or share > 0.01 or not np.array_equal(
            got["card"][~m], f[~m]):
        raise RuntimeError("reference: the card's infill disagrees with "
                           "the CPU's")


def phase_reference(dev):
    """The port on the card against the port on the CPU, at a small size
    in float32 (the CPU path is what the CPU tests hold against the JAX
    package): the engine's relative disparity, its metric depth fitted to
    a reference depth video (float32 end to end; the metric anchor runs
    in bfloat16 by the engine's design), and the stereo step on the same
    encoded scene."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import video_depth
    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    gen = torch.Generator().manual_seed(1)
    depth, frames = synth_scene(10, gen, "cpu", h=48, w=64, shift_px=2)
    rgb = codec.encode_depth_frame(depth[:2], 100.0)
    work = (42, 56)
    disp, metric, sbs = {}, {}, {}
    for where in ("cpu", dev):
        eng = dstage.VDAEngine(size="vitt", fp32=True, window=8, overlap=2,
                               input_size=42, device=where, rng_seed=0)
        model, _ = eng.models(work)
        disp[where] = video_depth.infer_video_depth(
            model, frames, work, (48, 64), window=8, overlap=2,
            device=where).cpu().numpy()
        metric[where] = eng.infer_video(frames.numpy(),
                                        reference_depth=depth.numpy())
        args = stereo_inputs(rgb.to(where), frames[:2].to(where))
        sbs[where] = stereo.stereo_step(movie_config(48, 64), *args)
    rel_disp = float(np.abs(disp["cpu"] - disp[dev]).max()
                     / np.abs(disp["cpu"]).max())
    rel_metric = float(np.max(np.abs(metric["cpu"] - metric[dev])
                              / metric["cpu"]))
    off = {}
    for key in ("image", "infill_mask"):
        d = np.abs(sbs["cpu"][key].astype(int) - sbs[dev][key].astype(int))
        off[key] = (int(d.max()), float((d > 0).mean()))
    log(f"[reference] vitt fp32 10x48x64, card vs CPU: relative disparity "
        f"max err {rel_disp:.3e} of its largest value, metric depth "
        f"(reference-fitted) max rel err {rel_metric:.3e} (limits 1e-3); "
        f"stereo step on the same encoded scene, (max LSB, share of bytes "
        f"off): {off} (limit 1 LSB on 0.5%)")
    if (rel_disp > 1e-3 or rel_metric > 1e-3
            or any(m > 1 or s > 0.005 for m, s in off.values())):
        raise RuntimeError("reference: the card disagrees with the CPU")


# device kernels of the infill by kind, by substrings of their names (the
# first kind that matches; cuDNN's convolutions are implicit GEMMs)
KINDS = (("B3 block-causal attention", ("bc_attn",)),
         ("convolution (VAE)", ("conv", "fprop", "dgrad", "winograd")),
         ("GEMM (dense layers)", ("gemm", "nvjet", "cutlass")),
         ("copies", ("memcpy", "memset")))


def kind_of(key):
    low = key.lower()
    for kind, subs in KINDS:
        if any(sub in low for sub in subs):
            return kind
    return "other (elementwise, norms, softmax, FFT, ...)"


def phase_profile(metric, frames, infill, dev):
    """Where the time goes: the stereo step (device only, then with the
    uint8 results copied to the host), the depth engine and one eye's
    infill chunk, each under torch.profiler; the kernels with the most
    device time, and for the infill the device time by kind."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    cfg = movie_config(H, W)
    gen = torch.Generator(device=dev).manual_seed(3)
    depth, color = synth_scene(BATCH, gen, dev)
    args = stereo_inputs(codec.encode_depth_frame(depth, 100.0), color)
    stereo.stereo_step(cfg, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stereo.stereo_frame(args[0], args[1], args[2], args[2], *args[3:], cfg)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    stereo.stereo_step(cfg, *args)
    t_host = time.perf_counter() - t0
    log(f"[profile] stereo batch {BATCH}: {t_dev * 1e3:.3f} ms on the "
        f"device, {t_host * 1e3:.3f} ms with the uint8 results on the host")
    eng = dstage.VDAEngine(size="vits", input_size=518, device=dev)
    eng.infer_video(frames[:8])
    t0 = time.perf_counter()
    eng.infer_video(frames)
    t_depth = time.perf_counter() - t0
    ieng, eye = infill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ieng.infill_chunk(*eye)
    t_infill = time.perf_counter() - t0
    for name, fn, wall, reps in (
            ("stereo step", lambda: stereo.stereo_step(cfg, *args), t_host,
             2),
            ("depth engine (40 frames)", lambda: eng.infer_video(frames),
             t_depth, 2),
            (f"infill chunk (one eye, {INFILL_FRAMES} frames)",
             lambda: ieng.infill_chunk(*eye), t_infill, 1)):
        # the first profile pays the tracer's setup
        for _ in range(reps):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        # device-side rows only (kernels and copies); the CPU ops that
        # launched them would count the same time again, and the stage
        # ranges' device-side spans cover the kernels inside them
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("infill.")]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        log(f"[profile] {name}: device busy {busy:.3f} ms of "
            f"{wall * 1e3:.3f} ms wall unprofiled ({busy / (wall * 1e3):.1%})")
        for e in sorted(events, key=lambda e: e.self_device_time_total,
                        reverse=True)[:12]:
            ms = e.self_device_time_total / 1e3
            log(f"[profile]   {ms:9.3f} ms {ms / max(busy, 1e-9):6.1%} "
                f"x{e.count:<5d} {e.key[:100]}")
        if reps == 1:
            for e in prof.key_averages():
                if (e.key.startswith("infill.")
                        and e.device_type == DeviceType.CUDA):
                    ms = e.self_device_time_total / 1e3
                    log(f"[profile]   stage {e.key}: {ms:9.3f} ms span on "
                        f"the device ({ms / (wall * 1e3):6.1%} of the wall)")
            kinds = {}
            for e in events:
                k = kind_of(e.key)
                kinds[k] = kinds.get(k, 0.0) + e.self_device_time_total / 1e3
            for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
                log(f"[profile]   by kind: {ms:9.3f} ms "
                    f"{ms / max(busy, 1e-9):6.1%} {k}")


def phase_files(dev):
    try:
        import cv2
    except ImportError:
        log("[files] phase not run: OpenCV (cv2) is not installed here, "
            "and the port's file I/O needs it")
        return
    import torch

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    gen = torch.Generator(device=dev).manual_seed(2)
    _, frames = synth_scene(12, gen, dev, h=270, w=480, shift_px=3)
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.mkv")
        vio.save_rgb_video(frames.cpu().numpy(), clip, 24)
        t0 = time.perf_counter()
        cli.main(["depth", "--color_video", clip, "--window", "8"])
        cli.main(["stereo", "--depth_video", clip + "_depth.mkv",
                  "--color_video", clip, "--xfov", "60", "--infill_mask",
                  "--batch_size", "4"])
        dt = time.perf_counter() - t0
        sbs = clip + "_depth.mkv_stereo.mkv"
        t0 = time.perf_counter()
        cli.main(["infill", "--sbs_color_video", sbs, "--color_video", clip,
                  "--infill_engine", "inspatio_world", "--model_scale",
                  "tiny"])
        dt_infill = time.perf_counter() - t0
        for out in (sbs, sbs + "_infilled.mkv"):
            with vio.VideoReader(out) as r:
                n, w = r.frame_count, r.width
            if n != 12 or w != 960:
                raise RuntimeError(f"files: {out} has {n} frames of width "
                                   f"{w}")
        log(f"[files] depth -> stereo file to file, 12 frames 270x480 "
            f"(OpenCV {cv2.__version__}): {dt:.3f} s; infill (inspatio_world"
            f", WAN_TINY at 480x832) file to file: {dt_infill:.3f} s")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    # float32 results are compared against plain versions: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"device: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    from metric_depth_video_toolbox_tpu_torch.ops import blockcausal as bcm

    names = sorted(src.stem for src in cuda_build.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    cuda_build.build(names)                  # one nvcc per source, together
    for name in names:
        cuda_build.load(name)
    log(f"[build] {len(names)} kernels in {time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in cuda_build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    sweep = phase_kernels(gen, dev)
    attention = phase_kernels_attention(gen, dev)

    def zero_counts():
        ws.LAUNCHES["disparity_sweep"] = 0
        bcm.LAUNCHES["block_causal_attention"] = 0

    def counts():
        return (ws.LAUNCHES["disparity_sweep"],
                bcm.LAUNCHES["block_causal_attention"])

    zero_counts()
    metric, frames, depth_fps = phase_depth(gen, dev)
    stereo_fps, batches, sbs, sbs_mask = phase_stereo(metric, frames, gen,
                                                      dev)
    launches, bc_off_path = counts()
    if launches != 2 * batches or bc_off_path:
        raise RuntimeError(f"depth + stereo path: disparity_sweep launched "
                           f"{launches} times, expected {2 * batches} (main "
                           f"+ anchor per batch of {BATCH} frames x 2 "
                           f"eyes); block_causal_attention {bc_off_path}, "
                           f"expected 0")
    log(f"[main path] depth + stereo: disparity_sweep launches: {launches} "
        f"over {batches} batches: 2 per batch, each sweeping {BATCH} frames "
        f"x 2 eyes = 4 sweeps per frame")

    # the infill's first chunk pays cuDNN's algorithm search and the
    # allocator's growth: one eye once before the measured run
    eng, drv = infill_engine(dev)
    eye = (np.ascontiguousarray(sbs[:, :, W:]),
           np.any(sbs_mask[:, :, W:] != 0, -1), frames)
    t0 = time.perf_counter()
    eng.infill_chunk(*eye)
    torch.cuda.synchronize()
    log(f"[infill] first chunk (one eye, weights drawn before): "
        f"{time.perf_counter() - t0:.3f} s")
    eng.clear_cache()
    zero_counts()
    infill_fps, infill_s, infill_peak = phase_infill(eng, drv, sbs, sbs_mask,
                                                     frames, dev)
    sweep_off_path, bc_launches = counts()
    want = 2 * 16 * 30
    if bc_launches != want or sweep_off_path:
        raise RuntimeError(f"infill path: block_causal_attention launched "
                           f"{bc_launches} times, expected {want} (2 eyes x "
                           f"16 DiT forwards x 30 layers); disparity_sweep "
                           f"{sweep_off_path}, expected 0")
    log(f"[main path] infill: block_causal_attention launches: "
        f"{bc_launches} = 2 eyes x 16 DiT forwards (4 causal blocks x 4 "
        f"steps) x 30 layers")

    phase_reference(dev)
    phase_reference_infill(sbs, sbs_mask, frames, dev)
    phase_files(dev)
    phase_profile(metric, frames, (eng, eye), dev)

    main_ = sweep["main"]
    bf16, prod = attention["bfloat16"], attention["production"]
    kernels = [{
        "name": "disparity_sweep", "route": "cuda",
        "source": f"{PACKAGE}/csrc/disparity_sweep.cu",
        "replaces": "metric_depth_video_toolbox_tpu/ops/warp_pallas.py:43",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in sweep.values()),
        "ms": main_["ms"], "plain_ms": main_["plain_ms"],
        "bound_ms": main_["bound_ms"], "bound_by": main_["bound_by"],
        "library_ms": None,
        "shapes": {k: {kk: v[kk] for kk in ("shape", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "active_share")}
                   for k, v in sweep.items()},
    }, {
        "name": "block_causal_attention", "route": "cuda",
        "source": f"{PACKAGE}/csrc/block_causal_attention.cu",
        "replaces":
            "metric_depth_video_toolbox_tpu/ops/blockcausal_pallas.py:43",
        "launches": bc_launches,
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
        "shape": f"(1, 12, {WAN_N}, 128) bfloat16, {WAN_BLOCKS} causal "
                 f"blocks",
        "error_ratio": bf16["error_ratio"],
        "max_abs_err_float32": attention["float32"]["max_abs_err"],
        "production": {"shape": f"(1, 12, {PROD_N}, 128) bfloat16, "
                                f"{PROD_BLOCKS} causal blocks",
                       **{k: prod[k] for k in (
                           "ms", "plain_ms", "bound_ms", "bound_by",
                           "max_abs_err", "error_ratio")}},
    }]
    log(json.dumps({"depth_fps": depth_fps, "stereo_fps": stereo_fps,
                    "infill_sbs_fps": infill_fps, "infill_s": infill_s,
                    "infill_peak_gib": infill_peak}))
    log(json.dumps({"kernels": kernels}))
    log(smi[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
