#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card. Phases, each
of which fails the run on error:

  1. build      nvcc builds every kernel under
                metric_depth_video_toolbox_tpu_torch/csrc.
  2. kernels    each kernel's wrapper, on the main path's own inputs at
                1080p, against its plain PyTorch version: bit-equal.
  3. depth      the VDA engine (ViT-S, 518, bfloat16, seeded weights) on
                a synthetic 40-frame 1080p clip: two windows, stitched,
                made metric against the metric anchor.
  4. stereo     the movie-configuration stereo step (edge cull, edge
                anchors, infill mask, convergence), batch 8 at 1080p, on
                the encoded phase-3 depth and on a synthetic scene.
                Phases 3-4 are the main path: the kernel launch counts
                are zeroed before phase 3 and read after phase 4.
  5. reference  the same engine and stereo step at a small size in
                float32 on the card and on the CPU: they must agree.
  6. files      depth -> stereo file to file through cli/main.py, where
                OpenCV is installed (else one line says it was skipped).
  7. profile    the stereo step and the depth engine once each under
                torch.profiler: device time, host-copy time, top kernels.

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
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    cfg = movie_config(H, W)
    scene_depth, scene_color = synth_scene(BATCH, gen, dev)
    sources = {
        "phase-3 depth": (codec.encode_depth_frame(
            torch.as_tensor(metric[:BATCH], device=dev), 100.0),
            torch.as_tensor(frames[:BATCH], device=dev)),
        "synthetic scene": (codec.encode_depth_frame(scene_depth, 100.0),
                            scene_color)}
    fps = {}
    reps = 4
    for name, (rgb, color) in sources.items():
        args = stereo_inputs(rgb, color)
        out = stereo.stereo_step(cfg, *args)
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
        for _ in range(reps):
            stereo.stereo_step(cfg, *args)
        dt = time.perf_counter() - t0
        fps[name] = reps * BATCH / dt
        log(f"[stereo] {name}: batch {BATCH} 1080p movie config: "
            f"{fps[name]:.3f} frames/s (u8 out on host); hole share "
            f"{hole_share:.4f}")
    return fps, len(sources) * (reps + 1)


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


def phase_profile(metric, frames, dev):
    """Where the time goes: the stereo step (device only, then with the
    uint8 results copied to the host) and the depth engine, each once
    under torch.profiler; the kernels with the most device time."""
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
    for name, fn, wall in (
            ("stereo step", lambda: stereo.stereo_step(cfg, *args), t_host),
            ("depth engine (40 frames)", lambda: eng.infer_video(frames),
             t_depth)):
        for _ in range(2):      # the first profile pays the tracer's setup
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        # device-side rows only (kernels and copies); the CPU ops that
        # launched them would count the same time again
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e3
        log(f"[profile] {name}: device busy {busy:.3f} ms of "
            f"{wall * 1e3:.3f} ms wall unprofiled ({busy / (wall * 1e3):.1%})")
        for e in sorted(events, key=lambda e: e.self_device_time_total,
                        reverse=True)[:12]:
            ms = e.self_device_time_total / 1e3
            log(f"[profile]   {ms:9.3f} ms {ms / max(busy, 1e-9):6.1%} "
                f"x{e.count:<5d} {e.key[:100]}")


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
        out = clip + "_depth.mkv_stereo.mkv"
        with vio.VideoReader(out) as r:
            n, w = r.frame_count, r.width
        if n != 12 or w != 960:
            raise RuntimeError(f"files: {out} has {n} frames of width {w}")
        log(f"[files] depth -> stereo file to file, 12 frames 270x480 "
            f"(OpenCV {cv2.__version__}): {dt:.3f} s")


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

    for src in sorted(cuda_build.CSRC_DIR.glob("*.cu")):
        t0 = time.perf_counter()
        cuda_build.load(src.stem)
        log(f"[build] {src.stem} in {time.perf_counter() - t0:.2f} s")
        for line in cuda_build.BUILD_LOG.get(src.stem, "").splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {src.stem}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    sweep = phase_kernels(gen, dev)

    ws.LAUNCHES["disparity_sweep"] = 0
    metric, frames, depth_fps = phase_depth(gen, dev)
    stereo_fps, batches = phase_stereo(metric, frames, gen, dev)
    launches = ws.LAUNCHES["disparity_sweep"]
    if launches != 2 * batches:
        raise RuntimeError(f"disparity_sweep launched {launches} times on "
                           f"the main path, expected {2 * batches} (main "
                           f"+ anchor per batch of {BATCH} frames x 2 "
                           f"eyes)")
    log(f"[main path] disparity_sweep launches: {launches} over {batches} "
        f"batches: 2 per batch, each sweeping {BATCH} frames x 2 eyes = 4 "
        f"sweeps per frame")

    phase_reference(dev)
    phase_files(dev)
    phase_profile(metric, frames, dev)

    main_ = sweep["main"]
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
    }]
    log(json.dumps({"depth_fps": depth_fps, "stereo_fps": stereo_fps}))
    log(json.dumps({"kernels": kernels}))
    log(smi[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
