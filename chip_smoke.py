#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline-csrc DIR]

Run from the repository root on a machine with a CUDA card. Phases, each
of which fails the run on error:

  1. build      nvcc builds every kernel under
                metric_depth_video_toolbox_tpu_torch/csrc, one process per
                source, all started together; ptxas's registers, shared
                memory and spills of every entry point are printed.
  2. kernels    each kernel's wrapper against its plain PyTorch version
                on the card: the disparity sweep and the fused main +
                anchor sweep on the stereo path's own 1080p inputs
                (bit-equal, and the fused sweep's main surface bit-equal to
                the single sweep's under the same bitmap), then each sweep
                timed with its bitmap as computed, all zero and all ones,
                with what each asks of the loop (tests, inactive planes
                passed, pre-test survivors) and the SASS counts of float64
                work (with --baseline-csrc DIR, the same for the sweep
                sources of DIR, timed in turns and held bit-equal to this
                checkout's); block-causal
                attention at the infill phase's shape (1, 12, 18720, 128),
                4 causal blocks, in bfloat16 and float32 (within the
                tolerance of ops/blockcausal.py::error_ratio), timed beside
                its plain version and scaled_dot_product_attention with
                the boolean block-causal mask, and at the production
                chunk's shape (1, 12, 88920, 128), 19 causal blocks,
                bfloat16, beside the same SDPA call (or its refusal);
                packed-qkv attention at DA3_L's cross-view shape
                (1, 52 x 2368, 48, 64) and per-view shape (52, 2368, 48,
                64), 2305 real tokens per view, in bfloat16 and float32
                (same tolerance, real query rows; pad rows finite), timed
                beside its plain version and scaled_dot_product_attention
                with the key mask and, unmasked, on the real tokens only.
  3. depth      the VDA engine (ViT-S, 518, bfloat16, seeded weights) on
                a synthetic 40-frame 1080p clip: two windows, stitched,
                made metric against the metric anchor.
  4. stereo     the movie-configuration stereo step (edge cull, edge
                anchors, infill mask, convergence), batch 8 at 1080p: all
                40 frames of the encoded phase-3 depth (kept as the infill
                input) and a synthetic scene. Phases 3-4 are the first
                main path: the launch counts are zeroed before phase 3 and
                read after phase 4. Then the same step with
                fused_anchor_sweep on the synthetic scene (counts zeroed
                before, read after: one fused launch per batch).
  5. infill     the second main path: the InSpatio-World causal infill
                (WAN_1_3B, bfloat16, seeded weights, 480x832 working size,
                the inspatio_world preset's flags with chunk 40) on the
                phase-4 SBS frames and infill mask, with the synthetic
                clip as the source video; counts zeroed before, read
                after (960 block-causal launches: 2 eyes x 16 DiT forwards
                x 30 layers).
  6. da3        the third main path: the DA3 engine (DA3_L: ViT-L with
                cross-view attention in the 12 odd blocks, dual DPT head,
                504, bfloat16, seeded weights, windows of 40 + 6 reference
                + 6 overlap frames) on a synthetic 46-frame 1080p clip (two
                windows of 52 views, so both stitches and the weld run)
                with attention_impl="flash_packed"; counts zeroed before,
                read after (48 packed-attention launches: 2 windows x 24
                blocks). Then the same clip and weights through the
                default attention (scaled_dot_product_attention), and the
                two depths compared.
  7. movie      the fourth main path, the toolbox's own: ``mdvt-torch
                movie`` file to file through cli/main.py at its defaults
                (VDA-S at 518, U²-Net SEG_FULL at 320 in bfloat16, the
                movie-configuration stereo step in batches of 16, the basic
                infill, seeded weights) on a synthetic 1080p clip of two
                40-frame scenes with a hard cut; counts zeroed before, read
                after (the disparity sweep twice per stereo batch, nothing
                else); the scene CSV, the per-scene files, 80 final frames
                of width 3840 and StereoMode 1 checked; each step's wall
                time and the movie's source frames/s printed. Then the
                movie's ``--infill_engine diffusion`` as a resume of that
                run: the scenes' infilled files and the final movie
                deleted, the movie run again, so only steps 6-7 run (the
                JAX package's default engine, DIFFUSION_TINY at 256 x 256,
                per scene; counts zeroed before, read after: no launch).
  7b. svd_infill the SVD-class infill through ``mdvt-torch infill`` on the
                phase-4 SBS frames and mask as files: (a) ``diffusion`` at
                its defaults (DIFFUSION_SVD, 768x1024, chunks 25/6, the
                halo blend), (b) ``m2svid`` (512x512, the phase-3 clip as
                mono conditioning), (c) ``--model_scale svd`` (the
                StereoCrafter graph, SVDConfig, bf16) on 25 frames; each
                with its parameter count, wall time, SBS frames/s, peak
                device memory, one chunk's device busy share and top
                device operations; counts zeroed before each, read after
                (no hand-written kernel on this path).
  7c. checkpoints converted checkpoints read from files: upstream-layout
                state dicts drawn with a seeded torch.Generator, written
                with torch.save, converted by convert_torch_file, written by
                save_checkpoint (Flax's msgpack), then through the commands:
                (a) VDA-S at the phase-3 widths and working grid, ``depth
                --checkpoint`` on the phase-3 clip, its depth video bit-equal
                to the same tree's engine in memory (the ignored resize
                leaves printed), then ``stereo`` on 16 frames (2 disparity-
                sweep launches); (b) a DINOv2 ViT-L on the upstream 518 grid
                through ``da3 --backbone_checkpoint`` and grafted into DA3_L
                on the flash_packed route (48 packed-attention launches,
                every grafted weight equal to the file's); (c) ``infill
                --infill_engine inspatio_world --checkpoint`` with a {dit,
                enc, dec} tree at WAN_1_3B (WAN_TINY, said so, when the
                script has run past CKPT_WAN_CUTOFF_S) on 16 SBS frames,
                the preset's 225-frame chunk cut to 16 (block-causal
                launches); (d) every file read back and held
                bit for bit against what was written, on the card, and a
                file with float32 and bfloat16 leaves over 2^30 bytes in
                Flax's chunked layout. File sizes and the seconds of each
                step printed, and (a) and (b)'s frames/s beside phases 3
                and 6.
  8. reference  the depth engine, the stereo step, a narrow Wan infill
                chunk, the SVD-class infill chunk (DIFFUSION_TINY with
                mono, SVD_TINY with CLIP_TINY), a narrow DA3
                (flash_packed), U²-Net SEG_TINY and the basic infill at a
                small size in float32 on the card and on the CPU: they
                must agree.
  9. files      depth -> stereo -> infill (--model_scale tiny), da3
                (--model_size vitt) and stereo --fused_anchor_sweep file to
                file through cli/main.py (OpenCV needed: the phase fails
                without it, as the movie phase does).
 10. profile    the stereo step, the depth engine, one eye's infill chunk,
                the DA3 clip, one 16-frame 1080p batch of U²-Net SEG_FULL
                masks and one 4-frame 3840x1080 batch of the basic infill
                under torch.profiler: device time, top kernels.
 11. stereo_paths the general stereo renderer and the novel-view render
                (after the earlier phases' models are freed), file to file
                through cli/main.py on phase 3's first 16 frames (depth
                mapped onto 1..30 m, as RGB-encoded FFV1, the colour clip;
                the seeded weights' range is a few cm) under a seeded smooth
                camera path: (a) ``stereo --transformation_file
                --infill_mask`` (the forward warp's scatter z-buffer and
                splatted edge anchors), (b) the same with
                ``--transformation_lock_frame 8 --render_as_pointcloud``,
                (c) ``--touchly1 --infill_mask`` (counts zeroed before,
                read after: the disparity sweep twice a batch, the first
                launch bit-equal to the plain sweep), (d) ``--vr180
                --infill_mask`` and (e) ``--touchly0`` on 8 frames at the
                1920 eye size, (f) ``--mask_video --save_background`` on
                10 frames (to the first downsample; each downsample's point
                counts and the .npy size printed), then ``--load_background
                --infill_mask``, (g) ``view --render`` and the same with
                ``--render_as_pointcloud``, (h) (a) with ``--profile DIR``
                (a trace file must appear); each with its wall, frames/s
                and output size. Then one forward-warp stereo step at batch
                8 under torch.profiler (device time, busy share, top 5
                device ops); the step at 3840x2160 and the CLI's default
                batch of 16 (its peak memory, bounded by the z-buffer's
                passes of whole images); and the batch-8 step on the card
                and on the CPU for 2 frames (the hole masks may disagree on
                at most 1% of their union, and at most 0.1% of image bytes
                may differ by more than 1).

It then prints a JSON line of the kernels' launches, times, bounds,
library times (and kernel / library ratios), registers and spilled bytes,
the card's name and power limit, and last the device JSON line. Exits
non-zero, printing no result, when no CUDA card is present or the port's
package is not beside this script.
"""

from __future__ import annotations

import contextlib
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
MOVIE_SCENE_FRAMES = 40        # the movie phase: two scenes of 40 frames
MOVIE_BATCH = 16               # the movie's stereo batch (its default)
# DA3_L on a 1080p clip longer than its 40-frame window: 504 x 896 working
# size, 36 x 64 + 1 tokens per view, 40 + 6 reference + 6 overlap views
DA3_VIEWS, DA3_TOKENS, DA3_HEADS, DA3_HEAD_DIM = 52, 2305, 16, 64
DA3_FRAMES = 46                # two windows
DA3_BLOCKS = 24                # ViT-L's depth: 12 per-view + 12 cross-view
# one (pixel, plane) test of the sweep: 1 - f, f * b, d - z, |.|, <, > in
# float32; (1 - f) * a + f * b in float64 (the fused lerp's rounding)
F32_PER_TEST, F64_PER_TEST = 6, 2
# DA3 through B4 against the same weights through SDPA, both bfloat16
# (the routes round at other places inside each of 24 attentions): largest
# and mean absolute depth difference as a share of the largest depth.
# Measured on an H100: 2.7e-2 and 1.5e-3.
DA3_ROUTE_MAX, DA3_ROUTE_MEAN = 0.08, 0.005


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


def sweep_stream(depth_pad, disp_int, disp_frac, plane_z, plane_tol, active,
                 block_rows, num_planes, pad_left):
    """What one depth stream of a sweep needs on these inputs -> (tests,
    hits, depth columns read, payload columns read, counts): the (pixel,
    active plane) tests up to each pixel's first hit, the hits, and per
    (element, row, padded column) whether some test reads the depth there
    and whether some hit blends the payload there; ``counts`` has the
    inactive planes a pixel passes before its first hit (what a loop over
    all P planes iterates in vain) and the tests that survive the sweep
    core's float32 pre-test (``warp_sweep.sweep_pretest``: the float64
    blends it runs)."""
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws

    b, h, wp = depth_pad.shape
    w = wp - 2 * pad_left - 2 * ws.LANE
    dev = depth_pad.device
    found = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    depth_reads = torch.zeros((b, h, wp), dtype=torch.int32, device=dev)
    payload_reads = torch.zeros((b, h, wp), dtype=torch.int32, device=dev)
    tests = inactive = survivors = 0
    row_tile = torch.arange(h, device=dev) // block_rows
    x = torch.arange(w, device=dev)
    for p in range(num_planes):
        act = (active[:, row_tile, p] > 0)[:, :, None]
        tested = act & ~found
        tests += int(tested.sum())
        inactive += int((~act & ~found).sum())
        s = x[None, :] + (disp_int[:, p].long() + pad_left)[:, None]
        s = s[:, None, :].expand(b, h, w)
        gathered = []
        for idx in (s, s + 1):          # zero outside the padded row
            inside = (idx >= 0) & (idx < wp)
            idx = idx.clamp(0, wp - 1)
            gathered.append((idx, tested & inside, torch.where(
                inside, torch.gather(depth_pad, 2, idx), 0.0)))
        f = disp_frac[:, p, None, None]
        z = plane_z[:, p, None, None]
        tol = plane_tol[:, p, None, None]
        d = ws.blend(gathered[0][2], gathered[1][2], f)
        survivors += int((tested & ws.sweep_pretest(
            gathered[0][2], gathered[1][2], f, z, tol)).sum())
        hit = tested & (torch.abs(d - z) < tol) & (d > 1e-3)
        for idx, reads, _ in gathered:
            depth_reads.scatter_add_(2, idx, reads.int())
            payload_reads.scatter_add_(2, idx, (hit & reads).int())
        found |= hit
    counts = {"tests": tests, "inactive_iterations": inactive,
              "pretest_survivors": survivors, "hits": int(found.sum()),
              "pixels": b * h * w}
    return (tests, counts["hits"], depth_reads > 0, payload_reads > 0,
            counts)


def sweep_work(args, num_planes, pad_left):
    """(bytes, float32 ops, float64 ops) the sweep needs on these inputs.

    Bytes: the plane vectors and the bitmap read once; of the padded
    depth, once each column (per row) that some test reads; of the
    payload, once each column (per row, all C channels) that some hit
    blends; every output written once. Operations: the (pixel, active
    plane) tests up to each pixel's first hit, and the payload blend of
    each hit."""
    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws

    depth_pad, color_pad, disp_int, disp_frac, plane_z, plane_tol = args[:6]
    active = args[-1]
    b, h, wp = depth_pad.shape
    c = color_pad.shape[1]
    w = wp - 2 * pad_left - 2 * ws.LANE
    tests, hits, depth_read, payload_read, _ = sweep_stream(
        depth_pad, disp_int, disp_frac, plane_z, plane_tol, active,
        ws.BLOCK_ROWS, num_planes, pad_left)
    nbytes = sum(t.numel() * t.element_size() for t in
                 (disp_int, disp_frac, plane_z, plane_tol, active))
    nbytes += b * h * w * (4 + 4 * c + 1)
    nbytes += 4 * int(depth_read.sum()) + 4 * c * int(payload_read.sum())
    return (nbytes, F32_PER_TEST * tests + 2 * c * hits,
            F64_PER_TEST * tests + 2 * c * hits)


def dual_sweep_work(args):
    """(bytes, float32 ops, float64 ops) the fused main + anchor sweep
    needs on these inputs: :func:`sweep_work`'s rule over the two streams.
    The plane vectors once, both bitmaps, each stream's depth columns that
    its tests read, the shared payload's columns that a hit of either
    stream blends, the extra payload's columns that an anchor hit blends,
    the six outputs once; the tests of each stream up to its own first hit
    and the blends of its hits (S channels for a main hit, S + E for an
    anchor hit)."""
    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws

    (depth_pad, edepth_pad, shared_pad, extra_pad, disp_int, disp_frac,
     plane_z, plane_tol, act_main, act_edge, num_planes, pad_left) = args
    b, h, wp = depth_pad.shape
    s, e = shared_pad.shape[1], extra_pad.shape[1]
    w = wp - 2 * pad_left - 2 * ws.LANE
    planes = (disp_int, disp_frac, plane_z, plane_tol)
    main = sweep_stream(depth_pad, *planes, act_main, ws.DUAL_BLOCK_ROWS,
                        num_planes, pad_left)
    edge = sweep_stream(edepth_pad, *planes, act_edge, ws.DUAL_BLOCK_ROWS,
                        num_planes, pad_left)
    nbytes = sum(t.numel() * t.element_size()
                 for t in planes + (act_main, act_edge))
    nbytes += b * h * w * (4 + 4 * s + 1 + 4 * s + 4 * e + 1)
    nbytes += 4 * int(main[2].sum()) + 4 * int(edge[2].sum())
    nbytes += 4 * s * int((main[3] | edge[3]).sum()) + 4 * e * int(
        edge[3].sum())
    tests = main[0] + edge[0]
    blends = 2 * s * main[1] + 2 * (s + e) * edge[1]
    return (nbytes, F32_PER_TEST * tests + blends,
            F64_PER_TEST * tests + blends)


def bound_ms(nbytes, f32_ops, f64_ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ptxas_report(log):
    """nvcc's -Xptxas -v output -> {mangled function: {"regs", "smem",
    "spill_bytes"}} (spill stores plus spill loads, in bytes)."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([A-Za-z0-9_]+)", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {"regs": None, "smem": 0, "spill_bytes": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem"] = int(m.group(1)) if m else 0
    return out


# the kernel of each source that its main path launches, by a substring of
# its mangled name: the sweep core with one and two streams, and the bf16
# attention core at the main path's head dim with the source's mask policy
MAIN_PATH_FUNCTION = {
    "disparity_sweep": "sweep_sm90ILi1E",
    "disparity_sweep_dual": "sweep_sm90ILi2E",
    "block_causal_attention": "flash_sm90ILi128E",
    "packed_flash_attention": "flash_sm90ILi64E",
}


def kernel_resources(report, name):
    """-> {"regs", "spill_bytes"} of ``name``'s main-path kernel."""
    for fn, r in report.get(name, {}).items():
        if MAIN_PATH_FUNCTION[name] in fn:
            return {"regs": r["regs"], "spill_bytes": r["spill_bytes"]}
    raise RuntimeError(f"no ptxas report for {name}'s "
                       f"{MAIN_PATH_FUNCTION[name]}")


def movie_config(h, w, **kw):
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    return stereo.StereoConfig(width=w, height=h, max_depth=100.0,
                               remove_edges=True, place_edge_points=True,
                               make_infill_mask=True, has_convergence=True,
                               **kw)


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


def captured_calls(module, name, fn):
    """Run ``fn`` with ``module.name`` wrapped -> the argument tuples of
    the calls it made."""
    calls = []
    launch = getattr(module, name)

    def capture(*args):
        calls.append(args)
        return launch(*args)
    setattr(module, name, capture)
    try:
        fn()
    finally:
        setattr(module, name, launch)
    return calls


def phase_kernels(gen, dev):
    """Both sweep kernels vs their plain versions on the inputs the stereo
    step gives them. -> (results of the single sweep by call, result of
    the fused sweep)"""
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    depth, color = synth_scene(BATCH, gen, dev)
    rgb = codec.encode_depth_frame(depth, 100.0)
    launch = ws.disparity_sweep
    captured = captured_calls(
        ws, "disparity_sweep", lambda: stereo.stereo_step(
            movie_config(H, W), *stereo_inputs(rgb, color)))
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

    # the fused main + anchor sweep on the same frames
    launch_dual = ws.disparity_sweep_dual
    fused = captured_calls(
        ws, "disparity_sweep_dual", lambda: stereo.stereo_step(
            movie_config(H, W, fused_anchor_sweep=True),
            *stereo_inputs(rgb, color)))
    if len(fused) != 1:
        raise RuntimeError(f"expected 1 fused sweep call per step, saw "
                           f"{len(fused)}")
    args = fused[0]
    ref = ws.disparity_sweep_dual_plain(*args)
    out = launch_dual(*args)
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(out, ref)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(out, ref))
    if not all(same):
        raise RuntimeError(f"fused sweep: kernel != plain (z, color, found, "
                           f"anchor color, anchor extra, anchor found "
                           f"equal: {same}; max abs err {err})")
    # its main surface against the single sweep's kernel: the same padded
    # depth, payload and planes, and the single sweep's 64-row bitmap given
    # to the fused sweep as 32-row tiles (each row of tiles twice)
    single = captured[0]
    for a, b in zip(args[:1] + args[2:3] + args[4:8],
                    single[:6]):
        if not torch.equal(a, b):
            raise RuntimeError("fused sweep: the step gave it other main "
                               "inputs than the single sweep")
    coarse = single[-1].repeat_interleave(2, dim=1)[
        :, :args[8].shape[1]].contiguous()
    out_coarse = launch_dual(*args[:8], coarse, *args[9:])
    main_same = [torch.equal(a, b)
                 for a, b in zip(out_coarse[:3], launch(*single))]
    if not all(main_same):
        raise RuntimeError(f"fused sweep: main surface != single sweep's "
                           f"(z, color, found equal: {main_same})")
    ms = gpu_ms(lambda: launch_dual(*args), 20)
    plain = gpu_ms(lambda: ws.disparity_sweep_dual_plain(*args), 1)
    nbytes, ops32, ops64 = dual_sweep_work(args)
    bnd, by = bound_ms(nbytes, ops32, ops64)
    shape = (f"B={args[0].shape[0]} H={args[0].shape[1]} "
             f"WP={args[0].shape[2]} P={args[10]} S={args[2].shape[1]} "
             f"E={args[3].shape[1]}")
    dual = {"shape": shape, "ms": ms, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "bytes": nbytes, "f32_ops": ops32,
            "f64_ops": ops64, "max_abs_err": err,
            "active_share": [float(a.float().mean()) for a in args[8:10]],
            "anchor_share": float(out[5].float().mean())}
    log(f"[kernels] fused main + anchor: {shape}: kernel == plain bit for "
        f"bit on all six outputs, main surface == single sweep's; anchors "
        f"on {dual['anchor_share']:.4f} of pixels; kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {bnd:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
        f"{ops32 / 1e9:.3f} GOP f32 + {ops64 / 1e9:.3f} GOP f64)")
    return results, dual, captured, args


SASS_OPS = ("F2F", "DADD", "DMUL", "DFMA")
BITMAPS = ("computed", "zeros", "ones")


def sass_counts(lib_path):
    """``cuobjdump -sass`` of a built library -> {function: {"instructions":
    n, "F2F": n, "DADD": n, "DMUL": n, "DFMA": n}}: every SASS instruction
    of each kernel and its float64 conversions and arithmetic (the whole
    function, not only its loop). None where cuobjdump is missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"instructions": 0, **{op: 0 for op in SASS_OPS}}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)", line)
        if fn is not None and m:
            out[fn]["instructions"] += 1
            if m.group(1) in SASS_OPS:
                out[fn][m.group(1)] += 1
    return out


def build_baseline(csrc):
    """The two sweep sources of another checkout's ``csrc`` directory (for
    example the parent commit's, unpacked with git archive) built into
    build/baseline -> ({name: ctypes library}, {name: library path},
    {name: ptxas report})."""
    import ctypes
    from pathlib import Path

    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    names = ("disparity_sweep", "disparity_sweep_dual")
    saved = (cuda_build.CSRC_DIR, cuda_build.BUILD_DIR,
             dict(cuda_build.BUILD_LOG))
    cuda_build.CSRC_DIR = Path(csrc).resolve()
    cuda_build.BUILD_DIR = Path(REPO) / "build" / "baseline"
    try:
        paths = {n: cuda_build.library_path(n) for n in names}
        for path in paths.values():
            path.unlink(missing_ok=True)
        cuda_build.build(names)
        report = {n: ptxas_report(cuda_build.BUILD_LOG.get(n, ""))
                  for n in names}
        return ({n: ctypes.CDLL(str(p)) for n, p in paths.items()}, paths,
                report)
    finally:
        cuda_build.CSRC_DIR, cuda_build.BUILD_DIR = saved[:2]
        cuda_build.BUILD_LOG.clear()
        cuda_build.BUILD_LOG.update(saved[2])


@contextlib.contextmanager
def libraries(libs):
    """The sweep wrappers launch ``libs``' kernels inside the block (None:
    the checkout's own)."""
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    load = cuda_build.load
    if libs is not None:
        cuda_build.load = lambda name: libs[name]
    try:
        yield
    finally:
        cuda_build.load = load


def phase_sweep_ablation(calls, dual_args, baseline_csrc=None):
    """Each sweep (main, anchor, fused) on the stereo path's own inputs
    with three bitmaps: as computed, all zero (staging and stores only) and
    all ones (every plane tested up to the first hit): ms per launch, and
    what the function asks on each (sweep_stream's counts). With
    ``baseline_csrc``, the same for the kernels built from that directory,
    timed in turns with this checkout's (baseline, this, this, baseline;
    the best of each), after checking that both give the same outputs bit
    for bit. SASS counts of both. -> results by sweep."""
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws
    from metric_depth_video_toolbox_tpu_torch.utils import cuda_build

    def with_bitmap(tag, args, bm):
        if tag == "dual":
            acts = [a if bm == "computed" else (torch.zeros_like(a)
                    if bm == "zeros" else torch.ones_like(a))
                    for a in args[8:10]]
            return args[:8] + tuple(acts) + args[10:]
        a = args[-1]
        a = a if bm == "computed" else (torch.zeros_like(a) if bm == "zeros"
                                        else torch.ones_like(a))
        return args[:-1] + (a,)

    cases = {"main": calls[0], "anchor": calls[1], "dual": dual_args}
    launch = {"main": ws.disparity_sweep, "anchor": ws.disparity_sweep,
              "dual": ws.disparity_sweep_dual}
    base = build_baseline(baseline_csrc) if baseline_csrc else None
    res = {}
    for tag, args in cases.items():
        r = res[tag] = {"ms": {}, "counts": {}}
        if base:
            r["baseline_ms"] = {}
        for bm in BITMAPS:
            a = with_bitmap(tag, args, bm)
            if tag == "dual":
                planes = a[4:8]
                r["counts"][bm] = {
                    stream: sweep_stream(depth, *planes, act,
                                         ws.DUAL_BLOCK_ROWS, a[10], a[11])[4]
                    for stream, depth, act in (("main", a[0], a[8]),
                                               ("edge", a[1], a[9]))}
            else:
                r["counts"][bm] = sweep_stream(a[0], *a[2:6], a[8],
                                               ws.BLOCK_ROWS, a[6], a[7])[4]

            def run(a=a, fn=launch[tag]):
                fn(*a)
            if base is None:
                r["ms"][bm] = gpu_ms(run, 10)
                continue
            with libraries(base[0]):
                old = launch[tag](*a)
            new = launch[tag](*a)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(old, new)):
                raise RuntimeError(f"ablation {tag}, {bm} bitmap: the "
                                   f"baseline kernel and this one differ")
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                with libraries(base[0] if who == "old" else None):
                    times[who].append(gpu_ms(run, 10))
            r["ms"][bm], r["baseline_ms"][bm] = min(times["new"]), min(
                times["old"])
        log(f"[ablation] {tag}: ms per launch by bitmap {r['ms']}"
            + (f", baseline kernels {r['baseline_ms']} (bit-equal to "
               f"these on every bitmap)" if base else "")
            + f"; counts {r['counts']}")
    name = {"main": "disparity_sweep", "dual": "disparity_sweep_dual"}
    res["sass"] = {n: sass_counts(cuda_build.library_path(n))
                   for n in name.values()}
    if base:
        res["baseline_sass"] = {n: sass_counts(base[1][n])
                                for n in name.values()}
        res["baseline_ptxas"] = base[2]
    log(f"[ablation] SASS (whole functions): {res['sass']}"
        + (f"; baseline {res['baseline_sass']}; baseline ptxas "
           f"{res['baseline_ptxas']}" if base else ""))
    return res


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
    block-causal mask; and at the production chunk's shape in bfloat16,
    timed beside the same SDPA call (or its refusal, recorded)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

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
                # SDPA with the boolean (N, N) mask, PyTorch's own choice of
                # backend as in earlier runs; at the production length the
                # mask alone takes 7.9 GB, and the backend that would
                # materialise the scores (380 GB) is left out
                mask = ids[None, :] <= ids[:, None]
                choice = contextlib.nullcontext() if n == WAN_N else \
                    sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                                 SDPBackend.CUDNN_ATTENTION])
                try:
                    with choice:
                        r["library_ms"] = gpu_ms(
                            lambda: F.scaled_dot_product_attention(
                                q, k, v, attn_mask=mask, scale=sm),
                            5 if n == WAN_N else 2)
                except (RuntimeError, torch.OutOfMemoryError) as e:
                    r["library_ms"] = None
                    r["library_error"] = str(e).splitlines()[0][:300]
                    torch.cuda.empty_cache()
                del mask
                msg = (f"; kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
                       f" ms" + (f", SDPA with the boolean mask "
                                 f"{r['library_ms']:.3f} ms"
                                 if r["library_ms"] is not None else
                                 f", SDPA with the boolean mask refused: "
                                 f"{r['library_error']}")
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


def packed_work(valid, b, h, d, elem_bytes):
    """(bytes, bf16 tensor-core operations) packed attention needs on
    this validity vector: qkv (3 H heads) read once, out (H heads) written
    once, valid once; 4 D operations (QK^T and PV, multiply and add) per
    (real query, valid key) pair. Pad query rows are sliced off by the
    caller, so the least work leaves them out."""
    n, real = valid.numel(), int(valid.sum())
    return (4 * b * h * n * d * elem_bytes + 4 * n,
            4 * d * b * h * real * real)


def view_valid(views, dev):
    """DA3_L's validity vector: ``views`` sequences of 2305 real tokens,
    each padded to the ViT's multiple, back to back (one run of pads per
    view)."""
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import \
        attention_packed as apk

    n_tok = -(-DA3_TOKENS // apk.PAD_MULTIPLE) * apk.PAD_MULTIPLE
    return (torch.arange(n_tok, device=dev) < DA3_TOKENS).repeat(views)


def phase_kernels_packed(dev):
    """B4 against its plain version in float32 on the same inputs, at the
    two shapes a DA3_L window gives it: cross-view (1, 52 x 2368, 48, 64)
    and per-view (52, 2368, 48, 64), 2305 real tokens per view, in
    bfloat16 (the engine's type) and float32. Real query rows are held to
    ``error_ratio`` <= 1 (float32: 2e-5 absolute; bfloat16: 2**-8 of each
    value plus 2**-5 of the output's RMS); pad rows must be finite. In
    bfloat16 it is timed beside its plain version, SDPA on (B, H, N, D)
    views of the packed tensor with the key mask broadcast from
    (1, 1, 1, N), and SDPA unmasked on the real tokens only."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from metric_depth_video_toolbox_tpu_torch.ops import \
        attention_packed as apk

    h, d = DA3_HEADS, DA3_HEAD_DIM
    sm = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(4)
    res = {}
    for tag, b, views in (("cross_view", 1, DA3_VIEWS),
                          ("per_view", DA3_VIEWS, 1)):
        valid = view_valid(views, dev)
        n = valid.numel()
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv4 = torch.randn(b, n, 3 * h, d, generator=gen,
                               device=dev).to(dtype)
            out = apk.packed_flash_attention(qkv4, valid, h, sm)
            ref = apk.packed_flash_attention_plain(qkv4.float(), valid, h,
                                                   sm)
            torch.cuda.synchronize()
            r = {"max_abs_err": float((out[:, valid].float()
                                       - ref[:, valid]).abs().max()),
                 "error_ratio": apk.error_ratio(out[:, valid],
                                                ref[:, valid])}
            if not r["error_ratio"] <= 1 \
                    or not bool(torch.isfinite(out).all()):
                raise RuntimeError(
                    f"packed_flash_attention {tag} {name}: kernel vs plain "
                    f"max abs err {r['max_abs_err']}, error ratio "
                    f"{r['error_ratio']} (limit 1)")
            del ref, out
            msg = ""
            if dtype == torch.bfloat16:
                cross = tag == "cross_view"
                r["ms"] = gpu_ms(lambda: apk.packed_flash_attention(
                    qkv4, valid, h, sm), 3 if cross else 10)
                r["plain_ms"] = gpu_ms(
                    lambda: apk.packed_flash_attention_plain(
                        qkv4, valid, h, sm), 1)
                nbytes, ops = packed_work(valid, b, h, d, 2)
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, \
                    ops / BF16_TC_OPS_PER_S
                r.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=nbytes, ops=ops)
                # the library's call: q, k, v as strided (B, H, N, D) views
                q, k, v = qkv4.reshape(b, n, 3, h, d).permute(
                    2, 0, 3, 1, 4).unbind(0)
                mask = valid[None, None, None, :]
                # never the math backend: it would materialise the scores
                # (485 GB at the cross-view shape)
                with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                                  SDPBackend.CUDNN_ATTENTION]):
                    r["library_ms"] = gpu_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, scale=sm), 3)
                qr, kr, vr = (t[:, :, valid] for t in (q, k, v))
                with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                  SDPBackend.CUDNN_ATTENTION,
                                  SDPBackend.EFFICIENT_ATTENTION]):
                    r["library_unmasked_ms"] = gpu_ms(
                        lambda: F.scaled_dot_product_attention(
                            qr, kr, vr, scale=sm), 3)
                del q, k, v, qr, kr, vr
                msg = (f"; kernel {r['ms']:.3f} ms, plain "
                       f"{r['plain_ms']:.3f} ms, SDPA with the key mask "
                       f"{r['library_ms']:.3f} ms, SDPA unmasked on the "
                       f"real tokens {r['library_unmasked_ms']:.3f} ms, "
                       f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}: "
                       f"{ops / 1e12:.3f} TFLOP bf16, "
                       f"{nbytes / 1e6:.1f} MB)")
            del qkv4
            res[f"{tag}_{name}"] = r
            log(f"[kernels] packed_flash_attention {tag} ({b}, {n}, "
                f"{3 * h}, {d}) {name}, {views} x {DA3_TOKENS} real tokens: "
                f"kernel vs plain (float32) max abs err "
                f"{r['max_abs_err']:.3e}, error ratio {r['error_ratio']:.3f}"
                f" (limit 1), pad rows finite{msg}")
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


def phase_stereo_fused(gen, dev):
    """The batch-8 1080p movie-configuration step on the synthetic scene
    with ``fused_anchor_sweep``, timed in turns with the two-call step on
    the same inputs. -> (fused frames/s, two-call frames/s, fused batches
    run)"""
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    depth, color = synth_scene(BATCH, gen, dev)
    args = stereo_inputs(codec.encode_depth_frame(depth, 100.0), color)
    cfgs = {"fused": movie_config(H, W, fused_anchor_sweep=True),
            "two-call": movie_config(H, W)}
    out = {k: stereo.stereo_step(cfg, *args) for k, cfg in cfgs.items()}
    img, mask = out["fused"]["image"], out["fused"]["infill_mask"]
    if img.shape != (BATCH, H, 2 * W, 3) or mask.shape != img.shape:
        raise RuntimeError(f"fused stereo: image {img.shape}, mask "
                           f"{mask.shape}")
    hole = out["two-call"]["infill_mask"].max(-1) > 0
    same = (img == out["two-call"]["image"]).all(-1)
    # outside the two-call step's holes both routes render the main
    # surface, equal up to the bitmaps' tile size: a blend of a valid and
    # a culled depth can hit a plane that the single sweep's 64-row tile
    # keeps active and the fused sweep's 32-row tile does not
    share = float(same[~hole].mean())
    if not share > 0.95 or not 0.0 < float(hole.mean()) < 0.5:
        raise RuntimeError(f"fused stereo: {share:.4f} of the pixels "
                           f"outside holes equal the two-call step's "
                           f"(hole share {float(hole.mean()):.4f})")
    runs, secs, batches = 4, {k: [] for k in cfgs}, 1
    for k in ("two-call", "fused", "fused", "two-call"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            stereo.stereo_step(cfgs[k], *args)
        secs[k].append(time.perf_counter() - t0)
        batches += runs * (k == "fused")
    fps = {k: runs * BATCH / min(v) for k, v in secs.items()}
    log(f"[stereo] fused anchor sweep, synthetic scene, {runs} batches of "
        f"{BATCH} at 1080p, in turns with the two-call step: fused "
        f"{fps['fused']:.3f} frames/s, two-call {fps['two-call']:.3f} "
        f"frames/s (best of 2 turns each; seconds per turn {secs}); "
        f"{share:.5f} of the pixels outside holes equal")
    return fps["fused"], fps["two-call"], batches


def da3_config(impl):
    import dataclasses

    from metric_depth_video_toolbox_tpu_torch.models import da3

    return dataclasses.replace(da3.DA3_L, vit=dataclasses.replace(
        da3.DA3_L.vit, attention_impl=impl))


def run_da3(eng, frames, what):
    """One timed ``infer_video`` -> (depth, c2w, xfov, seconds, peak GiB);
    fails on a wrong shape, a value that is not finite or a depth outside
    [0, max_depth]."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth, c2w, xfov = eng.infer_video(frames)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(frames)
    if depth.shape != (n, H, W) or c2w.shape != (n, 4, 4) \
            or xfov.shape != (n,):
        raise RuntimeError(f"da3 {what}: shapes {depth.shape}, {c2w.shape}, "
                           f"{xfov.shape}")
    if not (np.isfinite(depth).all() and np.isfinite(c2w).all()
            and np.isfinite(xfov).all()):
        raise RuntimeError(f"da3 {what}: depth, c2w or xfov not finite")
    if depth.min() < 0 or depth.max() > eng.cfg.max_depth \
            or not depth.max() > 0:
        raise RuntimeError(f"da3 {what}: depth {depth.min()}..{depth.max()} "
                           f"outside (0, max_depth]")
    if not ((xfov > 0) & (xfov < 180)).all():
        raise RuntimeError(f"da3 {what}: xfov {xfov.min()}..{xfov.max()}")
    return depth, c2w, xfov, dt, peak


def phase_da3(dev, zero_counts, counts):
    """DA3_L, bfloat16, on a synthetic 46-frame 1080p clip (two windows of
    52 views at 504 x 896): first through B4 (``flash_packed``), then the
    same weights through the default attention, and the two compared.
    -> (results, the flash_packed engine, the clip)"""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import da3

    gen = torch.Generator(device=dev).manual_seed(6)
    _, frames = synth_scene(DA3_FRAMES, gen, dev, shift_px=6)
    frames = frames.cpu().numpy()
    t0 = time.perf_counter()
    eng = da3.DA3Engine(cfg=da3_config("flash_packed"), device=dev,
                        rng_seed=0)
    work = eng._work_hw(H, W)
    model = eng.model(work)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[da3] DA3_L at {work[0]}x{work[1]}: {n_params / 1e6:.1f} M "
        f"parameters drawn and moved in {time.perf_counter() - t0:.3f} s")
    sdpa = da3.DA3Engine(cfg=da3_config("xla"), device=dev,
                         params=model.state_dict())
    res = {}
    # the first run of each route pays cuDNN's algorithm search and the
    # allocator's growth; the second is the measured one
    for name, e in (("flash_packed", eng), ("sdpa", sdpa)):
        run_da3(e, frames, f"{name} warm-up")
        zero_counts()
        depth, c2w, xfov, dt, peak = run_da3(e, frames, name)
        launched = counts()
        res[name] = {"depth": depth, "c2w": c2w, "xfov": xfov, "s": dt,
                     "fps": DA3_FRAMES / dt, "peak_gib": peak,
                     "launches": launched}
        log(f"[da3] DA3_L 504 bf16 {name}, {DA3_FRAMES} frames 1080p (2 "
            f"windows of {DA3_VIEWS} views, {DA3_TOKENS} tokens per view): "
            f"{dt:.3f} s, {DA3_FRAMES / dt:.3f} frames/s; depth "
            f"{depth.min():.3f}..{depth.max():.3f} m (mean "
            f"{depth.mean():.3f}), xfov {xfov.min():.2f}..{xfov.max():.2f} "
            f"deg; peak device memory {peak:.2f} GiB; launches {launched}")
    want = {"packed_flash_attention": 2 * DA3_BLOCKS}
    got = res["flash_packed"]["launches"]
    if {k: v for k, v in got.items() if v} != want:
        raise RuntimeError(f"da3 path: launches {got}, expected {want} (2 "
                           f"windows x {DA3_BLOCKS} blocks) and no other "
                           f"kernel")
    if any(res["sdpa"]["launches"].values()):
        raise RuntimeError(f"da3 default route launched a kernel of this "
                           f"repository: {res['sdpa']['launches']}")
    log(f"[main path] da3: packed_flash_attention launches: "
        f"{got['packed_flash_attention']} = 2 windows x ({DA3_BLOCKS // 2} "
        f"per-view + {DA3_BLOCKS // 2} cross-view blocks)")
    # the two routes differ in where bf16 rounds inside attention only
    a, b = res["flash_packed"], res["sdpa"]
    scale = float(b["depth"].max())
    d_max = float(np.abs(a["depth"] - b["depth"]).max()) / scale
    d_mean = float(np.abs(a["depth"] - b["depth"]).mean()) / scale
    fov = float(np.abs(a["xfov"] - b["xfov"]).max())
    rot = float(np.abs(a["c2w"][:, :3, :3] - b["c2w"][:, :3, :3]).max())
    log(f"[da3] flash_packed vs sdpa, same weights and clip: depth max "
        f"abs diff {d_max:.3e} and mean abs diff {d_mean:.3e} of the "
        f"largest depth (limits {DA3_ROUTE_MAX}, {DA3_ROUTE_MEAN}); xfov "
        f"max diff {fov:.3e} deg, c2w rotation max diff {rot:.3e} (not "
        f"limited: the SVD of random weights' ray maps amplifies)")
    if d_max > DA3_ROUTE_MAX or d_mean > DA3_ROUTE_MEAN:
        raise RuntimeError("da3: the two attention routes disagree")
    for r in res.values():
        del r["depth"], r["c2w"], r["xfov"]
    return res, eng, frames


def phase_movie(dev, zero_counts, expect_counts, card):
    """``mdvt-torch movie`` file to file at its defaults on a synthetic
    1080p clip of two 40-frame scenes (the second with its channels
    reversed: a hard cut for the scene detector). -> (source frames/s,
    each step's wall time in s, disparity-sweep launches)"""
    try:
        import cv2  # noqa: F401 - the movie's file I/O needs it
    except ImportError as e:
        raise RuntimeError("movie: OpenCV (cv2) is not installed; the "
                           "movie path reads and writes video files") from e
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.io import mkv, sidecar
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie, scenes

    # the first stereo batch's main and anchor sweeps, kept (arguments and
    # results, copied) as the run makes them, for the plain version after
    launch = ws.disparity_sweep
    held = []

    def keep(*args):
        copy = (tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                if len(held) < 2 else None)
        out = launch(*args)
        if copy is not None:
            held.append(copy + (tuple(o.clone() for o in out),))
        return out

    n = MOVIE_SCENE_FRAMES
    gen = torch.Generator(device=dev).manual_seed(11)
    _, first = synth_scene(n, gen, dev, shift_px=6)
    _, second = synth_scene(n, gen, dev, shift_px=-4)
    frames = torch.cat([first, second.flip(-1)]).cpu().numpy()
    del first, second
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "movie.mkv")
        vio.save_rgb_video(frames, clip, 24)
        zero_counts()
        ws.disparity_sweep = keep
        try:
            t0 = time.perf_counter()
            cli.main(["movie", "--color_video", clip, "--xfov", "60"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ws.disparity_sweep = launch
        steps = dict(movie.STEP_SECONDS)
        batches = 2 * -(-n // MOVIE_BATCH)
        expect_counts("movie", {"disparity_sweep": 2 * batches},
                      f"2 scenes x {batches // 2} stereo batches of up to "
                      f"{MOVIE_BATCH} frames x 2 eyes, main + anchor sweep "
                      f"per batch")
        sweeps = {}
        for tag, call in zip(("main", "anchor"), held):
            args, out = call[:-1], call[-1]
            if args[0].shape[0] != 2 * MOVIE_BATCH:
                raise RuntimeError(f"movie: the first {tag} sweep has "
                                   f"{args[0].shape[0]} frame-eyes, "
                                   f"expected {2 * MOVIE_BATCH}")
            ref = ws.disparity_sweep_plain(*args)
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(out, ref)]
            err = max(float((out[0] - ref[0]).abs().max()),
                      float((out[1] - ref[1]).abs().max()))
            if not all(same):
                raise RuntimeError(f"movie: {tag} sweep of the first stereo "
                                   f"batch: kernel != plain (z, color, "
                                   f"found equal: {same}; max abs err "
                                   f"{err})")
            sweeps[tag] = {
                "shape": f"B={args[0].shape[0]} H={args[0].shape[1]} "
                         f"WP={args[0].shape[2]} P={args[6]} "
                         f"C={args[1].shape[1]}",
                "max_abs_err": err,
                "active_share": float(args[-1].float().mean())}
        if len(sweeps) != 2:
            raise RuntimeError(f"movie: {len(held)} sweeps kept, expected "
                               f"the first batch's main and anchor")
        del held[:]
        out_dir = os.path.join(tmp, "movie_3d")
        rows = scenes.read_scene_csv(os.path.join(out_dir,
                                                  "movie-Scenes.csv"))
        found = [(r["Start Frame"], r["Length (frames)"]) for r in rows]
        if found != [("0", str(n)), (str(n), str(n))]:
            raise RuntimeError(f"movie: scenes (start, length) {found}, "
                               f"expected two of {n} frames")
        for k in (1, 2):
            base = os.path.join(out_dir, f"scene_{k}.mkv")
            for suffix in ("", "_depth.mkv", "_mask.mkv",
                           "_depth.mkv_convergence_depths.json",
                           "_depth.mkv_stereo.mkv",
                           "_depth.mkv_stereo.mkv_infillmask.mkv",
                           "_depth.mkv_stereo.mkv_infilled.mkv"):
                if not os.path.isfile(base + suffix):
                    raise RuntimeError(f"movie: {base + suffix} missing")
            conv = sidecar.load_convergence_depths(
                base + "_depth.mkv_convergence_depths.json")
            if conv.shape != (n,) or np.isinf(conv).any():
                raise RuntimeError(f"movie: scene {k} convergence depths "
                                   f"{conv.shape}, {conv[:4]}")
        final = os.path.join(tmp, "movie_SBS.mkv")
        count, width, height, _ = vio.video_info(final)
        mode = mkv.get_stereo_mode(final)
        if ((count, width, height) != (2 * n, 2 * W, H)
                or mode != mkv.STEREO_SBS_LEFT_FIRST):
            raise RuntimeError(f"movie: {final}: {count} frames of "
                               f"{width}x{height}, StereoMode {mode}")
        # what the host's codec and the pure-Python tag take of step 7:
        # the final movie's FFV1 decode, and its StereoMode rewrite again
        t0 = time.perf_counter()
        with vio.VideoReader(final) as r:
            decoded = sum(1 for _ in r)
        t_decode = time.perf_counter() - t0
        t0 = time.perf_counter()
        mkv.set_stereo_mode(final, mkv.STEREO_SBS_LEFT_FIRST)
        t_tag = time.perf_counter() - t0
        with vio.VideoReader(final) as r:
            last = r.read_frame(2 * n - 1)
        if decoded != 2 * n or mkv.get_stereo_mode(final) != mode:
            raise RuntimeError(f"movie: {decoded} frames decoded after the "
                               f"tag's rewrite")
        sbs = os.path.join(out_dir, "scene_2.mkv_depth.mkv_stereo.mkv")
        with vio.VideoReader(sbs) as r:
            unfilled = r.read_frame(n - 1)
        filled = float(np.any(last != unfilled, axis=-1).mean())
        diffusion = movie_diffusion_resume(clip, out_dir, final, n, dev,
                                           zero_counts, expect_counts)
    fps = 2 * n / wall
    log("[movie] steps, wall s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()))
    log(f"[movie] 2 scenes x {n} frames {W}x{H} -> {2 * n} frames of "
        f"{2 * W}x{H}, StereoMode {mode}: {wall:.3f} s, {fps:.3f} source "
        f"frames/s; share of the last frame the infill changed "
        f"{filled:.4f}; the final movie's decode {t_decode:.3f} s and its "
        f"StereoMode rewrite {t_tag:.3f} s, timed after the run")
    log("[movie] the first stereo batch's sweeps on the movie's depth, "
        "kernel == plain bit for bit: " + "; ".join(
            f"{k} {v['shape']} (active tiles {v['active_share']:.4f})"
            for k, v in sweeps.items()))
    log(f"[movie] ({card}) --infill_engine diffusion, a resume of the run "
        f"above (steps 6-7 only): {diffusion}")
    return fps, steps, 2 * batches, sweeps, diffusion


def movie_diffusion_resume(clip, out_dir, final, n, dev, zero_counts,
                           expect_counts):
    """The movie's ``--infill_engine diffusion`` as a resume: each scene's
    infilled output and the final movie deleted, ``mdvt-torch movie`` run
    again on the same directory, so steps 1-5 keep their files and step 6
    runs the JAX package's default diffusion engine (DIFFUSION_TINY at 256
    x 256, one per scene). -> its numbers"""
    import torch

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.io import mkv
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import diffusion as dif
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as idf
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie

    for k in (1, 2):
        os.remove(os.path.join(
            out_dir, f"scene_{k}.mkv_depth.mkv_stereo.mkv_infilled.mkv"))
    os.remove(final)
    built = []
    engine = idf.DiffusionInfillEngine

    def spy(**kw):
        built.append(engine(**kw))
        return built[-1]
    zero_counts()
    idf.DiffusionInfillEngine = spy
    try:
        t0 = time.perf_counter()
        cli.main(["movie", "--color_video", clip, "--xfov", "60",
                  "--infill_engine", "diffusion"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        idf.DiffusionInfillEngine = engine
    expect_counts("movie --infill_engine diffusion (resume)", {},
                  "0 disparity-sweep launches: steps 1-5 keep their files, "
                  "so no stereo batch runs; the diffusion infill has no "
                  "hand-written kernel")
    engines = [(e.cfg, e.work_hw, e.chunk, e.overlap) for e in built]
    if engines != [(dif.DIFFUSION_TINY, (256, 256), 25, 6)] * 2:
        raise RuntimeError(f"movie diffusion: engines {engines}, expected "
                           f"DIFFUSION_TINY at 256x256, one per scene")
    count, width, height, _ = vio.video_info(final)
    mode = mkv.get_stereo_mode(final)
    if ((count, width, height) != (2 * n, 2 * W, H)
            or mode != mkv.STEREO_SBS_LEFT_FIRST):
        raise RuntimeError(f"movie diffusion: {final}: {count} frames of "
                           f"{width}x{height}, StereoMode {mode}")
    return {"wall_s": wall, "frames": count, "width": width,
            "stereo_mode": mode, "disparity_sweep_launches": 0,
            "steps_s": dict(movie.STEP_SECONDS)}


SVD_FRAMES = 25                # svd_infill (c): one 25-frame chunk per eye


def halo_reach(mask_rgb, dev):
    """(T, H, W) bool: the pixels the halo blend may change (the lower
    side of each edge, dilated 5 x 5 as the blend does, then by the 7 x 7
    blur's reach)."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import image as im
    from metric_depth_video_toolbox_tpu_torch.ops import infill as iops

    out = []
    for s in range(0, mask_rgb.shape[0], 8):
        lower = iops.mark_lower_side(torch.as_tensor(mask_rgb[s:s + 8],
                                                     device=dev))
        band = im.dilate((lower[..., 2] == 255).float(), ksize=5)
        out.append((im.dilate(band, ksize=7) > 0).cpu().numpy())
    return np.concatenate(out)


def profile_chunk(tag, eng, chunk, card):
    """One chunk of ``eng`` timed unprofiled, then under torch.profiler:
    -> (ms, device busy share); logs the top device operations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.infill_chunk(*chunk)
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.infill_chunk(*chunk)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.key.startswith("infill.")]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[svd_infill] ({card}) {tag}: one chunk of {chunk[0].shape[0]} "
        f"frames {wall:.3f} ms unprofiled, device busy {busy:.3f} ms "
        f"({busy / wall:.1%}); top device operations:")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        ms = e.self_device_time_total / 1e3
        log(f"[svd_infill]   {ms:9.3f} ms {ms / max(busy, 1e-9):6.1%} "
            f"x{e.count:<5d} {e.key[:100]}")
    kinds = {}
    for e in events:
        k = kind_of(e.key)
        kinds[k] = kinds.get(k, 0.0) + e.self_device_time_total / 1e3
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        log(f"[svd_infill]   by kind: {ms:9.3f} ms "
            f"{ms / max(busy, 1e-9):6.1%} {k}")
    return wall, busy / wall


def phase_svd_infill(sbs, sbs_mask, frames, dev, zero_counts, expect_counts,
                     card):
    """``mdvt-torch infill`` through cli/main.py with the SVD-class engines
    on the phase-4 SBS frames and infill mask, as files: (a) ``diffusion``
    at its defaults (DIFFUSION_SVD, 768 x 1024, chunks of 25 overlapping by
    6, the left eye mirrored, the halo blend on); (b) ``m2svid`` at 512 x
    512 with the phase-3 clip as the mono conditioning, no halo; (c)
    ``--model_scale svd`` (SVDConfig and SVDVAEConfig, bfloat16) on the
    first 25 frames. Counts zeroed before each run and read after: no
    hand-written kernel runs (attention is SDPA). -> {run: numbers}"""
    try:
        import cv2  # noqa: F401 - the CLI reads and writes video files
    except ImportError as e:
        raise RuntimeError("svd_infill: OpenCV (cv2) is not installed; the "
                           "infill CLI reads and writes video files") from e
    import gc

    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import diffusion as dif
    from metric_depth_video_toolbox_tpu_torch.models import svd
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as idf

    n = sbs.shape[0]
    hole = np.any(sbs_mask != 0, axis=-1)
    reach = halo_reach(sbs_mask, dev)
    runs = (
        ("a production", ["--infill_engine", "diffusion"], n,
         dif.DIFFUSION_SVD, (768, 1024), True),
        ("b m2svid", ["--infill_engine", "m2svid", "--color_video", None],
         n, dif.DIFFUSION_SVD, (512, 512), False),
        ("c svd", ["--infill_engine", "diffusion", "--model_scale", "svd",
                   "--max_frames", str(SVD_FRAMES)], SVD_FRAMES,
         svd.SVDConfig(), (768, 1024), True))
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "sbs.mkv")
        mono = os.path.join(tmp, "mono.mkv")
        t0 = time.perf_counter()
        vio.save_rgb_video(sbs, src, 24)
        vio.save_rgb_video(sbs_mask, src + "_infillmask.mkv", 24)
        vio.save_rgb_video(frames, mono, 24)
        log(f"[svd_infill] ({card}) inputs written ({n} SBS frames "
            f"{2 * W}x{H}, mask, mono clip): "
            f"{time.perf_counter() - t0:.3f} s")
        for tag, argv, t, cfg, work, halo in runs:
            argv = [mono if a is None else a for a in argv]
            built, finite = [], []
            make = idf.make_engine

            def capture(*a, **kw):
                eng, drv = make(*a, **kw)
                eng.on_latents = lambda z: finite.append(
                    bool(torch.isfinite(z).all()))
                built.append(eng)
                return eng, drv
            out = src + "_infilled.mkv"
            if os.path.exists(out):
                os.remove(out)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2**30
            zero_counts()
            idf.make_engine = capture
            try:
                t0 = time.perf_counter()
                cli.main(["infill", "--sbs_color_video", src] + argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                idf.make_engine = make
            peak = torch.cuda.max_memory_allocated() / 2**30
            expect_counts(f"svd_infill {tag}", {},
                          "no hand-written kernel on the SVD-class infill: "
                          "its attention is SDPA")
            (eng,) = built
            if eng.cfg != cfg or eng.work_hw != work:
                raise RuntimeError(f"svd_infill {tag}: engine {eng.cfg} at "
                                   f"{eng.work_hw}")
            chunks = 2 * (1 + -(-max(t - eng.chunk, 0)
                                // (eng.chunk - eng.overlap)))
            if finite != [True] * chunks:
                raise RuntimeError(f"svd_infill {tag}: latents finite per "
                                   f"chunk {finite}, expected {chunks}")
            with vio.VideoReader(out) as r:
                got = r.read_all()
            if got.shape != (t, H, 2 * W, 3) or got.dtype != np.uint8:
                raise RuntimeError(f"svd_infill {tag}: output {got.shape} "
                                   f"{got.dtype}")
            # the first overlap/2 frames of each later chunk are the last
            # chunk's last frames, as context (the JAX package's loop: a
            # frame s + j of the chunk at s takes s + overlap - n_ctx + j)
            ctx = {}
            n_ctx = eng.overlap // 2
            for s in range(eng.chunk - eng.overlap, t - eng.overlap,
                           eng.chunk - eng.overlap):
                ctx.update({s + j: s + eng.overlap - n_ctx + j
                            for j in range(n_ctx)})
            keep = ~hole[:t]
            if halo:
                keep &= ~reach[:t]
            source = np.array([ctx.get(i, i) for i in range(t)])
            keep &= ~hole[source]
            if not np.array_equal(got[keep], sbs[source][keep]):
                raise RuntimeError(f"svd_infill {tag}: pixels outside the "
                                   f"holes{' and the halo band' * halo} "
                                   f"changed")
            changed = float((got[hole[:t]] != sbs[:t][hole[:t]]).any(
                -1).mean())
            if not changed > 0.5:
                raise RuntimeError(f"svd_infill {tag}: only {changed:.3f} "
                                   f"of hole pixels changed")
            params = eng.num_parameters()
            log(f"[svd_infill] ({card}) {tag}: {type(eng.model).__name__} "
                f"{params} parameters, {eng.cfg.dtype}, {t} SBS frames "
                f"{2 * W}x{H} -> {work[0]}x{work[1]} in {chunks} chunks of "
                f"{eng.chunk} (overlap {eng.overlap}), halo blend {halo}: "
                f"{wall:.3f} s wall through the CLI (weights drawn, files "
                f"read and written), {t / wall:.3f} SBS frames/s; peak "
                f"device memory {peak:.2f} GiB, {peak - held:.2f} GiB over "
                f"the {held:.2f} GiB the earlier phases hold; {changed:.4f} "
                f"of hole pixels "
                f"changed, the rest unchanged (context frames "
                f"{sorted(ctx)} hold their source frames)")
            eye = (np.ascontiguousarray(sbs[:eng.chunk, :, W:]),
                   hole[:eng.chunk, :, W:],
                   frames[:eng.chunk] if eng.mono_conditioning else None)
            eng.on_latents = None
            chunk_ms, busy = profile_chunk(tag, eng, eye, card)
            results[tag.split()[1]] = {
                "parameters": params, "wall_s": wall, "sbs_fps": t / wall,
                "peak_gib": peak, "peak_over_held_gib": peak - held,
                "chunk_ms": chunk_ms, "busy_share": busy,
                "frames": t, "chunks": chunks}
            del built[:], eng
    gc.collect()
    torch.cuda.empty_cache()
    return results


def phase_reference_svd_infill(dev, card):
    """DiffusionInfillEngine.infill_chunk in float32 on the same weights
    and noise on the card and on the CPU: DIFFUSION_TINY with mono
    conditioning, and SVD_TINY with a CLIP_TINY context. Latents within
    1e-4 of their largest value, uint8 within 1 LSB on at most 0.5% of
    bytes, the pixels outside the holes unchanged."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import clip, diffusion
    from metric_depth_video_toolbox_tpu_torch.models import svd
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as idf

    rng = np.random.default_rng(13)
    frames = rng.integers(0, 256, (5, 90, 160, 3), np.uint8)
    hole = np.zeros((5, 90, 160), bool)
    hole[:, 20:60, 30:90] = True
    mono = rng.integers(0, 256, (5, 90, 160, 3), np.uint8)
    tower = diffusion.init_weights(clip.CLIPVisionTower(clip.CLIP_TINY),
                                   torch.Generator().manual_seed(2))
    for name, kw in (("DIFFUSION_TINY + mono", dict(mono_conditioning=True)),
                     ("SVD_TINY + CLIP_TINY", dict(
                         cfg=svd.SVD_TINY, vae_cfg=svd.SVD_VAE_TINY,
                         clip_cfg=clip.CLIP_TINY,
                         clip_params=tower.state_dict()))):
        kw.update(work_hw=(64, 96), chunk=5)
        cpu = idf.DiffusionInfillEngine(device="cpu", **kw)
        cpu._ensure()
        on_card = idf.DiffusionInfillEngine(device=dev, params=cpu.model
                                            .state_dict(), **kw)
        with torch.no_grad():
            lat = cpu.model.encode(torch.zeros((5, 64, 96, 3))).shape
        noise = torch.randn(lat, generator=torch.Generator().manual_seed(3))
        z, out = {}, {}
        for where, eng in (("cpu", cpu), ("card", on_card)):
            eng.on_latents = lambda v, where=where: z.setdefault(where,
                                                                 v.cpu())
            out[where] = eng.infill_chunk(frames, hole, mono, noise=noise)
        err = float((z["card"] - z["cpu"]).abs().max()
                    / z["cpu"].abs().max())
        d = np.abs(out["card"].astype(int) - out["cpu"].astype(int))
        share = float((d > 0).mean())
        log(f"[reference] ({card}) {name} infill chunk f32, 5 frames "
            f"90x160 -> "
            f"64x96, card vs CPU: latents max err {err:.3e} of the largest "
            f"(limit 1e-4), uint8 max {int(d.max())} LSB on {share:.5f} of "
            f"bytes (limit 1 LSB on 0.5%)")
        if (err > 1e-4 or d.max() > 1 or share > 0.005
                or not np.array_equal(out["card"][~hole], frames[~hole])):
            raise RuntimeError(f"reference: the card's {name} infill "
                               f"disagrees with the CPU's")


def phase_reference_movie(dev):
    """U²-Net SEG_TINY (seeded weights) and the basic infill on the card
    and on the CPU in float32, at a small size."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import segmentation
    from metric_depth_video_toolbox_tpu_torch.ops import infill as iops
    from metric_depth_video_toolbox_tpu_torch.pipeline import infill_video
    from metric_depth_video_toolbox_tpu_torch.pipeline import masks

    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, (4, 90, 160, 3), np.uint8)
    p, m = {}, {}
    for where in ("cpu", dev):
        eng = masks.MaskEngine(cfg=segmentation.SEG_TINY, work=64,
                               device=where)
        p[where] = eng.probabilities(frames).cpu().numpy()
        m[where] = eng.masks_for(frames)
    p_err = float(np.abs(p[dev] - p["cpu"]).max())
    flips = m[dev] != m["cpu"]
    flip_near = float(np.abs(p["cpu"][flips] - 0.5).max()) if flips.any() \
        else 0.0
    sbs = torch.from_numpy(rng.integers(0, 256, (3, 120, 320, 3), np.uint8))
    mask = rng.integers(0, 256, (3, 120, 320, 3), np.uint8)
    mask[rng.random((3, 120, 320)) < 0.8] = 0
    mask[:, 30:60, 100:130] = (0, 255, 0)           # green-coded holes
    mask = torch.from_numpy(mask)
    hole = mask.ne(0).any(-1)
    normals = mask.float() / 255.0 * 2.0 - 1.0
    march = {where: iops.normal_march_infill(
        sbs.to(where), hole.to(where), normals.to(where)).cpu()
        for where in ("cpu", dev)}
    out = {where: infill_video.basic_infill_frame(
        sbs.to(where), mask.to(where)).cpu() for where in ("cpu", dev)}
    code = int((out[dev].int() - out["cpu"].int()).abs().max())
    equal = bool(torch.equal(march[dev], march["cpu"]))
    log(f"[reference] U²-Net SEG_TINY fp32 4x90x160, card vs CPU: "
        f"probability max err {p_err:.3e} (limit 1e-4), {int(flips.sum())} "
        f"mask pixels differ, at most {flip_near:.3e} from the threshold "
        f"(limit 1e-3); basic infill 3x120x320: march bit-equal {equal}, "
        f"blurred output max {code} code (limit 1)")
    if p_err > 1e-4 or flip_near >= 1e-3 or not equal or code > 1:
        raise RuntimeError("reference: masks or basic infill disagree "
                           "between the card and the CPU")


def phase_reference_da3(dev):
    """A narrow DA3 (DA3_TINY widths, float32, flash_packed, windows of 4
    + 2 + 3) on the card (kernel B4, head dim 16, float32) against the
    same weights on the CPU (plain version)."""
    import dataclasses

    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import da3

    cfg = dataclasses.replace(
        da3.DA3_TINY,
        vit=dataclasses.replace(da3.DA3_TINY.vit, dtype="float32",
                                attention_impl="flash_packed"),
        dpt=dataclasses.replace(da3.DA3_TINY.dpt, dtype="float32"))
    gen = torch.Generator().manual_seed(7)
    _, frames = synth_scene(9, gen, "cpu", h=96, w=128, shift_px=2)
    frames = frames.numpy()
    kw = dict(cfg=cfg, images_per_batch=4, overlap=3, num_ref_frames=2,
              resolution=84)
    cpu = da3.DA3Engine(device="cpu", **kw)
    card = da3.DA3Engine(device=dev, params=cpu.model(
        cpu._work_hw(96, 128)).state_dict(), **kw)
    want, got = cpu.infer_video(frames), card.infer_video(frames)
    scale = float(np.abs(want[0]).max())
    d = float(np.abs(got[0] - want[0]).max()) / scale
    rot = float(np.abs(got[1][:, :3, :3] - want[1][:, :3, :3]).max())
    trans = float(np.abs(got[1][:, :3, 3] - want[1][:, :3, 3]).max()
                  / max(np.abs(want[1][:, :3, 3]).max(), 1e-6))
    fov = float(np.abs(got[2] - want[2]).max())
    log(f"[reference] narrow DA3 (DA3_TINY widths, f32, flash_packed), 9 "
        f"frames 96x128 -> 84x112, 6 windows of 9 views, card vs CPU: "
        f"depth max err {d:.3e} of its largest value, c2w rotation "
        f"{rot:.3e}, translation {trans:.3e} of its largest, xfov "
        f"{fov:.3e} deg (limits 1e-3, 1e-3, 1e-3, 1e-2); depth up to "
        f"{scale:.3f}")
    if d > 1e-3 or rot > 1e-3 or trans > 1e-3 or fov > 1e-2:
        raise RuntimeError("reference: the card's DA3 disagrees with the "
                           "CPU's")


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


# device kernels of the infill and of DA3 by kind, by substrings of their
# names (the first kind that matches; cuDNN's convolutions are implicit
# GEMMs)
KINDS = (("B3 block-causal attention", ("causalmask", "bc_attn")),
         ("B4 packed attention", ("packedmask", "packed_attn")),
         ("library attention (SDPA)", ("flash", "fmha", "sdpa")),
         ("convolution", ("conv", "fprop", "dgrad", "winograd")),
         ("GEMM (dense layers)", ("gemm", "nvjet", "cutlass")),
         ("copies", ("memcpy", "memset")))


def kind_of(key):
    low = key.lower()
    for kind, subs in KINDS:
        if any(sub in low for sub in subs):
            return kind
    return "other (elementwise, norms, softmax, FFT, ...)"


def phase_profile(metric, frames, infill, da3, sbs, sbs_mask, dev):
    """Where the time goes: the stereo step (device only, then with the
    uint8 results copied to the host), the depth engine, one eye's infill
    chunk, the DA3 clip (two windows), one 16-frame batch of U²-Net
    SEG_FULL masks at 1080p and one 4-frame batch of the basic infill on
    the phase-4 SBS frames (3840x1080), each under torch.profiler; the
    kernels with the most device time, and for the infill and DA3 the
    device time by kind."""
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
    da3_eng, da3_frames, t_da3 = da3
    from metric_depth_video_toolbox_tpu_torch.pipeline import infill_video
    from metric_depth_video_toolbox_tpu_torch.pipeline import masks

    meng = masks.MaskEngine(device=dev)
    mask_frames = frames[:MOVIE_BATCH]
    meng.masks_for(mask_frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meng.masks_for(mask_frames)
    t_mask = time.perf_counter() - t0
    sbs4 = torch.as_tensor(sbs[:4], device=dev)
    mask4 = torch.as_tensor(sbs_mask[:4], device=dev)

    def basic_infill():
        return infill_video.basic_infill_frame(sbs4, mask4).cpu()
    basic_infill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    basic_infill()
    t_basic = time.perf_counter() - t0
    for name, fn, wall, reps in (
            ("stereo step", lambda: stereo.stereo_step(cfg, *args), t_host,
             2),
            ("depth engine (40 frames)", lambda: eng.infer_video(frames),
             t_depth, 2),
            (f"infill chunk (one eye, {INFILL_FRAMES} frames)",
             lambda: ieng.infill_chunk(*eye), t_infill, 1),
            (f"DA3_L flash_packed ({DA3_FRAMES} frames, 2 windows)",
             lambda: da3_eng.infer_video(da3_frames), t_da3, 1),
            (f"U²-Net SEG_FULL masks ({MOVIE_BATCH} frames 1080p, work "
             f"320, bf16, uint8 masks on the host)",
             lambda: meng.masks_for(mask_frames), t_mask, 2),
            (f"basic infill (4 SBS frames {2 * W}x{H}, uint8 on the host)",
             basic_infill, t_basic, 2)):
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
    except ImportError as e:
        raise RuntimeError("files: OpenCV (cv2) is not installed; the port's "
                           "file I/O needs it") from e
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

        # DA3 (its own copy of the clip: an existing depth video is kept),
        # then the fused stereo step on its depth video and FOV sidecar
        clip3 = os.path.join(tmp, "clip_da3.mkv")
        vio.save_rgb_video(frames.cpu().numpy(), clip3, 24)
        t0 = time.perf_counter()
        cli.main(["da3", "--color_video", clip3, "--model_size", "vitt",
                  "--da3_resolution", "252", "--images_per_batch", "8",
                  "--batch_overlap", "3", "--nr_of_ref_frames", "2"])
        dt_da3 = time.perf_counter() - t0
        depth3 = clip3 + "_depth.mkv"
        from metric_depth_video_toolbox_tpu_torch.io import sidecar
        xfovs = sidecar.load_xfovs(depth3 + "_xfovs.json")
        c2w = sidecar.load_transformations(depth3 + "_transformations.json")
        if xfovs.shape != (12,) or c2w.shape != (12, 4, 4):
            raise RuntimeError(f"files: da3 sidecars {xfovs.shape}, "
                               f"{c2w.shape}")
        t0 = time.perf_counter()
        cli.main(["stereo", "--depth_video", depth3, "--color_video", clip3,
                  "--xfov_file", depth3 + "_xfovs.json", "--infill_mask",
                  "--batch_size", "4", "--fused_anchor_sweep"])
        dt_fused = time.perf_counter() - t0
        for out in (depth3, depth3 + "_stereo.mkv",
                    depth3 + "_stereo.mkv_infillmask.mkv"):
            with vio.VideoReader(out) as r:
                n, w = r.frame_count, r.width
            if n != 12 or w != (480 if out == depth3 else 960):
                raise RuntimeError(f"files: {out} has {n} frames of width "
                                   f"{w}")
        log(f"[files] da3 (DA3_TINY at 252x448, windows of 8 + 2 + 3) file "
            f"to file with both sidecars: {dt_da3:.3f} s; stereo "
            f"--fused_anchor_sweep on its depth and xfovs: {dt_fused:.3f} s")


# ------------------------------------------------- phase: checkpoints ----

CKPT_SEED = 9
# the checkpoints phase's own cut: an infill of 16 SBS frames (one chunk
# per eye), a stereo run of one batch, a DA3 command on one window
CKPT_INFILL_FRAMES, CKPT_STEREO_FRAMES, CKPT_DA3_CLI_FRAMES = 16, 16, 16
# WAN_1_3B's round trip is cut to WAN_TINY when the script has run longer
# than this before the phase (the script aims at 900 s of its 1200)
CKPT_WAN_CUTOFF_S = 600.0
CHUNK_TEST_ELEMENTS = 2 ** 28 + 4097   # one float32 leaf over 2^30 bytes


def dinov2_shapes(prefix, d, depth, n_tokens, patch=14):
    """{name: shape} of an upstream DINOv2 state dict."""
    s = {f"{prefix}patch_embed.proj.weight": (d, 3, patch, patch),
         f"{prefix}patch_embed.proj.bias": (d,),
         f"{prefix}cls_token": (1, 1, d),
         f"{prefix}pos_embed": (1, n_tokens + 1, d),
         f"{prefix}norm.weight": (d,), f"{prefix}norm.bias": (d,)}
    for i in range(depth):
        b = f"{prefix}blocks.{i}."
        s.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                  b + "attn.qkv.weight": (3 * d, d),
                  b + "attn.qkv.bias": (3 * d,),
                  b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                  b + "ls1.gamma": (d,), b + "norm2.weight": (d,),
                  b + "norm2.bias": (d,), b + "mlp.fc1.weight": (4 * d, d),
                  b + "mlp.fc1.bias": (4 * d,),
                  b + "mlp.fc2.weight": (d, 4 * d), b + "mlp.fc2.bias": (d,),
                  b + "ls2.gamma": (d,)})
    return s


def vda_head_shapes(prefix, d, chans, feat):
    """{name: shape} of an upstream Video-Depth-Anything head: the DPT
    head's layout (projects, resize_layers, scratch) and four AnimateDiff
    motion modules."""
    s = {}
    for i, ch in enumerate(chans):
        s[f"{prefix}projects.{i}.weight"] = (ch, d, 1, 1)
        s[f"{prefix}projects.{i}.bias"] = (ch,)
        s[f"{prefix}scratch.layer{i + 1}_rn.weight"] = (feat, ch, 3, 3)
    for i, k in ((0, 4), (1, 2), (3, 3)):
        s[f"{prefix}resize_layers.{i}.weight"] = (chans[i], chans[i], k, k)
        s[f"{prefix}resize_layers.{i}.bias"] = (chans[i],)
    for rn in range(1, 5):
        r = f"{prefix}scratch.refinenet{rn}."
        for unit in (1, 2):
            for cv in (1, 2):
                s[f"{r}resConfUnit{unit}.conv{cv}.weight"] = (feat, feat, 3, 3)
                s[f"{r}resConfUnit{unit}.conv{cv}.bias"] = (feat,)
        s[r + "out_conv.weight"] = (feat, feat, 1, 1)
        s[r + "out_conv.bias"] = (feat,)
    sc = f"{prefix}scratch.output_conv"
    s.update({sc + "1.weight": (feat // 2, feat, 3, 3), sc + "1.bias":
              (feat // 2,), sc + "2.0.weight": (32, feat // 2, 3, 3),
              sc + "2.0.bias": (32,), sc + "2.2.weight": (1, 32, 1, 1),
              sc + "2.2.bias": (1,)})
    for i, dim in enumerate((chans[2], chans[3], feat, feat)):
        t = f"{prefix}motion_modules.{i}.temporal_transformer."
        s.update({t + "norm.weight": (dim,), t + "norm.bias": (dim,),
                  t + "proj_in.weight": (dim, dim), t + "proj_in.bias": (dim,),
                  t + "proj_out.weight": (dim, dim),
                  t + "proj_out.bias": (dim,)})
        b = t + "transformer_blocks.0."
        for k in range(2):
            a = f"{b}attention_blocks.{k}."
            s.update({a + "to_q.weight": (dim, dim),
                      a + "to_k.weight": (dim, dim),
                      a + "to_v.weight": (dim, dim),
                      a + "to_out.0.weight": (dim, dim),
                      a + "to_out.0.bias": (dim,),
                      f"{b}norms.{k}.weight": (dim,),
                      f"{b}norms.{k}.bias": (dim,)})
        s.update({b + "ff_norm.weight": (dim,), b + "ff_norm.bias": (dim,),
                  b + "ff.net.0.proj.weight": (8 * dim, dim),
                  b + "ff.net.0.proj.bias": (8 * dim,),
                  b + "ff.net.2.weight": (dim, 4 * dim),
                  b + "ff.net.2.bias": (dim,)})
    return s


def wan_shapes(cfg):
    """{name: shape} of an upstream Wan2.1-class DiT state dict (the
    layout of InSpatio-World-1.3B.safetensors)."""
    d, p = cfg.dim, cfg.patch_hw
    s = {"patch_embedding.weight": (d, cfg.z_ch + cfg.cond_ch, 1, p, p),
         "patch_embedding.bias": (d,),
         "text_embedding.0.weight": (d, cfg.text_dim),
         "text_embedding.0.bias": (d,), "text_embedding.2.weight": (d, d),
         "text_embedding.2.bias": (d,),
         "time_embedding.0.weight": (d, cfg.freq_dim),
         "time_embedding.0.bias": (d,), "time_embedding.2.weight": (d, d),
         "time_embedding.2.bias": (d,),
         "time_projection.1.weight": (6 * d, d),
         "time_projection.1.bias": (6 * d,),
         "head.head.weight": (p * p * cfg.z_ch, d),
         "head.head.bias": (p * p * cfg.z_ch,), "head.modulation": (1, 2, d)}
    for i in range(cfg.layers):
        b = f"blocks.{i}."
        for att in ("self_attn", "cross_attn"):
            for m in ("q", "k", "v", "o"):
                s[f"{b}{att}.{m}.weight"] = (d, d)
                s[f"{b}{att}.{m}.bias"] = (d,)
            # RMSNorm over each head's channels, as the models hold it
            s[f"{b}{att}.norm_q.weight"] = (d // cfg.heads,)
            s[f"{b}{att}.norm_k.weight"] = (d // cfg.heads,)
        s.update({b + "norm3.weight": (d,), b + "norm3.bias": (d,),
                  b + "ffn.0.weight": (cfg.ffn_dim, d),
                  b + "ffn.0.bias": (cfg.ffn_dim,),
                  b + "ffn.2.weight": (d, cfg.ffn_dim), b + "ffn.2.bias": (d,),
                  b + "modulation": (1, 6, d)})
    return s


def upstream_state_dict(shapes, gen, dev):
    """Seeded values for an upstream state dict, drawn on the card and kept
    on the host (float32): LeCun-normal matrices and kernels, norm weights
    near 1, layer scales 1, small biases, N(0, 0.02) embeddings and
    modulations."""
    import math

    import torch

    sd = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        x = torch.randn(shape, generator=gen, device=dev)
        if leaf == "weight" and len(shape) >= 2:
            x /= math.sqrt(math.prod(shape[1:]))
        elif leaf == "weight":
            x = 1.0 + 0.01 * x
        elif leaf == "gamma":
            x = torch.ones_like(x)
        elif leaf == "bias":
            x *= 0.01
        else:
            x *= 0.02
        sd[name] = x.cpu()
    return sd


def tree_leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from tree_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def same_bits_on_card(written, read, dev):
    """Every leaf of ``read`` equal to ``written``'s, bit for bit, compared
    on the card (bfloat16 leaves as int16). -> (leaves, bytes)"""
    import numpy as np
    import torch

    got = dict(tree_leaves(read))
    want = dict(tree_leaves(written))
    if sorted(got) != sorted(want):
        raise RuntimeError(f"checkpoints: read-back paths differ: "
                           f"{sorted(set(got) ^ set(want))[:6]}")
    nbytes = 0
    for path, w in want.items():
        g = got[path]
        ts = []
        for x in (w, g):
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.ascontiguousarray(x))
            ts.append(x.contiguous())
        if ts[0].dtype != ts[1].dtype or ts[0].shape != ts[1].shape:
            raise RuntimeError(f"checkpoints: {'/'.join(path)}: "
                               f"{ts[0].dtype}{tuple(ts[0].shape)} written, "
                               f"{ts[1].dtype}{tuple(ts[1].shape)} read")
        raw = [t.view(torch.int16 if t.element_size() == 2 else
                      torch.int32 if t.element_size() == 4 else
                      torch.uint8).to(dev) for t in ts]
        if not torch.equal(raw[0], raw[1]):
            raise RuntimeError(f"checkpoints: {'/'.join(path)} read back "
                               f"differs from what was written")
        nbytes += ts[0].numel() * ts[0].element_size()
    return len(want), nbytes


def phase_checkpoints(frames, sbs, sbs_mask, da3_frames, depth_fps, da3_fps,
                      dev, zero_counts, counts, card, t_script):
    """Converted checkpoints on the main paths, from files: upstream-layout
    state dicts drawn with a seeded ``torch.Generator`` and written with
    ``torch.save``, converted by ``convert_torch_file``, written by
    ``save_checkpoint`` (Flax's msgpack), read through the commands:
    (a) VDA-S at the phase-3 engine's widths and grid, ``mdvt-torch depth
    --checkpoint`` on the phase-3 clip, bit-equal to the same tree in
    memory, then ``mdvt-torch stereo`` (B1); (b) a DINOv2 ViT-L on the
    upstream 518 grid grafted into DA3_L, through ``mdvt-torch da3
    --backbone_checkpoint`` and, on the ``flash_packed`` route, in memory
    on the phase-6 clip (B4); (c) ``mdvt-torch infill --infill_engine
    inspatio_world --checkpoint`` with a ``{"dit", "enc", "dec"}`` tree at
    WAN_1_3B (B3); (d) every file read back and held bit for bit against
    what was written, on the card, and a file with leaves over 2^30 bytes
    (float32 and bfloat16) in Flax's chunked layout. -> numbers"""
    try:
        import cv2  # noqa: F401 - the commands read and write video files
    except ImportError as e:
        raise RuntimeError("checkpoints: OpenCV (cv2) is not installed; the "
                           "commands read and write video files") from e
    import gc

    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import convert
    from metric_depth_video_toolbox_tpu_torch.models import da3
    from metric_depth_video_toolbox_tpu_torch.models import depth_anything
    from metric_depth_video_toolbox_tpu_torch.models import from_jax
    from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
    from metric_depth_video_toolbox_tpu_torch.models import wan as wan_mod
    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as idf

    log(f"[checkpoints] ({card}) the script has run "
        f"{time.perf_counter() - t_script:.1f} s before the phase")
    gen = torch.Generator(device=dev).manual_seed(CKPT_SEED)
    res, written = {}, {}
    t_phase = time.perf_counter()

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    def to_file(tmp, name, sd, kind, cfg):
        """torch.save -> convert_torch_file -> save_checkpoint; the upstream
        file is deleted once converted. -> (path, tree, numbers)"""
        pth = os.path.join(tmp, name + ".pth")
        _, t_pth = timed(torch.save, sd, pth)
        tree, t_conv = timed(convert.convert_torch_file, pth, kind, cfg)
        os.remove(pth)
        path = os.path.join(tmp, name + ".msgpack")
        _, t_write = timed(convert.save_checkpoint, path, tree)
        written[path] = tree
        n = sum(int(np.prod(np.shape(v))) for _, v in tree_leaves(tree))
        return path, tree, {"parameters": n, "bytes": os.path.getsize(path),
                            "torch_save_s": t_pth, "convert_s": t_conv,
                            "write_s": t_write}

    with tempfile.TemporaryDirectory() as tmp:
        # (a) VDA-S: the widths and working grid of the phase-3 engine
        eng = dstage.VDAEngine(size="vits", device=dev)
        work = depth_anything.working_resolution(H, W, 518, 14)
        grid = (work[0] // 14, work[1] // 14)
        c = eng.cfg
        sd = upstream_state_dict(
            {**dinov2_shapes("pretrained.", c.vit.embed_dim, c.vit.depth,
                             grid[0] * grid[1]),
             **vda_head_shapes("head.", c.vit.embed_dim,
                               c.dpt.out_channels, c.dpt.features)},
            gen, dev)
        # a positive disparity before the head's last relu, as a trained
        # head gives
        sd["head.scratch.output_conv2.2.bias"] += 1.0
        path, _, r = to_file(tmp, "vda_vits", sd, "vda", c)
        del sd
        tree, r["read_s"] = timed(convert.load_checkpoint, path)
        mem = dstage.VDAEngine(size="vits", params=tree, device=dev)
        _, r["load_s"] = timed(mem.models, work)
        r["ignored"] = mem.ignored_leaves
        want = {"head.resize0.weight", "head.resize0.bias",
                "head.resize1.weight", "head.resize1.bias",
                "head.resize3.weight", "head.resize3.bias"}
        if set(mem.ignored_leaves) != want:
            raise RuntimeError(f"checkpoints (a): ignored leaves "
                               f"{mem.ignored_leaves}, expected {want}")
        clip = os.path.join(tmp, "clip.mkv")
        vio.save_rgb_video(frames, clip, 24)
        zero_counts()
        _, r["depth_cli_s"] = timed(cli.main, [
            "depth", "--color_video", clip, "--checkpoint", path])
        _, r["stereo_cli_s"] = timed(cli.main, [
            "stereo", "--depth_video", clip + "_depth.mkv", "--color_video",
            clip, "--xfov", "60", "--infill_mask", "--max_frames",
            str(CKPT_STEREO_FRAMES)])
        r["launches"] = counts()
        if {k: v for k, v in r["launches"].items() if v} != {
                "disparity_sweep": 2}:
            raise RuntimeError(f"checkpoints (a): launches {r['launches']},"
                               f" expected disparity_sweep 2 (main + anchor "
                               f"sweep of one batch of "
                               f"{CKPT_STEREO_FRAMES} frames)")
        torch.cuda.synchronize()
        metric, r["infer_s"] = timed(mem.infer_video, frames)
        r["fps"] = len(frames) / r["infer_s"]
        with vio.VideoReader(clip + "_depth.mkv") as rd:
            from_file = rd.read_all()
        in_memory = codec.encode_depth_frame(torch.as_tensor(metric),
                                             100.0).numpy()
        if not np.array_equal(from_file, in_memory):
            raise RuntimeError(
                f"checkpoints (a): the depth video of `depth --checkpoint` "
                f"differs from the same tree's engine in memory on "
                f"{float((from_file != in_memory).any(-1).mean()):.5f} of "
                f"pixels")
        with vio.VideoReader(clip + "_depth.mkv_stereo.mkv") as rd:
            n_sbs, w_sbs = rd.frame_count, rd.width
        if (n_sbs, w_sbs) != (CKPT_STEREO_FRAMES, 2 * W):
            raise RuntimeError(f"checkpoints (a): stereo wrote {n_sbs} "
                               f"frames of width {w_sbs}")
        log(f"[checkpoints] ({card}) (a) VDA-S {r['parameters'] / 1e6:.1f} M"
            f" parameters at {work[0]}x{work[1]} ({grid[0]}x{grid[1]} "
            f"patches): torch.save {r['torch_save_s']:.3f} s, convert "
            f"{r['convert_s']:.3f} s, .msgpack {r['bytes'] / 2**20:.1f} MiB "
            f"written in {r['write_s']:.3f} s, read in {r['read_s']:.3f} s, "
            f"loaded in {r['load_s']:.3f} s; ignored leaves (as by Flax "
            f"apply) {sorted(mem.ignored_leaves)}; `depth --checkpoint` "
            f"{len(frames)} frames 1080p {r['depth_cli_s']:.3f} s file to "
            f"file, bit-equal to the same tree in memory; in memory "
            f"{r['infer_s']:.3f} s, {r['fps']:.3f} frames/s (phase 3, seeded "
            f"weights: {depth_fps:.3f}); `stereo` {CKPT_STEREO_FRAMES} frames"
            f" {r['stereo_cli_s']:.3f} s, launches {r['launches']}")
        res["a_vda"] = {k: v for k, v in r.items() if k != "ignored"}
        del mem, tree, metric, from_file, in_memory
        gc.collect()

        # (b) DINOv2 ViT-L on the upstream 518 grid, grafted into DA3_L
        vit = da3.DA3_L.vit
        up_grid = 518 // vit.patch_size
        sd = upstream_state_dict(dinov2_shapes(
            "", vit.embed_dim, vit.depth, up_grid * up_grid), gen, dev)
        path, tree, r = to_file(tmp, "dinov2_vitl", sd, "dinov2", vit)
        del sd
        clip3 = os.path.join(tmp, "clip_da3.mkv")
        vio.save_rgb_video(da3_frames[:CKPT_DA3_CLI_FRAMES], clip3, 24)
        zero_counts()
        _, r["da3_cli_s"] = timed(cli.main, [
            "da3", "--color_video", clip3, "--backbone_checkpoint", path])
        if any(counts().values()):
            raise RuntimeError(f"checkpoints (b): the da3 command (SDPA) "
                               f"launched {counts()}")
        with vio.VideoReader(clip3 + "_depth.mkv") as rd:
            if rd.frame_count != CKPT_DA3_CLI_FRAMES:
                raise RuntimeError("checkpoints (b): da3 wrote "
                                   f"{rd.frame_count} frames")
        packed = da3.DA3Engine(cfg=da3_config("flash_packed"), device=dev,
                               rng_seed=0, backbone=path)
        work3 = packed._work_hw(H, W)
        model, r["graft_s"] = timed(packed.model, work3)
        bb = dict(tree)
        nt = model.backbone.pos_embed.shape[1] - 1
        gt = (work3[0] // vit.patch_size, work3[1] // vit.patch_size)
        bb["pos_embed"] = vit_mod.interpolate_pos_embed(
            tree["pos_embed"], (up_grid, up_grid), gt)
        want = from_jax.flax_to_state_dict(bb)
        got = model.backbone.state_dict()
        bad = [k for k in want if not torch.equal(got[k],
                                                  want[k].to(got[k].device))]
        if bad or nt != gt[0] * gt[1]:
            raise RuntimeError(f"checkpoints (b): grafted weights differ "
                               f"from the file's at {bad[:6]}")
        run_da3(packed, da3_frames, "grafted warm-up")
        zero_counts()
        depth, _, _, r["infer_s"], r["peak_gib"] = run_da3(
            packed, da3_frames, "grafted")
        r["launches"] = counts()
        r["fps"] = len(da3_frames) / r["infer_s"]
        want_l = {"packed_flash_attention": 2 * DA3_BLOCKS}
        if {k: v for k, v in r["launches"].items() if v} != want_l:
            raise RuntimeError(f"checkpoints (b): launches "
                               f"{r['launches']}, expected {want_l}")
        log(f"[checkpoints] ({card}) (b) DINOv2 ViT-L "
            f"{r['parameters'] / 1e6:.1f} M parameters on the {up_grid}x"
            f"{up_grid} grid: torch.save {r['torch_save_s']:.3f} s, convert "
            f"{r['convert_s']:.3f} s, .msgpack {r['bytes'] / 2**20:.1f} MiB "
            f"written in {r['write_s']:.3f} s; `da3 --backbone_checkpoint` "
            f"{CKPT_DA3_CLI_FRAMES} frames 1080p {r['da3_cli_s']:.3f} s file "
            f"to file; DA3_L flash_packed with the file's backbone (read and "
            f"grafted, pos_embed {up_grid}x{up_grid} -> {gt[0]}x{gt[1]}, in "
            f"{r['graft_s']:.3f} s; every grafted weight equal to the "
            f"file's): {len(da3_frames)} frames 1080p {r['infer_s']:.3f} s, "
            f"{r['fps']:.3f} frames/s (phase 6, seeded weights: "
            f"{da3_fps:.3f}), depth {depth.min():.3f}..{depth.max():.3f} m, "
            f"peak {r['peak_gib']:.2f} GiB, launches {r['launches']}")
        res["b_da3"] = r
        del packed, model, tree, bb, want, got, depth
        gc.collect()
        torch.cuda.empty_cache()

        # (c) {"dit", "enc", "dec"} at WAN_1_3B (WAN_TINY past the cutoff)
        elapsed = time.perf_counter() - t_script
        tiny = elapsed > CKPT_WAN_CUTOFF_S
        cfg = wan_mod.WAN_TINY if tiny else wan_mod.WAN_1_3B
        sd = upstream_state_dict(wan_shapes(cfg), gen, dev)
        pth = os.path.join(tmp, "wan.pth")
        _, t_pth = timed(torch.save, sd, pth)
        del sd
        dit, t_conv = timed(convert.convert_torch_file, pth, "wan", cfg)
        os.remove(pth)
        halves = {}
        for i, (name, cls) in enumerate((("enc", wan_mod.WanVAEEncoder),
                                         ("dec", wan_mod.WanVAEDecoder))):
            mod = wan_mod.init_weights(cls(cfg.vae), torch.Generator(
                ).manual_seed(CKPT_SEED + i))
            halves[name] = {"params": from_jax.to_flax_params(mod)}
        tree = {"dit": dit, **halves}
        path = os.path.join(tmp, "inspatio_world.msgpack")
        _, t_write = timed(convert.save_checkpoint, path, tree)
        written[path] = tree
        r = {"model": "WAN_TINY" if tiny else "WAN_1_3B",
             "parameters": sum(int(np.prod(np.shape(v)))
                               for _, v in tree_leaves(tree)),
             "bytes": os.path.getsize(path), "torch_save_s": t_pth,
             "convert_s": t_conv, "write_s": t_write}
        src = os.path.join(tmp, "sbs.mkv")
        mono = os.path.join(tmp, "mono.mkv")
        n = CKPT_INFILL_FRAMES
        vio.save_rgb_video(sbs[:n], src, 24)
        vio.save_rgb_video(sbs_mask[:n], src + "_infillmask.mkv", 24)
        vio.save_rgb_video(frames[:n], mono, 24)
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts()
        argv = ["infill", "--sbs_color_video", src, "--color_video", mono,
                "--infill_engine", "inspatio_world", "--checkpoint", path]
        if tiny:
            argv += ["--model_scale", "tiny"]
        # the preset pads a shorter clip to its 225-frame chunk (88,920
        # tokens, minutes per eye at WAN_1_3B): cut to the clip, as phase 5
        # cuts it to 40
        preset = idf.ENGINE_PRESETS["inspatio_world"]
        full_chunk = preset["chunk"]
        preset["chunk"] = n
        try:
            _, r["infill_cli_s"] = timed(cli.main, argv)
        finally:
            preset["chunk"] = full_chunk
        r["launches"] = counts()
        tl = wan_mod.latent_frames(wan_mod.pad_to_valid_t(n))
        blocks = -(-tl // cfg.block_frames)
        want_l = {"block_causal_attention": 2 * blocks
                  * len(cfg.denoise_steps) * cfg.layers}
        if {k: v for k, v in r["launches"].items() if v} != want_l:
            raise RuntimeError(f"checkpoints (c): launches "
                               f"{r['launches']}, expected {want_l} (2 eyes "
                               f"x {blocks} causal blocks x "
                               f"{len(cfg.denoise_steps)} steps x "
                               f"{cfg.layers} layers)")
        with vio.VideoReader(src + "_infilled.mkv") as rd:
            got = rd.read_all()
        hole = np.any(sbs_mask[:n] != 0, axis=-1)
        if got.shape != sbs[:n].shape or not np.array_equal(
                got[~hole], sbs[:n][~hole]):
            raise RuntimeError("checkpoints (c): the infilled video's shape "
                               "or its pixels outside the holes are wrong")
        cut = (f"; cut to WAN_TINY: the script had run {elapsed:.1f} s "
               f"before the phase (cutoff {CKPT_WAN_CUTOFF_S:.0f} s)"
               if tiny else "")
        log(f"[checkpoints] ({card}) (c) {r['model']} {{dit, enc, dec}} "
            f"{r['parameters'] / 1e6:.1f} M parameters: torch.save "
            f"{t_pth:.3f} s, convert {t_conv:.3f} s, .msgpack "
            f"{r['bytes'] / 2**30:.3f} GiB written in {t_write:.3f} s; "
            f"`infill --infill_engine inspatio_world --checkpoint` {n} SBS "
            f"frames 3840x1080 (the preset's {full_chunk}-frame chunk cut to "
            f"{n}) {r['infill_cli_s']:.3f} s file to file (the file read and "
            f"loaded inside), launches {r['launches']}{cut}")
        res["c_wan"] = r
        del dit, halves, tree, got
        gc.collect()
        torch.cuda.empty_cache()

        # (d) every file read back, and leaves over 2^30 bytes (chunked)
        g = torch.Generator(device=dev).manual_seed(CKPT_SEED + 7)
        big = {"chunked": {
            "f32": torch.randn(CHUNK_TEST_ELEMENTS, generator=g,
                               device=dev).cpu().numpy(),
            "bf16": torch.randn(2 * CHUNK_TEST_ELEMENTS + 7, generator=g,
                                device=dev).to(torch.bfloat16).cpu()},
            "small": torch.randn(3, 5, generator=g, device=dev).to(
                torch.bfloat16).cpu()}
        path = os.path.join(tmp, "chunked.msgpack")
        _, t_write = timed(convert.save_checkpoint, path, big)
        written[path] = big
        with open(path, "rb") as f:
            head = f.read(4096)
        if b"__msgpack_chunked_array__" not in head:
            raise RuntimeError("checkpoints (d): no chunked leaf in the file")
        r = {"files": {}}
        for p, tree in written.items():
            back, t_read = timed(convert.load_checkpoint, p)
            (leaves, nbytes), t_cmp = timed(same_bits_on_card, tree, back,
                                            dev)
            r["files"][os.path.basename(p)] = {
                "bytes": os.path.getsize(p), "leaves": leaves,
                "read_s": t_read, "compare_s": t_cmp}
            log(f"[checkpoints] ({card}) (d) {os.path.basename(p)}: "
                f"{os.path.getsize(p) / 2**20:.1f} MiB, {leaves} leaves "
                f"({nbytes / 2**20:.1f} MiB of arrays) read in "
                f"{t_read:.3f} s, equal bit for bit to what was written "
                f"(on the card, {t_cmp:.3f} s)"
                + (f"; written in {t_write:.3f} s, float32 and bfloat16 "
                   f"leaves of {CHUNK_TEST_ELEMENTS * 4 / 2**30:.3f} and "
                   f"{(2 * CHUNK_TEST_ELEMENTS + 7) * 2 / 2**30:.3f} GiB in "
                   f"Flax's chunked layout" if p == path else ""))
            del back
            gc.collect()
        res["d_round_trip"] = r
        written.clear()
    res["s"] = time.perf_counter() - t_phase
    log(f"[checkpoints] ({card}) phase: {res['s']:.3f} s")
    return res


# ------------------------------------------------ phase: stereo_paths ----

SP_FRAMES = 16          # the stereo_paths clip: phase 3's first 16 frames
SP_VR_FRAMES = 8        # (d) VR180 and (e) Touchly0 at the 1920 eye size
SP_BG_FRAMES = 10       # (f) the save runs to the first downsample
SP_BATCH = 16           # the stereo CLI's default batch
SP_NEAR, SP_FAR = 1.0, 30.0     # the clip's depth range, metres
SP_4K = (2160, 3840)    # the forward step at the default batch: peak memory


def camera_path(n, seed=21):
    """A seeded smooth camera path (n, 4, 4) float32: per frame a yaw and
    a pitch of a few tenths of a degree and a translation of a few mm,
    each a sine of the frame index with a seeded phase."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ph = rng.uniform(0.0, 2.0 * np.pi, 5)
    out = []
    for i in range(n):
        s = [np.sin(2.0 * np.pi * i / n + p) for p in ph]
        yaw, pitch = np.radians(0.4) * s[0], np.radians(0.3) * s[1]
        cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
        m = np.eye(4)
        m[:3, :3] = (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                     @ np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]]))
        m[:3, 3] = [0.004 * s[2], 0.003 * s[3], 0.005 * s[4]]
        out.append(m)
    return np.asarray(out, np.float32)


def film_depth(metric, near=SP_NEAR, far=SP_FAR):
    """Depth mapped affinely onto near..far metres, frame order and pixel
    order kept: phase 3's seeded weights give a range of a few cm, which
    would collapse the background cloud's voxels."""
    import numpy as np

    lo, hi = float(metric.min()), float(metric.max())
    return (near + (far - near) * (metric - lo) / max(hi - lo, 1e-9)
            ).astype(np.float32)


def phase_stereo_paths(metric, frames, dev, zero_counts, expect_counts,
                       card):
    """The general stereo renderer and the novel-view render, file to file
    through cli/main.py on a 16-frame 1080p clip (phase 3's depth mapped
    onto 1..30 m, RGB-encoded FFV1, and its colour clip) with a seeded
    camera path: (a)
    ``stereo --transformation_file --infill_mask`` (forward warp, splat
    anchors), (b) the same with ``--transformation_lock_frame 8
    --render_as_pointcloud``, (c) ``--touchly1 --infill_mask`` (B1 twice a
    batch; its first launch held bit for bit against the plain sweep), (d)
    ``--vr180 --infill_mask`` and (e) ``--touchly0``, 8 frames each at the
    1920 eye size, (f) ``--mask_video --save_background`` (10 frames: to the
    first downsample) then ``--load_background --infill_mask``, (g) ``view
    --render`` and the same ``--render_as_pointcloud``, (h) (a) with
    ``--profile``. Then one forward-warp stereo step at batch 8 under
    torch.profiler; the same step at 4K and the CLI's default batch of 16,
    whose peak memory the z-buffer's passes bound; and the batch-8 step on
    the card and on the CPU for 2 frames: the hole masks must disagree on
    at most 1% of their union, and at most 0.1% of image bytes may differ
    by more than 1. -> numbers"""
    try:
        import cv2  # noqa: F401 - the commands read and write video files
    except ImportError as e:
        raise RuntimeError("stereo_paths: OpenCV (cv2) is not installed; "
                           "the commands read and write video files") from e
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.io import sidecar
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.ops import rasterize
    from metric_depth_video_toolbox_tpu_torch.ops import voxel
    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep as ws
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

    t_phase = time.perf_counter()
    n = SP_FRAMES
    metric = film_depth(metric[:n])
    res = {"runs": {}, "depth_m": [float(metric.min()), float(metric.max())]}
    tfs = camera_path(n)
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.mkv")
        depth = os.path.join(tmp, "clip_depth.mkv")
        mask = os.path.join(tmp, "clip_mask.mkv")
        tf = os.path.join(tmp, "clip_transformations.json")
        vio.save_depth_video(metric, depth, 24, 100.0)
        vio.save_rgb_video(frames[:n], clip, 24)
        # the subject: a box of a quarter of the frame, moving right by
        # W/64 a frame (a mask of the depth would follow the seeded
        # weights' depth range)
        subject = np.zeros((n, H, W, 3), np.uint8)
        for i in range(n):
            left = W // 3 + i * (W // 64)
            subject[i, H // 4:3 * H // 4, left:left + W // 4] = 255
        vio.save_rgb_video(subject, mask, 24)
        del subject
        sidecar.save_transformations(tf, tfs)
        base = ["--depth_video", depth, "--color_video", clip, "--xfov",
                "60"]

        def run(tag, argv, out, frames_, size, expect=None):
            """One command through cli/main.py; its counts zeroed before and
            read after; the output's frame count and size checked."""
            zero_counts()
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            expect_counts(f"stereo_paths {tag}", expect or {},
                          "the launches of this command")
            count, width, height, _ = vio.video_info(out)
            if (count, width, height) != (frames_, *size):
                raise RuntimeError(f"stereo_paths {tag}: {out}: {count} "
                                   f"frames of {width}x{height}, expected "
                                   f"{frames_} of {size[0]}x{size[1]}")
            r = {"wall_s": wall, "fps": frames_ / wall,
                 "bytes": os.path.getsize(out), "size": f"{width}x{height}"}
            res["runs"][tag] = r
            log(f"[stereo_paths] ({card}) {tag}: {wall:.3f} s, "
                f"{r['fps']:.3f} frames/s, {frames_} frames of "
                f"{width}x{height}, {r['bytes'] / 2**20:.1f} MiB")
            return r

        def hole_share(path, most=0.5):
            with vio.VideoReader(path + "_infillmask.mkv") as r:
                share = float((r.read_frame(n // 2).max(-1) > 0).mean())
            if not 0.0 < share < most:
                raise RuntimeError(f"stereo_paths: {path}: implausible "
                                   f"hole share {share}")
            return share

        sbs = depth + "_stereo.mkv"
        run("(a) --transformation_file --infill_mask",
            ["stereo", *base, "--transformation_file", tf, "--infill_mask"],
            sbs, n, (2 * W, H))
        res["hole_share_a"] = hole_share(sbs)
        run("(b) + --transformation_lock_frame 8 --render_as_pointcloud",
            ["stereo", *base, "--transformation_file", tf, "--infill_mask",
             "--transformation_lock_frame", "8", "--render_as_pointcloud"],
            sbs, n, (2 * W, H))
        res["hole_share_b"] = hole_share(sbs)

        # (c): the first B1 launch kept (arguments and results, copied)
        launch = ws.disparity_sweep
        held = []

        def keep(*args):
            copy = (tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args) if not held else None)
            out = launch(*args)
            if copy is not None:
                held.append((copy, tuple(o.clone() for o in out)))
            return out
        ws.disparity_sweep = keep
        batches = -(-n // SP_BATCH)
        try:
            run("(c) --touchly1 --infill_mask",
                ["stereo", *base, "--touchly1", "--infill_mask"],
                depth + "_Touchly1.mkv", n, (W, 2 * H),
                expect={"disparity_sweep": 2 * batches})
        finally:
            ws.disparity_sweep = launch
        args, out = held[0]
        ref = ws.disparity_sweep_plain(*args)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(out, ref)]
        if not all(same):
            raise RuntimeError(f"stereo_paths (c): the first B1 launch: "
                               f"kernel != plain (z, color, found equal: "
                               f"{same})")
        res["touchly1_launches"] = 2 * batches
        res["touchly1_sweep"] = (f"B={args[0].shape[0]} H={args[0].shape[1]}"
                                 f" WP={args[0].shape[2]} P={args[6]} "
                                 f"C={args[1].shape[1]}")
        log(f"[stereo_paths] (c) B1 launches {2 * batches} ({batches} "
            f"batch of {SP_BATCH}: main + anchor sweep); the first launch "
            f"({res['touchly1_sweep']}) == plain bit for bit")
        del held[:]

        run("(d) --vr180 --infill_mask (8 frames, eye 1920)",
            ["stereo", *base, "--vr180", "--infill_mask", "--max_frames",
             str(SP_VR_FRAMES)], sbs, SP_VR_FRAMES, (2 * 1920, 1920))
        run("(e) --touchly0 (8 frames, eye 1920)",
            ["stereo", *base, "--touchly0", "--max_frames",
             str(SP_VR_FRAMES)], depth + "_Touchly0.mkv", SP_VR_FRAMES,
            (3 * 1920, 1920))

        # (f): the cloud's point count after each downsample
        downsample = voxel.perspective_aware_downsample
        counts_bg = []

        def counted(points, *a, **kw):
            out = downsample(points, *a, **kw)
            counts_bg.append((len(points), len(out[0])))
            return out
        voxel.perspective_aware_downsample = counted
        npy = depth + "_background.npy"
        try:
            zero_counts()
            t0 = time.perf_counter()
            cli.main(["stereo", *base, "--mask_video", mask,
                      "--save_background", "--max_frames",
                      str(SP_BG_FRAMES)])
            wall = time.perf_counter() - t0
            expect_counts("stereo_paths (f) --save_background", {},
                          "the launches of this command")
        finally:
            voxel.perspective_aware_downsample = downsample
        cloud = np.load(npy, allow_pickle=True)
        res["background"] = {"save_s": wall, "npy_bytes": os.path.getsize(
            npy), "points": int(cloud.shape[1]), "downsamples": counts_bg}
        log(f"[stereo_paths] ({card}) (f) --mask_video --save_background "
            f"({SP_BG_FRAMES} frames): {wall:.3f} s; downsamples (points "
            f"before -> after): {counts_bg}; {cloud.shape[1]} points saved, "
            f".npy {os.path.getsize(npy) / 2**20:.1f} MiB")
        if (not counts_bg or not counts_bg[-1][1]
                or cloud.shape[1] != counts_bg[-1][1]):
            raise RuntimeError(f"stereo_paths (f): cloud {cloud.shape}, "
                               f"downsamples {counts_bg}")
        run("(f) --load_background --infill_mask",
            ["stereo", *base, "--load_background", npy, "--infill_mask"],
            sbs, n, (2 * W, H))
        # the downsampled cloud is sparse (voxels of 0.003 in x/z, ~5 px
        # at 1080p and 60 degrees) and splats 3 x 3: many holes
        res["hole_share_f"] = hole_share(sbs, most=1.0)

        view = ["view", "--depth_video", depth, "--color_video", clip,
                "--x", "0.05", "--tx", "0", "--ty", "0", "--tz", "5",
                "--render"]
        run("(g) view --render", view, depth + "_render.mkv", n, (W, H))
        run("(g) view --render --render_as_pointcloud",
            view + ["--render_as_pointcloud"], depth + "_render.mkv", n,
            (W, H))

        trace_dir = os.path.join(tmp, "trace")
        run("(h) (a) with --profile",
            ["stereo", *base, "--transformation_file", tf, "--infill_mask",
             "--profile", trace_dir], sbs, n, (2 * W, H))
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        if not traces:
            raise RuntimeError(f"stereo_paths (h): no trace in {trace_dir}")
        res["trace_bytes"] = os.path.getsize(os.path.join(trace_dir,
                                                          traces[0]))
        log(f"[stereo_paths] (h) trace {traces[0]}: "
            f"{res['trace_bytes'] / 2**20:.1f} MiB")

    # one forward-warp stereo step at batch 8 (the camera path's first 8
    # frames), profiled; then 2 frames on the card and on the CPU
    cfg = stereo.StereoConfig(width=W, height=H, make_infill_mask=True,
                              warp_method="forward")
    args = stereo_inputs(codec.encode_depth_frame(torch.as_tensor(
        metric[:BATCH], device=dev), 100.0), torch.as_tensor(
            frames[:BATCH], device=dev))
    args = args[:3] + (torch.as_tensor(tfs[:BATCH], device=dev),) + args[4:]
    stereo.stereo_step(cfg, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stereo.stereo_step(cfg, *args)
    wall = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):           # the first profile pays the tracer's setup
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stereo.stereo_step(cfg, *args)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    res["forward_step"] = {"wall_ms": wall * 1e3, "device_ms": busy,
                           "busy": busy / (wall * 1e3),
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2**30}
    log(f"[stereo_paths] ({card}) forward-warp stereo step, batch "
        f"{BATCH} 1080p, camera path, infill mask: device busy {busy:.3f} "
        f"ms of {wall * 1e3:.3f} ms wall unprofiled "
        f"({busy / (wall * 1e3):.1%}); peak "
        f"{res['forward_step']['peak_gib']:.2f} GiB")
    for e in sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)[:5]:
        ms = e.self_device_time_total / 1e3
        log(f"[stereo_paths]   {ms:9.3f} ms {ms / max(busy, 1e-9):6.1%} "
            f"x{e.count:<5d} {e.key[:100]}")

    # the same step at 4K and the CLI's default batch (16 frames, 32 eyes)
    h4, w4 = SP_4K
    del prof, events
    gen4 = torch.Generator(device=dev).manual_seed(4)
    d4, c4 = synth_scene(SP_BATCH, gen4, dev, h4, w4)
    args4 = stereo_inputs(codec.encode_depth_frame(d4, 100.0), c4)
    args4 = args4[:3] + (torch.as_tensor(tfs[:SP_BATCH], device=dev),) \
        + args4[4:]
    del d4, c4
    cfg4 = stereo.StereoConfig(width=w4, height=h4, make_infill_mask=True,
                               warp_method="forward")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out4 = stereo.stereo_step(cfg4, *args4)
    wall4 = time.perf_counter() - t0
    peak4 = torch.cuda.max_memory_allocated() / 2**30
    res["forward_step_4k"] = {"wall_s": wall4, "peak_gib": peak4,
                              "held_before_gib": base_gib}
    log(f"[stereo_paths] ({card}) forward-warp stereo step, batch "
        f"{SP_BATCH} at {w4}x{h4} (the CLI's default batch), camera path, "
        f"infill mask: {wall4:.3f} s (first call), peak {peak4:.2f} GiB "
        f"({base_gib:.2f} GiB held before it; z-buffer passes of at most "
        f"{rasterize.ZBUFFER_BYTES / 2**30:.0f} GiB)")
    if out4["image"].shape != (SP_BATCH, h4, 2 * w4, 3):
        raise RuntimeError(f"stereo_paths: 4K step image "
                           f"{out4['image'].shape}")
    del out4, args4

    two = tuple(a[:2] for a in args)
    t0 = time.perf_counter()
    card_out = stereo.stereo_step(cfg, *two)
    cpu_out = stereo.stereo_step(cfg, *(a.cpu() for a in two))
    t_pair = time.perf_counter() - t0
    diff = np.abs(card_out["image"].astype(np.int16)
                  - cpu_out["image"].astype(np.int16))
    differ, differ_1 = float(np.mean(diff > 0)), float(np.mean(diff > 1))
    holes = [o["infill_mask"].max(-1) > 0 for o in (card_out, cpu_out)]
    union = int((holes[0] | holes[1]).sum())
    off = float((holes[0] != holes[1]).sum() / max(union, 1))
    res["card_vs_cpu"] = {"bytes_differing": differ,
                          "bytes_differing_by_more_than_1": differ_1,
                          "hole_disagreement_of_union": off,
                          "hole_share": float(holes[0].mean())}
    log(f"[stereo_paths] forward step, 2 frames, card vs CPU ({t_pair:.1f} "
        f"s): {differ:.5%} of image bytes differ, {differ_1:.5%} by more "
        f"than 1; the hole masks disagree on {off:.5%} of their union "
        f"({union} pixels; hole share {holes[0].mean():.4f})")
    if not union or off > 0.01 or differ_1 > 0.001:
        raise RuntimeError(f"stereo_paths: card vs CPU: hole masks disagree "
                           f"on {off:.4%} of their union of {union} (limit "
                           f"1%), {differ_1:.4%} of image bytes differ by "
                           f"more than 1 (limit 0.1%)")
    res["s"] = time.perf_counter() - t_phase
    log(f"[stereo_paths] ({card}) phase: {res['s']:.3f} s")
    return res



def main():
    t_script = time.perf_counter()
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
    import argparse
    import gc

    import numpy as np

    cli = argparse.ArgumentParser(description="Smoke run on one CUDA card.")
    cli.add_argument("--baseline-csrc", dest="baseline_csrc",
                     help="also build the two sweep sources of this csrc "
                          "directory and time them beside this checkout's "
                          "(phase 2's bitmap ablation)")
    baseline_csrc = cli.parse_args().baseline_csrc

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
    for name in names:   # built anew, so that nvcc's ptxas report is read
        cuda_build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    cuda_build.build(names)                  # one nvcc per source, together
    for name in names:
        cuda_build.load(name)
    log(f"[build] {len(names)} kernels in {time.perf_counter() - t0:.2f} s")
    ptxas = {name: ptxas_report(cuda_build.BUILD_LOG.get(name, ""))
             for name in names}
    for name in names:
        for fn, r in ptxas[name].items():
            log(f"[build] {name}: {fn[:90]}: {r['regs']} registers, "
                f"{r['smem']} bytes static smem, {r['spill_bytes']} bytes "
                f"spilled (stores + loads)")

    from metric_depth_video_toolbox_tpu_torch.ops import \
        attention_packed as apk

    tables = (ws.LAUNCHES, bcm.LAUNCHES, apk.LAUNCHES)

    def zero_counts():
        for table in tables:
            for key in table:
                table[key] = 0

    def counts():
        return {k: v for table in tables for k, v in table.items()}

    def expect_counts(path, want, why):
        got = counts()
        if {k: v for k, v in got.items() if v} != want:
            raise RuntimeError(f"{path}: kernel launches {got}, expected "
                               f"{want} and no other ({why})")
        log(f"[main path] {path}: launches {want}: {why}")

    gen = torch.Generator(device=dev).manual_seed(0)
    sweep, dual, sweep_calls, dual_args = phase_kernels(gen, dev)
    ablation = phase_sweep_ablation(sweep_calls, dual_args, baseline_csrc)
    del sweep_calls, dual_args
    packed = phase_kernels_packed(dev)
    attention = phase_kernels_attention(gen, dev)

    zero_counts()
    metric, frames, depth_fps = phase_depth(gen, dev)
    stereo_fps, batches, sbs, sbs_mask = phase_stereo(metric, frames, gen,
                                                      dev)
    launches = 2 * batches
    expect_counts("depth + stereo", {"disparity_sweep": launches},
                  f"{batches} batches, main + anchor sweep per batch of "
                  f"{BATCH} frames x 2 eyes = 4 sweeps per frame")
    zero_counts()
    fused_fps, two_call_fps, fused_batches = phase_stereo_fused(
        torch.Generator(device=dev).manual_seed(5), dev)
    dual_launches = counts()["disparity_sweep_dual"]
    if dual_launches != fused_batches:
        raise RuntimeError(f"fused stereo step: disparity_sweep_dual "
                           f"launched {dual_launches} times over "
                           f"{fused_batches} batches")
    log(f"[main path] fused stereo step: disparity_sweep_dual launches: "
        f"{dual_launches} over {fused_batches} batches: 1 per batch of "
        f"{BATCH} frames x 2 eyes")

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
    bc_launches = 2 * 16 * 30
    expect_counts("infill", {"block_causal_attention": bc_launches},
                  "2 eyes x 16 DiT forwards (4 causal blocks x 4 steps) x 30 "
                  "layers")

    da3_res, da3_eng, da3_frames = phase_da3(dev, zero_counts, counts)

    movie_fps, movie_steps, movie_launches, movie_sweeps, movie_diffusion = \
        phase_movie(dev, zero_counts, expect_counts, smi[0])
    svd_infill = phase_svd_infill(sbs, sbs_mask, frames, dev, zero_counts,
                                  expect_counts, smi[0])
    checkpoints = phase_checkpoints(
        frames, sbs, sbs_mask, da3_frames, depth_fps,
        da3_res["flash_packed"]["fps"], dev, zero_counts, counts, smi[0],
        t_script)

    phase_reference(dev)
    phase_reference_movie(dev)
    phase_reference_infill(sbs, sbs_mask, frames, dev)
    phase_reference_svd_infill(dev, smi[0])
    phase_reference_da3(dev)
    phase_files(dev)
    phase_profile(metric, frames, (eng, eye),
                  (da3_eng, da3_frames, da3_res["flash_packed"]["s"]), sbs,
                  sbs_mask, dev)

    # the last phase runs no model of the earlier ones: free them
    del eng, drv, eye, da3_eng
    gc.collect()
    torch.cuda.empty_cache()
    stereo_paths = phase_stereo_paths(metric, frames, dev, zero_counts,
                                      expect_counts, smi[0])

    def over(r):
        return r["ms"] / r["library_ms"] if r.get("library_ms") else None

    main_ = sweep["main"]
    bf16, prod = attention["bfloat16"], attention["production"]
    cross, per_view = packed["cross_view_bfloat16"], \
        packed["per_view_bfloat16"]
    packed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                   "library_unmasked_ms", "max_abs_err", "error_ratio")
    kernels = [{
        "name": "disparity_sweep", "route": "cuda",
        "source": f"{PACKAGE}/csrc/disparity_sweep.cu",
        "core": f"{PACKAGE}/csrc/sweep_sm90.cuh",
        "replaces": "metric_depth_video_toolbox_tpu/ops/warp_pallas.py:43",
        "launches": launches,
        "movie_launches": movie_launches,
        "touchly1_launches": stereo_paths["touchly1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in (
            *sweep.values(), *movie_sweeps.values())),
        "ms": main_["ms"], "plain_ms": main_["plain_ms"],
        "bound_ms": main_["bound_ms"], "bound_by": main_["bound_by"],
        "library_ms": None,
        "shapes": {k: {kk: v[kk] for kk in ("shape", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "active_share")}
                   for k, v in sweep.items()},
        "movie_shapes": movie_sweeps,
        "ablation": {k: ablation[k] for k in ("main", "anchor")},
        "sass": ablation["sass"]["disparity_sweep"],
    }, {
        "name": "disparity_sweep_dual", "route": "cuda",
        "source": f"{PACKAGE}/csrc/disparity_sweep_dual.cu",
        "core": f"{PACKAGE}/csrc/sweep_sm90.cuh",
        "replaces": "metric_depth_video_toolbox_tpu/ops/warp_pallas.py:107",
        "launches": dual_launches,
        "max_abs_err": dual["max_abs_err"],
        "ms": dual["ms"], "plain_ms": dual["plain_ms"],
        "bound_ms": dual["bound_ms"], "bound_by": dual["bound_by"],
        "library_ms": None,
        "shape": dual["shape"], "active_share": dual["active_share"],
        "anchor_share": dual["anchor_share"],
        "ablation": ablation["dual"],
        "sass": ablation["sass"]["disparity_sweep_dual"],
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
                           "library_ms", "max_abs_err", "error_ratio")},
                       "ms_over_library": over(prod),
                       **({"library_error": prod["library_error"]}
                          if "library_error" in prod else {})},
    }, {
        "name": "packed_flash_attention", "route": "cuda",
        "source": f"{PACKAGE}/csrc/packed_flash_attention.cu",
        "replaces":
            "metric_depth_video_toolbox_tpu/ops/attention_pallas.py:80",
        "launches": da3_res["flash_packed"]["launches"][
            "packed_flash_attention"],
        **{k: cross[k] for k in packed_keys if k != "library_unmasked_ms"},
        "library_unmasked_ms": cross["library_unmasked_ms"],
        "shape": f"cross-view (1, {DA3_VIEWS} x 2368, {3 * DA3_HEADS}, "
                 f"{DA3_HEAD_DIM}) bfloat16, {DA3_TOKENS} real tokens per "
                 f"view",
        "max_abs_err_float32": packed["cross_view_float32"]["max_abs_err"],
        "per_view": {"shape": f"({DA3_VIEWS}, 2368, {3 * DA3_HEADS}, "
                              f"{DA3_HEAD_DIM}) bfloat16",
                     **{k: per_view[k] for k in packed_keys},
                     "ms_over_library": over(per_view),
                     "max_abs_err_float32":
                         packed["per_view_float32"]["max_abs_err"]},
    }]
    for entry in kernels:
        entry.update(kernel_resources(ptxas, entry["name"]))
        entry["ms_over_library"] = over(entry)
        if "baseline_sass" in ablation and entry["name"] in ablation[
                "baseline_sass"]:
            entry["baseline_sass"] = ablation["baseline_sass"][entry["name"]]
            entry["baseline_ptxas"] = ablation["baseline_ptxas"][
                entry["name"]]
    log(json.dumps({"da3": {k: {kk: v[kk] for kk in ("s", "fps", "peak_gib")}
                            for k, v in da3_res.items()},
                    "fused_stereo_fps": fused_fps,
                    "two_call_stereo_fps_in_turns": two_call_fps}))
    log(json.dumps({"depth_fps": depth_fps, "stereo_fps": stereo_fps,
                    "infill_sbs_fps": infill_fps, "infill_s": infill_s,
                    "infill_peak_gib": infill_peak}))
    log(json.dumps({"movie": {"source_frames": 2 * MOVIE_SCENE_FRAMES,
                              "fps": movie_fps, "steps_s": movie_steps,
                              "diffusion_resume": movie_diffusion}}))
    log(json.dumps({"svd_infill": svd_infill, "card": smi[0]}))
    log(json.dumps({"checkpoints": checkpoints, "card": smi[0]}))
    log(json.dumps({"stereo_paths": stereo_paths, "card": smi[0]}))
    log(json.dumps({"kernels": kernels}))
    log(smi[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
