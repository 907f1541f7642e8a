#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline-csrc DIR]
                          [--only single_frame|depth_engines|tracking]

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
                16-frame scenes with a hard cut; counts zeroed before, read
                after (the disparity sweep twice per stereo batch, nothing
                else); the scene CSV, the per-scene files, 32 final frames
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
                mono conditioning) on 25 frames, (c) ``--model_scale svd`` (the
                StereoCrafter graph, SVDConfig, bf16) on 13 frames; each
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
  9. files      depth -> stereo -> infill (--model_scale tiny, one
                12-frame chunk), da3
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
 12. single_frame the single-frame engines (after the earlier phases'
                models are freed), file to file through cli/main.py on
                phase 3's first 16 frames: (a) ``engine moge``, ``unik3d``,
                ``unidepth --xfov 60`` and ``depthpro`` at their _L presets
                with ``--checkpoint`` on a file converted from a seeded
                upstream-layout state dict (the layouts of moge_shapes,
                unidepth_shapes, depthpro_hf_shapes; the ViT's position
                embedding at the 1080p working grid), each with its wall,
                frames/s, peak memory, xfovs range and one batch under
                torch.profiler (counts zeroed before, read after: no
                launch, the attention is SDPA); (b) the stand-ins at the
                CLI's defaults (vits, no checkpoint) for moge, unik3d and
                depthpro; (c) MoGe-L with attention_impl="flash_packed":
                counts zeroed before, read after (24 packed-attention
                launches for the batch of 16 at 37 x 66 + 1 tokens), the
                first launch held against the plain version and timed
                beside its bound and SDPA on the real tokens, the raw point
                map held against the SDPA route's (SF_ROUTE_MAX /
                SF_ROUTE_MEAN); (d) ``engine videoanythingmetric`` bit-equal
                to ``depth --profile DIR`` (a trace file must appear); (e)
                ``split-sbs`` on phase 4's SBS frames (halves bit-equal) and
                ``inpaint`` on the clip; (f) the movie's two-pass step 2
                with the moge stand-in on a 40-frame scene (one locked FOV).
 13. depth_engines the diffusion and MVS depth engines, ``upscale`` and
                ``--quantize int8`` (after the earlier phases' models are
                freed), file to file through cli/main.py on phase 3's 1080p
                clip: (a) ``engine depthcrafter --model svd`` on phase 3's
                depth at the defaults (window 110, overlap 25, 448 x 768, 5
                steps) on 40 frames, (a') with ``--use_depth_prompting
                --window 25 --overlap 10``, (b) ``engine geometrycrafter
                --model svd`` with the MoGe stand-in's prior and
                ``--pmap_vae_checkpoint`` (PMAP_VAE from a seeded
                upstream-layout state dict, read back bit for bit), (c)
                ``engine mvsa`` (MVSConfig, resize_w 1024, window 7) on 16
                frames under phase 11's camera path, plain and
                ``--rescale_to_cost_volume``, (d) ``upscale`` (PromptDA
                ViT-L from a converted promptda_hf file, a 256 x 144 prompt,
                16 frames, batches of 4), (e) ``depth --quantize int8``
                beside ``depth`` on 40 frames (rates, the int8 GEMM's
                calls, the depth difference within DE_QUANT_MAX /
                DE_QUANT_MEAN), (f) the movie's step 2 with depthcrafter
                and geometrycrafter on one 40-frame scene; each with its
                wall, frames/s, peak memory and one window's or batch's
                device time, busy share and top operations, counts zeroed
                before and read after (no launch); then each engine at its
                tiny preset on the card and on the CPU (float32, the same
                weights and noise).
 14. tracking  tracking, pose and flow (after the earlier phases' models
                are freed), file to file through cli/main.py on phase 3's
                1080p clip (40 frames; its depth mapped onto 1-30 m, as
                phase 11's): (a) ``track`` at the defaults (LK, grid 36,
                clip_len 120) and ``track --engine cotracker3 --weights``
                on a file converted from a seeded upstream-layout state
                dict at COTRACKER3; (b) ``align`` with each solver
                (two-group, ``--assume_stationary_camera``,
                ``--use_madpose``) on (a)'s LK tracks; (c) ``flow``
                (RAFT_LARGE from a converted file) on 16 frames at batch 4,
                with its peak memory; (d) ``slam`` without a checkpoint
                and with a converted ``megasam`` file (DROID, bf16, the
                global bundle adjustment on); each with its wall,
                frames/s, peak memory and one clip's, chunk's, pair's,
                batch's or window's device time, busy share and top
                operations, counts zeroed before and read after (no
                launch); (e) LK, CoTracker3, RAFT, DroidNet, one window
                of the learned front-end and the bundle adjustment at
                their tiny presets in float32 on the card and on the CPU
                (the CPU tests' tolerances).

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
MOVIE_SCENE_FRAMES = 16        # the movie phase: two scenes of 16 frames
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
    1080p clip of two 16-frame scenes (the second with its channels
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


M2SVID_FRAMES = 25             # svd_infill (b): one 25-frame chunk per eye
SVD_FRAMES = 13                # svd_infill (c): one 13-frame chunk per eye


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
    # the device's activity alone: its kernels and copies are all this
    # reads, and the host's operator events would cost the tracer's
    # teardown more than the chunk
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.infill_chunk(*chunk)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
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
    512 with the phase-3 clip as the mono conditioning, no halo, on the
    first 25 frames; (c)
    ``--model_scale svd`` (SVDConfig and SVDVAEConfig, bfloat16) on the
    first 13 frames. Counts zeroed before each run and read after: no
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
        ("b m2svid", ["--infill_engine", "m2svid", "--color_video", None,
                      "--max_frames", str(M2SVID_FRAMES)], M2SVID_FRAMES,
         dif.DIFFUSION_SVD, (512, 512), False),
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
        # the first profile pays the tracer's setup; the device's activity
        # alone (kernels and copies, all this reads): the host's operator
        # events cost the tracer's teardown tens of seconds on the infill
        # eye, and the record_function stage ranges come only with them
        for _ in range(reps):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
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
        if reps == 1:
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
        # the preset pads a shorter clip to its 225-frame chunk: cut to the
        # clip's 12 frames, as the checkpoints phase cuts it to its 16
        from metric_depth_video_toolbox_tpu_torch.pipeline import \
            infill_diffusion as idf
        preset = idf.ENGINE_PRESETS["inspatio_world"]
        full_chunk = preset["chunk"]
        preset["chunk"] = 12
        t0 = time.perf_counter()
        try:
            cli.main(["infill", "--sbs_color_video", sbs, "--color_video",
                      clip, "--infill_engine", "inspatio_world",
                      "--model_scale", "tiny"])
        finally:
            preset["chunk"] = full_chunk
        dt_infill = time.perf_counter() - t0
        for out in (sbs, sbs + "_infilled.mkv"):
            with vio.VideoReader(out) as r:
                n, w = r.frame_count, r.width
            if n != 12 or w != 960:
                raise RuntimeError(f"files: {out} has {n} frames of width "
                                   f"{w}")
        log(f"[files] depth -> stereo file to file, 12 frames 270x480 "
            f"(OpenCV {cv2.__version__}): {dt:.3f} s; infill (inspatio_world"
            f", WAN_TINY at 480x832, one 12-frame chunk) file to file: "
            f"{dt_infill:.3f} s")

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
# than this before the phase (the script aims at 1100 s of its 1200)
CKPT_WAN_CUTOFF_S = 450.0
CHUNK_TEST_ELEMENTS = 2 ** 28 + 4097   # one float32 leaf over 2^30 bytes


def block_shapes(b, d):
    """{name: shape} of one upstream DINOv2 block of width d, prefix b."""
    return {b + "norm1.weight": (d,), b + "norm1.bias": (d,),
            b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
            b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
            b + "ls1.gamma": (d,), b + "norm2.weight": (d,),
            b + "norm2.bias": (d,), b + "mlp.fc1.weight": (4 * d, d),
            b + "mlp.fc1.bias": (4 * d,),
            b + "mlp.fc2.weight": (d, 4 * d), b + "mlp.fc2.bias": (d,),
            b + "ls2.gamma": (d,)}


def dinov2_shapes(prefix, d, depth, n_tokens, patch=14):
    """{name: shape} of an upstream DINOv2 state dict."""
    s = {f"{prefix}patch_embed.proj.weight": (d, 3, patch, patch),
         f"{prefix}patch_embed.proj.bias": (d,),
         f"{prefix}cls_token": (1, 1, d),
         f"{prefix}pos_embed": (1, n_tokens + 1, d),
         f"{prefix}norm.weight": (d,), f"{prefix}norm.bias": (d,)}
    for i in range(depth):
        s.update(block_shapes(f"{prefix}blocks.{i}.", d))
    return s


def _layer(s, name, out_ch, in_ch, k=None, bias=True, transpose=False):
    """A Linear (k None), Conv2d or ConvTranspose2d's weight (and bias)."""
    shape = (out_ch, in_ch) if k is None else (
        (in_ch, out_ch, k, k) if transpose else (out_ch, in_ch, k, k))
    s[name + ".weight"] = shape
    if bias:
        s[name + ".bias"] = (out_ch,)


def moge_shapes(cfg, n_tokens):
    """{name: shape} of an upstream MoGe state dict (the layout of
    models.convert.convert_moge) at a grid of n_tokens patches."""
    v = cfg.vit
    s = dinov2_shapes("backbone.", v.embed_dim, v.depth, n_tokens,
                      v.patch_size)
    for i in range(4):
        _layer(s, f"head.projects.{i}", cfg.dim_proj, v.embed_dim, 1)
    cin = cfg.dim_proj
    for i, ch in enumerate(cfg.dim_upsample):
        ub = f"head.upsample_blocks.{i}"
        _layer(s, ub + ".0", ch, cin + 2, 2, transpose=True)
        _layer(s, ub + ".1", ch, ch, 3)
        for j in range(cfg.num_res_blocks):
            rb = f"{ub}.{2 + j}"
            for n in ("norm1", "norm2"):
                s[f"{rb}.{n}.weight"] = s[f"{rb}.{n}.bias"] = (ch,)
            _layer(s, rb + ".conv1", ch, ch, 3)
            _layer(s, rb + ".conv2", ch, ch, 3)
        cin = ch
    _layer(s, "head.output_block.0", cfg.last_conv_channels, cin + 2, 3)
    _layer(s, "head.output_block.2", cfg.n_out, cfg.last_conv_channels, 1)
    return s


def _token_decoder_shapes(s, prefix, cfg, num_blocks, with_rays):
    for i in range(4):
        _layer(s, f"{prefix}projects.{i}", cfg.dim, cfg.vit.embed_dim)
    if with_rays:
        _layer(s, prefix + "ray_mlp1", cfg.dim, (cfg.sh_degree + 1) ** 2)
        _layer(s, prefix + "ray_mlp2", cfg.dim, cfg.dim)
    for i in range(num_blocks):
        s.update(block_shapes(f"{prefix}blocks.{i}.", cfg.dim))


def _pixel_head_shapes(s, prefix, cfg):
    cin = cfg.dim
    for i, ch in enumerate(cfg.dim_upsample):
        _layer(s, f"{prefix}upsample{i}", ch, cin, 2, transpose=True)
        _layer(s, f"{prefix}upconv{i}", ch, ch, 3)
        cin = ch
    _layer(s, prefix + "out_conv1", cfg.last_conv_channels, cin, 3)
    _layer(s, prefix + "out_conv2", 2, cfg.last_conv_channels, 1)


def unidepth_shapes(cfg, n_tokens, kind="unidepth"):
    """{name: shape} of an upstream UniDepth-V2 (kind "unidepth") or
    UniK3D ("unik3d") state dict (the layouts of convert_unidepth /
    convert_unik3d) at a grid of n_tokens patches."""
    v = cfg.vit
    s = dinov2_shapes("backbone.", v.embed_dim, v.depth, n_tokens,
                      v.patch_size)
    if kind == "unik3d":
        _token_decoder_shapes(s, "angular.", cfg, cfg.num_angular_blocks,
                              False)
        _layer(s, "angular.out", 3, cfg.dim)
        _token_decoder_shapes(s, "radius.", cfg, cfg.num_blocks, True)
        _pixel_head_shapes(s, "radius.", cfg)
        return s
    _layer(s, "camera.in_proj", cfg.dim, v.embed_dim)
    s["camera.queries"] = (cfg.num_cam_queries, cfg.dim)
    for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _layer(s, "camera." + n, cfg.dim, cfg.dim)
    _layer(s, "camera.mlp1", cfg.camera_hidden,
           cfg.num_cam_queries * cfg.dim)
    _layer(s, "camera.mlp2", 4, cfg.camera_hidden)
    _token_decoder_shapes(s, "depth.", cfg, cfg.num_blocks, True)
    _pixel_head_shapes(s, "depth.", cfg)
    return s


def dinov2_hf_shapes(prefix, d, depth, n_tokens, patch):
    """{name: shape} of an HF transformers Dinov2Model state dict."""
    e = prefix + "embeddings."
    s = {e + "cls_token": (1, 1, d), e + "mask_token": (1, d),
         e + "position_embeddings": (1, n_tokens + 1, d),
         e + "patch_embeddings.projection.weight": (d, 3, patch, patch),
         e + "patch_embeddings.projection.bias": (d,),
         prefix + "layernorm.weight": (d,), prefix + "layernorm.bias": (d,)}
    for i in range(depth):
        b = f"{prefix}encoder.layer.{i}."
        for n in ("norm1", "norm2"):
            s[f"{b}{n}.weight"] = s[f"{b}{n}.bias"] = (d,)
        for n in ("query", "key", "value"):
            _layer(s, f"{b}attention.attention.{n}", d, d)
        _layer(s, b + "attention.output.dense", d, d)
        s[b + "layer_scale1.lambda1"] = s[b + "layer_scale2.lambda1"] = (d,)
        _layer(s, b + "mlp.fc1", 4 * d, d)
        _layer(s, b + "mlp.fc2", d, 4 * d)
    return s


def depthpro_hf_shapes(cfg):
    """{name: shape} of an HF DepthProForDepthEstimation state dict (the
    layout of convert_depthpro_hf; apple/DepthPro-hf at DEPTHPRO_L)."""
    v = cfg.vit
    d, fh = v.embed_dim, cfg.fusion_hidden_size
    n = cfg.out_size ** 2
    s = {}
    for enc in ("depth_pro.encoder.patch_encoder.model.",
                "depth_pro.encoder.image_encoder.model.",
                "fov_model.fov_encoder.model."):
        s.update(dinov2_hf_shapes(enc, d, v.depth, n, v.patch_size))
    up = "depth_pro.neck.feature_upsample."
    sd, idims = cfg.scaled_images_feature_dims, cfg.intermediate_feature_dims
    _layer(s, up + "image_block.layers.0", sd[0], d, 2, transpose=True)
    for i, dim in enumerate(sd):
        b = f"{up}scaled_images.{i}.layers"
        _layer(s, b + ".0", dim, d, 1, bias=False)
        _layer(s, b + ".1", dim, dim, 2, bias=False, transpose=True)
    for i, dim in enumerate(idims):
        b = f"{up}intermediate.{i}.layers"
        ch = fh if i == 0 else dim
        _layer(s, b + ".0", ch, d, 1, bias=False)
        for j in range(2 + i):
            _layer(s, f"{b}.{j + 1}", dim, ch if j == 0 else dim, 2,
                   bias=False, transpose=True)
    _layer(s, "depth_pro.neck.fuse_image_with_low_res", sd[0], 2 * sd[0], 1)
    dims = list(sd) + list(idims)
    for i, dim in enumerate(dims):
        if not (i == len(dims) - 1 and dim == fh):
            _layer(s, f"depth_pro.neck.feature_projection.projections.{i}",
                   fh, dim, 3, bias=False)
    for i in range(len(dims)):
        fl = (f"fusion_stage.intermediate.{i}" if i < len(dims) - 1
              else "fusion_stage.final")
        for r in ("residual_layer1", "residual_layer2"):
            for c in ("convolution1", "convolution2"):
                _layer(s, f"{fl}.{r}.{c}", fh, fh, 3)
        if i < len(dims) - 1:
            _layer(s, fl + ".deconv", fh, fh, 2, bias=False, transpose=True)
        _layer(s, fl + ".projection", fh, fh, 1)
    _layer(s, "head.layers.0", fh // 2, fh, 3)
    _layer(s, "head.layers.1", fh // 2, fh // 2, 2, transpose=True)
    _layer(s, "head.layers.2", 32, fh // 2, 3)
    _layer(s, "head.layers.4", 1, 32, 1)
    _layer(s, "fov_model.fov_encoder.neck", fh // 2, d)
    _layer(s, "fov_model.conv", fh // 2, fh, 3)
    ch = fh // 2
    for i in range(cfg.num_fov_head_layers):
        out = -(-fh // 2 ** (i + 2))
        _layer(s, f"fov_model.head.layers.{2 * i}", out, ch, 3)
        ch = out
    fk = int((cfg.out_size - 1) / 2 ** cfg.num_fov_head_layers + 1)
    _layer(s, f"fov_model.head.layers.{2 * cfg.num_fov_head_layers}", 1, ch,
           fk)
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
    near 1, layer scales 1, small biases, batch-norm variances 1 + 0.1 |N|,
    N(0, 0.02) embeddings, modulations and running means."""
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
        elif leaf == "running_var":
            x = 1.0 + 0.1 * x.abs()
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


# ------------------------------------------------ phase: single_frame ----

SF_FRAMES = 16          # phase 3's first 16 frames: one batch of 16
SF_DEPTHPRO_FRAMES = 4  # (a) DepthPro-L: one micro-batch (its file's load
                        # and the codecs hold its wall, not the frames)
SF_MOVIE_FRAMES = 40    # (f): the movie's step 2 on one 40-frame scene
SF_SEED = 12
# MoGe-L through B4 against the same weights through SDPA, both bfloat16:
# largest and mean absolute difference of the raw point map (before the
# focal solve) as a share of its largest magnitude; the DA3 bounds
SF_ROUTE_MAX, SF_ROUTE_MEAN = DA3_ROUTE_MAX, DA3_ROUTE_MEAN


def profile_batch(tag, eng, frames, card):
    """One batch of ``eng`` timed unprofiled, then under torch.profiler:
    -> {wall_ms, device_ms, busy, top}; logs the top 5 device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.infer_video(frames)
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:   # device only
        eng.infer_video(frames)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    log(f"[single_frame] ({card}) {tag}: one batch of {len(frames)} frames "
        f"{wall:.3f} ms unprofiled, device busy {busy:.3f} ms "
        f"({busy / wall:.1%}); top device operations:")
    for e in top:
        ms = e.self_device_time_total / 1e3
        log(f"[single_frame]   {ms:9.3f} ms {ms / max(busy, 1e-9):6.1%} "
            f"x{e.count:<5d} {e.key[:100]}")
    return {"wall_ms": wall, "device_ms": busy, "busy": busy / wall,
            "top": [[e.key[:100], e.self_device_time_total / 1e3]
                    for e in top]}


def check_depth_file(tag, path, n, max_depth=100.0, constant=False,
                     phase="single_frame", hw=None):
    """The depth video's frames, shape and range (not one value unless
    ``constant`` may be: a seeded stand-in's point map may face away from
    the camera everywhere) -> (T, H, W) depth."""
    import numpy as np

    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    with vio.DepthVideoReader(path, max_depth) as r:
        depth = r.read_depth_batch(1 << 30)
    if depth.shape != (n,) + tuple(hw or (H, W)) \
            or not np.isfinite(depth).all() \
            or depth.min() < 0 or depth.max() > max_depth \
            or (depth.max() == depth.min() and not constant):
        raise RuntimeError(f"{phase} {tag}: depth {depth.shape}, "
                           f"{depth.min()}..{depth.max()}")
    return depth


def check_xfovs(tag, path, n):
    """The ``_xfovs.json`` sidecar: n finite FOVs in (0, 180] (seeded
    weights' point maps reproject onto nothing, and their focal solve may
    end at f -> 0, 180 degrees) -> range."""
    import numpy as np

    from metric_depth_video_toolbox_tpu_torch.io import sidecar

    x = sidecar.load_xfovs(path)
    if x.shape != (n,) or not np.isfinite(x).all() or not (
            (x > 0) & (x <= 180)).all():
        raise RuntimeError(f"single_frame {tag}: xfovs {x}")
    return [float(x.min()), float(x.max())]


def phase_single_frame(frames, sbs, dev, zero_counts, counts, expect_counts,
                       card):
    """The single-frame engines (after the earlier phases' models are
    freed), file to file through cli/main.py on phase 3's first 16 1080p
    frames: (a) ``engine moge``, ``unik3d``, ``unidepth --xfov 60`` and
    ``depthpro`` at their _L presets with ``--checkpoint`` on a file
    converted from a seeded upstream-layout state dict (each: wall,
    frames/s, peak memory, the xfovs range, one batch under torch.profiler;
    no kernel of the repo: SDPA); (b) the stand-ins at the CLI's defaults
    (vits, no checkpoint) for moge, unik3d and depthpro; (c) MoGe-L with
    ``attention_impl="flash_packed"`` (B4: 24 launches a batch of 16, the
    first held against the plain version and timed beside SDPA on the real
    tokens; the raw point map held against the SDPA route); (d) ``engine
    videoanythingmetric`` bit-equal to ``depth --profile DIR`` with the
    same flags, and a trace in DIR; (e) ``split-sbs`` on phase 4's SBS
    frames and ``inpaint`` on the clip; (f) the movie's two-pass step 2
    with ``engine="moge"`` (the stand-in) on one 40-frame scene. -> numbers
    """
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("single_frame: OpenCV (cv2) is not installed; "
                           "the commands read and write video files") from e
    import dataclasses
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import convert
    from metric_depth_video_toolbox_tpu_torch.models import depth_anything
    from metric_depth_video_toolbox_tpu_torch.models import depthpro
    from metric_depth_video_toolbox_tpu_torch.models import moge
    from metric_depth_video_toolbox_tpu_torch.models import unidepth
    from metric_depth_video_toolbox_tpu_torch.ops import \
        attention_packed as apk
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie

    t_phase = time.perf_counter()
    n = SF_FRAMES
    clip16 = frames[:n]
    work = depth_anything.working_resolution(H, W, 518, 14)
    n_tok = (work[0] // 14) * (work[1] // 14)
    gen = torch.Generator(device=dev).manual_seed(SF_SEED)
    res = {"real": {}, "stand_in": {}}

    # the engine a command builds, kept for its profile
    built = []
    make = dstage._ENGINE_CLASSES["single_frame"]

    def keep(**kw):
        built.append(make(**kw))
        return built[-1]
    dstage._ENGINE_CLASSES["single_frame"] = keep

    def command(tag, argv):
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts(f"single_frame {tag}", {}, "SDPA attention: no "
                      "kernel of the repo")
        return wall, torch.cuda.max_memory_allocated() / 2**30

    try:
        with tempfile.TemporaryDirectory() as tmp:
            clip = os.path.join(tmp, "clip.mkv")
            vio.save_rgb_video(clip16, clip, 24)

            # (a) the real graphs from converted files
            real = (("moge", "moge", moge.MOGE_L,
                     moge_shapes(moge.MOGE_L, n_tok), []),
                    ("unik3d", "unik3d", unidepth.UNIDEPTH_L,
                     unidepth_shapes(unidepth.UNIDEPTH_L, n_tok, "unik3d"),
                     []),
                    ("unidepth", "unidepth", unidepth.UNIDEPTH_L,
                     unidepth_shapes(unidepth.UNIDEPTH_L, n_tok),
                     ["--xfov", "60"]),
                    ("depthpro", "depthpro_hf", depthpro.DEPTHPRO_L,
                     depthpro_hf_shapes(depthpro.DEPTHPRO_L), []))
            moge_tree = None
            for name, kind, cfg, shapes, extra in real:
                t0 = time.perf_counter()
                pth = os.path.join(tmp, f"{name}.pth")
                sd = upstream_state_dict(shapes, gen, dev)
                if kind == "depthpro_hf":
                    # seeded heads put the canonical inverse depth and the
                    # FOV near 0: the ReLU and the FOV scale would leave no
                    # depth; their last biases at a trained model's scale
                    sd["head.layers.4.bias"].fill_(1.0)
                    sd[f"fov_model.head.layers.{2 * cfg.num_fov_head_layers}"
                       ".bias"].fill_(60.0)
                elif kind == "unik3d":
                    # the ray field's bias forward, as the JAX package's
                    # init sets it: seeded rays may all face backwards
                    sd["angular.out.bias"] = torch.tensor([0.0, 0.0, 1.0])
                n_params = sum(v.numel() for v in sd.values())
                torch.save(sd, pth)
                del sd
                tree = convert.convert_torch_file(pth, kind, cfg)
                os.remove(pth)
                ckpt = os.path.join(tmp, f"{name}.msgpack")
                convert.save_checkpoint(ckpt, tree)
                conv_s = time.perf_counter() - t0
                if name == "moge":
                    moge_tree = tree
                del tree
                built.clear()
                m_run = SF_DEPTHPRO_FRAMES if name == "depthpro" else n
                clip_run = clip
                if m_run != n:
                    clip_run = os.path.join(tmp, f"clip{m_run}.mkv")
                    vio.save_rgb_video(clip16[:m_run], clip_run, 24)
                wall, peak = command(f"(a) {name}", [
                    "engine", name, "--color_video", clip_run,
                    "--checkpoint", ckpt, "--model_size", "vitl", *extra])
                eng = built[0]
                if eng.graph is None or eng.graph[0] != name:
                    raise RuntimeError(f"single_frame (a) {name}: the "
                                       f"engine ran {eng.graph}, not the "
                                       f"real graph")
                out = clip_run + "_depth.mkv"
                depth = check_depth_file(f"(a) {name}", out, m_run)
                r = {"params_m": n_params / 1e6,
                     "file_gib": os.path.getsize(ckpt) / 2**30,
                     "convert_write_s": conv_s, "wall_s": wall,
                     "frames": m_run, "fps": m_run / wall, "peak_gib": peak,
                     "depth_m": [float(depth.min()), float(depth.max())]}
                if os.path.exists(out + "_xfovs.json"):
                    r["xfovs"] = check_xfovs(f"(a) {name}",
                                             out + "_xfovs.json", m_run)
                    os.remove(out + "_xfovs.json")
                os.remove(out)
                os.remove(ckpt)
                log(f"[single_frame] ({card}) (a) engine {name} "
                    f"--checkpoint on {m_run} frames ("
                    f"{r['params_m']:.1f} M parameters, "
                    f"{r['file_gib']:.2f} GiB file, seeded, converted and "
                    f"written in {conv_s:.3f} s): {wall:.3f} s, "
                    f"{r['fps']:.3f} frames/s, peak {peak:.2f} GiB, depth "
                    f"{r['depth_m'][0]:.3f}..{r['depth_m'][1]:.3f} m, xfovs "
                    f"{r.get('xfovs', 'none (not written)')}")
                r["profile"] = profile_batch(f"(a) {name}", eng,
                                             clip16[:m_run], card)
                res["real"][name] = r
                del eng, depth
                built.clear()
                gc.collect()
                torch.cuda.empty_cache()

            # (b) the stand-ins at the CLI's defaults
            for name in ("moge", "unik3d", "depthpro"):
                wall, peak = command(f"(b) {name}", [
                    "engine", name, "--color_video", clip])
                if built[-1].graph is not None:
                    raise RuntimeError(f"single_frame (b) {name}: a real "
                                       f"graph without a checkpoint")
                out = clip + "_depth.mkv"
                depth = check_depth_file(f"(b) {name}", out, n,
                                         constant=True)
                xf = check_xfovs(f"(b) {name}", out + "_xfovs.json", n)
                os.remove(out)
                os.remove(out + "_xfovs.json")
                res["stand_in"][name] = {
                    "wall_s": wall, "fps": n / wall, "peak_gib": peak,
                    "xfovs": xf,
                    "depth_m": [float(depth.min()), float(depth.max())]}
                log(f"[single_frame] ({card}) (b) engine {name} (stand-in, "
                    f"vits 518): {wall:.3f} s, {n / wall:.3f} frames/s, "
                    f"peak {peak:.2f} GiB, depth {depth.min():.3f}.."
                    f"{depth.max():.3f} m, xfovs {xf}")
                del depth
                built.clear()
            gc.collect()
            torch.cuda.empty_cache()

            # (c) MoGe-L through B4: its launches, its first launch against
            # the plain version, the raw point map against the SDPA route
            b4cfg = dataclasses.replace(moge.MOGE_L, vit=dataclasses.replace(
                moge.MOGE_L.vit, attention_impl="flash_packed"))
            engines = {impl: dstage.SingleFrameEngine(
                size="vitl", params=moge_tree, variant="moge",
                moge_cfg=c, device=dev)
                for impl, c in (("flash_packed", b4cfg),
                                ("sdpa", moge.MOGE_L))}
            del moge_tree
            engines["flash_packed"].infer_video(clip16[:2])     # warm-up
            launch = apk.packed_flash_attention
            held = []

            def first(*args):
                if not held:
                    held.append(tuple(a.clone() if torch.is_tensor(a)
                                      else a for a in args))
                return launch(*args)
            apk.packed_flash_attention = first
            try:
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d_b4 = engines["flash_packed"].infer_video(clip16)
                b4_wall = time.perf_counter() - t0
            finally:
                apk.packed_flash_attention = launch
            blocks = moge.MOGE_L.vit.depth
            b4_launches = counts()["packed_flash_attention"]
            expect_counts("single_frame (c) MoGe-L flash_packed",
                          {"packed_flash_attention": blocks},
                          f"1 batch of {n} frames x {blocks} blocks")
            x = dstage._resize_frames(torch.as_tensor(clip16, device=dev),
                                      work)
            with torch.no_grad():
                raw = {impl: eng.model(work)(x)[0].float()
                       for impl, eng in engines.items()}
            diff = (raw["flash_packed"] - raw["sdpa"]).abs()
            scale = float(raw["sdpa"].abs().max())
            route = {"max": float(diff.max()) / scale,
                     "mean": float(diff.mean()) / scale}
            d_sdpa = engines["sdpa"].infer_video(clip16)
            del raw, diff, x
            engines.clear()
            gc.collect()
            torch.cuda.empty_cache()
            if not (route["max"] <= SF_ROUTE_MAX
                    and route["mean"] <= SF_ROUTE_MEAN):
                raise RuntimeError(f"single_frame (c): B4 vs SDPA point "
                                   f"map {route} (limits {SF_ROUTE_MAX}, "
                                   f"{SF_ROUTE_MEAN})")
            qkv4, valid, heads, sm = held[0]
            out = apk.packed_flash_attention(qkv4, valid, heads, sm)
            ref = apk.packed_flash_attention_plain(qkv4.float(), valid,
                                                   heads, sm)
            torch.cuda.synchronize()
            kb = {"shape": f"({qkv4.shape[0]}, {qkv4.shape[1]}, "
                           f"{qkv4.shape[2]}, {qkv4.shape[3]}) "
                           f"{str(qkv4.dtype).split('.')[-1]}, "
                           f"{int(valid.sum())} real tokens",
                  "launches": b4_launches,
                  "max_abs_err": float((out[:, valid].float()
                                        - ref[:, valid]).abs().max()),
                  "error_ratio": apk.error_ratio(out[:, valid],
                                                 ref[:, valid])}
            if not kb["error_ratio"] <= 1 or not bool(
                    torch.isfinite(out).all()):
                raise RuntimeError(f"single_frame (c): B4's first launch: "
                                   f"kernel vs plain {kb}")
            del out, ref
            b, nn_, _, d = qkv4.shape
            kb["ms"] = gpu_ms(lambda: apk.packed_flash_attention(
                qkv4, valid, heads, sm), 10)
            kb["plain_ms"] = gpu_ms(lambda: apk.packed_flash_attention_plain(
                qkv4, valid, heads, sm), 1)
            nbytes, ops = packed_work(valid, b, heads, d, 2)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_TC_OPS_PER_S
            kb.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                      bound_by="bytes" if t_bytes >= t_ops else "operations",
                      bytes=nbytes, ops=ops)
            # the SDPA route's own call: the real tokens only, no mask
            q, k, v = qkv4[:, valid].reshape(b, -1, 3, heads, d).permute(
                2, 0, 3, 1, 4).unbind(0)
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION]):
                kb["library_ms"] = gpu_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v,
                                                           scale=sm), 10)
            del q, k, v, held[:]
            kb.update(route_max=route["max"], route_mean=route["mean"],
                      batch_wall_s=b4_wall,
                      depth_max_abs_diff=float(np.abs(d_b4 - d_sdpa).max()))
            res["b4"] = kb
            log(f"[single_frame] ({card}) (c) MoGe-L flash_packed, one batch "
                f"of {n} frames in {b4_wall:.3f} s: B4 launches "
                f"{b4_launches}; first launch {kb['shape']}: kernel vs plain "
                f"(float32) max abs err {kb['max_abs_err']:.3e}, error ratio "
                f"{kb['error_ratio']:.3f} (limit 1); kernel {kb['ms']:.3f} "
                f"ms, plain {kb['plain_ms']:.3f} ms, SDPA on the real tokens "
                f"{kb['library_ms']:.3f} ms, bound {kb['bound_ms']:.3f} ms "
                f"({kb['bound_by']}: {ops / 1e12:.3f} TFLOP bf16, "
                f"{nbytes / 1e6:.1f} MB); raw point map vs SDPA: max "
                f"{route['max']:.3e}, mean {route['mean']:.3e} of its "
                f"largest (limits {SF_ROUTE_MAX}, {SF_ROUTE_MEAN}); depth "
                f"max abs diff {kb['depth_max_abs_diff']:.3f} m")

            # (d) engine videoanythingmetric = depth, and depth --profile
            a = os.path.join(tmp, "vam.mkv")
            b_ = os.path.join(tmp, "dep.mkv")
            for path in (a, b_):
                os.link(clip, path)
            trace_dir = os.path.join(tmp, "trace")
            wall_v, _ = command("(d) engine videoanythingmetric",
                                ["engine", "videoanythingmetric",
                                 "--color_video", a])
            wall_d, _ = command("(d) depth --profile",
                                ["depth", "--color_video", b_, "--profile",
                                 trace_dir])
            with vio.VideoReader(a + "_depth.mkv") as r:
                got = r.read_all()
            with vio.VideoReader(b_ + "_depth.mkv") as r:
                want = r.read_all()
            if got.shape != (n, H, W, 3) or not np.array_equal(got, want):
                raise RuntimeError("single_frame (d): engine "
                                   "videoanythingmetric != depth")
            traces = [f for f in os.listdir(trace_dir)
                      if f.endswith(".json")]
            if len(traces) != 1:
                raise RuntimeError(f"single_frame (d): traces {traces}")
            res["vda_alias"] = {"videoanythingmetric_s": wall_v,
                                "depth_profile_s": wall_d,
                                "trace_bytes": os.path.getsize(
                                    os.path.join(trace_dir, traces[0]))}
            log(f"[single_frame] ({card}) (d) engine videoanythingmetric "
                f"{wall_v:.3f} s == depth --profile {wall_d:.3f} s, bit for "
                f"bit; trace {res['vda_alias']['trace_bytes'] / 2**20:.1f} "
                f"MiB")

            # (e) split-sbs on phase 4's SBS frames, inpaint on the clip
            sbs_path = os.path.join(tmp, "sbs.mkv")
            vio.save_rgb_video(sbs[:n], sbs_path, 24)
            wall, _ = command("(e) split-sbs", ["split-sbs", "--sbs_video",
                                                sbs_path])
            for suffix, half in (("_left.mkv", sbs[:n, :, :W]),
                                 ("_right.mkv", sbs[:n, :, W:])):
                with vio.VideoReader(sbs_path + suffix) as r:
                    if not np.array_equal(r.read_all(), half):
                        raise RuntimeError(f"single_frame (e): {suffix} is "
                                           f"not the SBS half")
            res["split_sbs_s"] = wall
            mask = np.zeros((H, W), np.uint8)
            mask[H - 160:H - 40, W - 420:W - 60] = 255    # a corner logo
            mask_path = os.path.join(tmp, "overlay.png")
            cv2.imwrite(mask_path, mask)
            wall_i, _ = command("(e) inpaint", [
                "inpaint", "--color_video", clip, "--overlay_mask",
                mask_path])
            with vio.VideoReader(clip + "_inpainted.mkv") as r:
                filled = r.read_all()
            hole = mask > 16
            if filled.shape != clip16.shape or not np.array_equal(
                    filled[:, ~hole], clip16[:, ~hole]) or np.array_equal(
                    filled[:, hole], clip16[:, hole]):
                raise RuntimeError("single_frame (e): inpaint output")
            res["inpaint_s"] = wall_i
            log(f"[single_frame] ({card}) (e) split-sbs {n} frames of "
                f"{2 * W}x{H}: {wall:.3f} s, halves bit-equal; inpaint {n} "
                f"frames (a {int(hole.sum())}-pixel overlay, 96 iterations):"
                f" {wall_i:.3f} s")

            # (f) the movie's two-pass step 2 on one 40-frame scene
            m = SF_MOVIE_FRAMES
            scene = os.path.join(tmp, "movie", "scene_1.mkv")
            vio.save_rgb_video(frames[:m], scene, 24)
            scenes = [{"Scene Number": "1", "finished": False,
                       "scene_video_file": scene,
                       "depth_video_file": scene + "_depth.mkv"}]
            zero_counts()
            t0 = time.perf_counter()
            movie.step2_estimate_depth(scenes, engine="moge",
                                       engine_kwargs={"size": "vits",
                                                      "input_size": 518},
                                       device=dev)
            wall = time.perf_counter() - t0
            expect_counts("single_frame (f) movie step 2", {},
                          "SDPA attention: no kernel of the repo")
            check_depth_file("(f)", scene + "_depth.mkv", m)
            xf = check_xfovs("(f)", scene + "_depth.mkv_xfovs.json", m)
            if xf[0] != xf[1]:
                raise RuntimeError(f"single_frame (f): the second pass is "
                                   f"not locked to one FOV: {xf}")
            res["movie_step2"] = {"frames": m, "wall_s": wall,
                                  "fps": m / wall, "xfov": xf[0]}
            log(f"[single_frame] ({card}) (f) movie step 2, moge stand-in "
                f"(vits), {m} frames: {wall:.3f} s, {m / wall:.3f} frames/s "
                f"(two passes), locked at xfov {xf[0]:.3f}")
    finally:
        dstage._ENGINE_CLASSES["single_frame"] = make
    res["s"] = time.perf_counter() - t_phase
    log(f"[single_frame] ({card}) phase: {res['s']:.3f} s")
    return res



# ----------------------------------------------- phase: depth_engines ----

DE_FRAMES = 40          # phase 3's clip: (a), (b), (e), (f)
DE_SHORT = 16           # phase 3's first 16 frames: (c), (d)
DE_SEED = 13
DE_PROMPT_HW = (144, 256)       # (d): the low-resolution depth prompt
DE_GC_WORK = (384, 640)         # (b): GeometryCrafter's working size
# (e): int8 against bfloat16 matmuls in the ViT, the same seeded VDA-S on
# the same 40 frames: largest and mean absolute difference of the relative
# disparity (what the matmuls make) as a share of its largest. The metric
# depth files are compared too, not gated: with seeded weights the metric
# anchor is near zero and the fit amplifies any difference (15% between
# the two packages in bfloat16, tests/test_torch_depth_engine.py).
DE_QUANT_MAX, DE_QUANT_MEAN = 0.25, 0.05
# card vs CPU at the tiny presets in float32: largest difference as a share
# of the largest value; the int8 route within its code-flip budget (a
# float32 difference moves an int8 code by one step; tests/test_torch_quant)
DE_REF_TOL, DE_REF_QUANT_MAX, DE_REF_QUANT_MEAN = 1e-4, 2e-2, 1e-3


def depthcrafter_work_hw(h, w, max_res=768):
    """DepthCrafter's working size: the long side at most ``max_res``,
    each side rounded to a multiple of 64 (1080p: 448 x 768)."""
    s = min(1.0, max_res / max(h, w))
    return (max(64, int(round(h * s / 64)) * 64),
            max(64, int(round(w * s / 64)) * 64))


def svd_vae_shapes(cfg):
    """{name: shape} of an upstream diffusers AutoencoderKLTemporalDecoder
    state dict at ``cfg`` (the layout of convert_svd_vae; GeometryCrafter's
    PMapAutoencoderKLTemporalDecoder at PMAP_VAE)."""
    s = {}
    boc, lat, oc = cfg.block_out_channels, cfg.latent_channels, \
        cfg.out_channels

    def norm(name, c):
        s[name + ".weight"] = s[name + ".bias"] = (c,)

    def res2d(p, cin, cout):
        norm(p + ".norm1", cin)
        _layer(s, p + ".conv1", cout, cin, 3)
        norm(p + ".norm2", cout)
        _layer(s, p + ".conv2", cout, cout, 3)
        if cin != cout:
            _layer(s, p + ".conv_shortcut", cout, cin, 1)

    def st_res(p, cin, cout):
        res2d(p + ".spatial_res_block", cin, cout)
        t = p + ".temporal_res_block"
        for i in (1, 2):
            norm(f"{t}.norm{i}", cout)
            s[f"{t}.conv{i}.weight"] = (cout, cout, 3, 1, 1)
            s[f"{t}.conv{i}.bias"] = (cout,)
        s[p + ".time_mixer.mix_factor"] = (1,)

    def attn(p, c):
        norm(p + ".group_norm", c)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            _layer(s, f"{p}.{n}", c, c)

    _layer(s, "encoder.conv_in", boc[0], 3, 3)
    cin = boc[0]
    for i, ch in enumerate(boc):
        for j in range(cfg.layers_per_block):
            res2d(f"encoder.down_blocks.{i}.resnets.{j}", cin, ch)
            cin = ch
        if i < len(boc) - 1:
            _layer(s, f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch,
                   3)
    for j in (0, 1):
        res2d(f"encoder.mid_block.resnets.{j}", cin, cin)
    attn("encoder.mid_block.attentions.0", cin)
    norm("encoder.conv_norm_out", cin)
    _layer(s, "encoder.conv_out", 2 * lat, cin, 3)
    _layer(s, "quant_conv", 2 * lat, 2 * lat, 1)
    ch = boc[-1]
    _layer(s, "decoder.conv_in", ch, lat, 3)
    for j in range(cfg.layers_per_block):
        st_res(f"decoder.mid_block.resnets.{j}", ch, ch)
    attn("decoder.mid_block.attentions.0", ch)
    for k in range(len(boc)):
        i = len(boc) - 1 - k
        for j in range(cfg.layers_per_block + 1):
            st_res(f"decoder.up_blocks.{k}.resnets.{j}", ch, boc[i])
            ch = boc[i]
        if i > 0:
            _layer(s, f"decoder.up_blocks.{k}.upsamplers.0.conv", ch, ch, 3)
    norm("decoder.conv_norm_out", ch)
    _layer(s, "decoder.conv_out", oc, ch, 3)
    s["decoder.time_conv_out.weight"] = (oc, oc, 3, 1, 1)
    s["decoder.time_conv_out.bias"] = (oc,)
    return s


def promptda_hf_shapes(vit, dpt, n_tokens, head_hidden=32):
    """{name: shape} of an HF PromptDepthAnythingForDepthEstimation state
    dict (the layout of convert_promptda_hf) with the port's PromptDA
    widths: the DINOv2 backbone, the neck at ``dpt.out_channels`` and
    ``dpt.features``, the head, and each fusion level's prompt branch."""
    d, f = vit.embed_dim, dpt.features
    s = dinov2_hf_shapes("backbone.", d, vit.depth, n_tokens,
                         vit.patch_size)
    r = "neck.reassemble_stage.layers"
    for i, ch in enumerate(dpt.out_channels):
        _layer(s, f"{r}.{i}.projection", ch, d, 1)
        s[f"neck.convs.{i}.weight"] = (f, ch, 3, 3)
    _layer(s, f"{r}.0.resize", dpt.out_channels[0], dpt.out_channels[0], 4,
           transpose=True)
    _layer(s, f"{r}.1.resize", dpt.out_channels[1], dpt.out_channels[1], 2,
           transpose=True)
    _layer(s, f"{r}.3.resize", dpt.out_channels[3], dpt.out_channels[3], 3)
    for i in range(4):
        fl = f"neck.fusion_stage.layers.{i}"
        _layer(s, fl + ".projection", f, f, 1)
        for rl in ("residual_layer1", "residual_layer2"):
            for c in ("convolution1", "convolution2"):
                _layer(s, f"{fl}.{rl}.{c}", f, f, 3)
        pl = fl + ".prompt_depth_layer"
        _layer(s, pl + ".convolution1", f, 1, 3)
        _layer(s, pl + ".convolution2", f, f, 3)
        _layer(s, pl + ".convolution3", f, f, 3)
    _layer(s, "head.conv1", f // 2, f, 3)
    _layer(s, "head.conv2", head_hidden, f // 2, 3)
    _layer(s, "head.conv3", 1, head_hidden, 1)
    return s


def profile_fn(phase, tag, fn, card):
    """``fn()`` once under torch.profiler, recording the device's activity
    alone (the host's operator events would cost the tracer's teardown
    more than the call) -> {wall_ms, device_ms, busy, top}: the busy
    share is device time over the profiled call's wall; logs the top 5
    device ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    log(f"[{phase}] ({card}) {tag}: {wall:.3f} ms profiled ("
        f"{time.perf_counter() - t_all:.1f} s with the tracer's setup and "
        f"teardown), device busy {busy:.3f} ms ({busy / wall:.1%}); top "
        f"device operations:")
    for e in top:
        ms = e.self_device_time_total / 1e3
        log(f"[{phase}]   {ms:9.3f} ms {ms / max(busy, 1e-9):6.1%} "
            f"x{e.count:<5d} {e.key[:100]}")
    return {"wall_ms": wall, "device_ms": busy, "busy": busy / wall,
            "top": [[e.key[:100], e.self_device_time_total / 1e3]
                    for e in top]}


def phase_reference_depth_engines(dev, card):
    """Each new engine at its tiny preset in float32, on the card and on the
    CPU with the same weights (drawn on the CPU) and the same noise: the
    DepthCrafter and GeometryCrafter (point-map VAE) engines, MVSNet,
    PromptDA and the int8 VDA. -> {name: largest difference share}"""
    import dataclasses

    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import depth_anything
    from metric_depth_video_toolbox_tpu_torch.models import diffusion as dif
    from metric_depth_video_toolbox_tpu_torch.models import from_jax
    from metric_depth_video_toolbox_tpu_torch.models import promptda
    from metric_depth_video_toolbox_tpu_torch.models import svd
    from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage

    rng = np.random.default_rng(DE_SEED)
    frames = rng.integers(0, 256, (6, 40, 64, 3), np.uint8)
    yy, xx = np.mgrid[0:40, 0:64] / 64.0
    depth = np.stack([3.0 + np.sin(3 * xx + 0.2 * t) * np.cos(2 * yy)
                      for t in range(6)]).astype(np.float32)
    out = {}

    def held(name, a, b, limit=DE_REF_TOL):
        a, b = np.asarray(a), np.asarray(b)
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-9))
        out[name] = err
        log(f"[reference] ({card}) {name}, card vs CPU: max err {err:.3e} "
            f"of the largest (limit {limit})")
        if not np.isfinite(a).all() or a.shape != b.shape or err > limit:
            raise RuntimeError(f"reference: the card's {name} disagrees "
                               f"with the CPU's ({err})")

    # the diffusion engines: SVD_TINY DepthCrafter, two windows, prompted;
    # DIFFUSION_TINY GeometryCrafter with the point-map VAE
    pvae = {}
    for part, mod in (("encoder", svd.SVDVAEEncoder(svd.PMAP_VAE_TINY)),
                      ("decoder", svd.SVDVAEDecoder(svd.PMAP_VAE_TINY))):
        dif.init_weights(mod, torch.Generator().manual_seed(4))
        pvae[part] = {"params": from_jax.to_flax_params(mod)}
    cases = (("DepthCrafter SVD_TINY, prompted", dstage.DepthCrafterEngine,
              dict(cfg=svd.SVD_TINY, vae_cfg=svd.SVD_VAE_TINY,
                   work_hw=(32, 64), use_depth_prompting=True), (4, 16, 32)),
             ("GeometryCrafter DIFFUSION_TINY, PMAP_VAE_TINY",
              dstage.GeometryCrafterEngine,
              dict(work_hw=(64, 128), pmap_vae_params=pvae,
                   pmap_vae_cfg=svd.PMAP_VAE_TINY), (4, 8, 16)))
    for name, cls, kw, lat in cases:
        cpu = cls(window=4, overlap=2, device="cpu", **kw)
        on_card = cls(window=4, overlap=2, device=dev,
                      params=cpu.model.state_dict(), **kw)
        g = torch.Generator().manual_seed(5)
        noise = [torch.randn(lat + (4,), generator=g) for _ in range(2)]
        held(name, on_card.infer_video(frames, depth, noise=noise),
             cpu.infer_video(frames, depth, noise=noise))

    # MVS_TINY in float32: window 3, batches of 2, the rescale
    tfs = camera_path(6)
    engines = []
    for where in ("cpu", dev):
        eng = dstage.MVSEngine(size="tiny", window=3, resize_w=64, batch=2,
                               rescale_to_cost_volume=True, device=where,
                               params=engines[0].model.state_dict()
                               if engines else None)
        eng.cfg = dataclasses.replace(eng.cfg, dtype="float32")
        engines.append(eng)
    held("MVSEngine MVS_TINY, rescaled", engines[1].infer_video(
        frames, tfs, 60.0), engines[0].infer_video(frames, tfs, 60.0))

    # PromptDA at PROMPT_TINY in float32
    c = promptda.PROMPT_TINY
    cfg = dataclasses.replace(c, vit=dataclasses.replace(c.vit,
                                                         dtype="float32"),
                              dpt=dataclasses.replace(c.dpt, dtype="float32"))
    cpu = vit_mod.seeded_init(promptda.PromptDA(cfg, (28, 56)),
                              torch.Generator().manual_seed(6)).eval()
    on_card = promptda.PromptDA(cfg, (28, 56)).to(dev).eval()
    on_card.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(frames[:3, :28, :56]).float() / 255.0
    p = torch.from_numpy(depth[:3, :12, :16])
    with torch.no_grad():
        held("PromptDA PROMPT_TINY", on_card(x.to(dev), p.to(dev)).cpu(),
             cpu(x, p))

    # the int8 VDA at vitt, float32, against a reference depth
    kw = dict(size="vitt", fp32=True, quantize="int8", input_size=28,
              window=6)
    cpu = dstage.VDAEngine(device="cpu", **kw)
    model, anchor = cpu.models(depth_anything.working_resolution(
        40, 64, 28, 14))
    on_card = dstage.VDAEngine(device=dev, params=model.state_dict(),
                               anchor_params=anchor.state_dict(), **kw)
    a = on_card.infer_video(frames, reference_depth=depth)
    b = cpu.infer_video(frames, reference_depth=depth)
    d = np.abs(a - b) / np.abs(b).max()
    out["VDA vitt int8"] = [float(d.max()), float(d.mean())]
    log(f"[reference] ({card}) VDA vitt int8 (torch._int_mm on "
        f"the card, int32 matmul on the CPU), card vs CPU: max err "
        f"{d.max():.3e}, mean {d.mean():.3e} of the largest (limits "
        f"{DE_REF_QUANT_MAX}, {DE_REF_QUANT_MEAN})")
    if d.max() > DE_REF_QUANT_MAX or d.mean() > DE_REF_QUANT_MEAN:
        raise RuntimeError(f"reference: the card's int8 VDA disagrees with "
                           f"the CPU's ({d.max()}, {d.mean()})")
    return out


def phase_depth_engines(metric, frames, dev, zero_counts, expect_counts,
                        card):
    """The diffusion and MVS depth engines, ``upscale`` and ``--quantize
    int8`` (after the earlier phases' models are freed), file to file
    through cli/main.py on phase 3's 1080p clip, seeded weights, no kernel
    of the repo on any path: (a) ``engine depthcrafter --model svd`` with
    phase 3's depth as --depth_video at the defaults (window 110, overlap
    25, 448 x 768, 5 steps) on 40 frames; (a') the same with
    ``--use_depth_prompting --window 25 --overlap 10`` (two windows); (b)
    ``engine geometrycrafter --model svd`` with a MoGe prior (vits) and
    ``--pmap_vae_checkpoint`` (PMAP_VAE converted from a seeded
    upstream-layout state dict, read back bit for bit), window 110, 384 x
    640, 40 frames; (c) ``engine mvsa --xfov 60`` on phase 11's camera
    path, MVSConfig at resize_w 1024, window 7, 16 frames, plain and
    ``--rescale_to_cost_volume``; (d) ``upscale``, PromptDA at ViT-L from a
    converted promptda_hf file, a 256 x 144 prompt, 16 frames in batches of
    4; (e) ``depth --quantize int8`` beside ``depth`` (VDA-S, 518, 40
    frames), their relative disparity's difference gated; (f) the movie's
    step 2 with depthcrafter, then geometrycrafter, on one 40-frame scene.
    Each with its wall, frames/s, peak memory and one window's or batch's
    device time, busy share and top device operations ((a), (b) and (f)
    traced as they run: a 40-frame clip is one 110-frame window; (a')
    untraced, for the script's time). Then
    the card-vs-CPU checks of phase_reference_depth_engines. -> numbers"""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.io import sidecar
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import convert
    from metric_depth_video_toolbox_tpu_torch.models import depth_anything
    from metric_depth_video_toolbox_tpu_torch.models import from_jax
    from metric_depth_video_toolbox_tpu_torch.models import promptda
    from metric_depth_video_toolbox_tpu_torch.models import svd
    from metric_depth_video_toolbox_tpu_torch.models import video_depth as vd
    from metric_depth_video_toolbox_tpu_torch.ops import quant
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie

    t_phase = time.perf_counter()
    n, m = DE_FRAMES, DE_SHORT
    gen = torch.Generator(device=dev).manual_seed(DE_SEED)
    res = {}
    P = "depth_engines"

    # the engine a command builds, kept for its checks and its profile
    built = []
    makers = {k: dstage._ENGINE_CLASSES[k] for k in (
        "depthcrafter", "geometrycrafter", "mvsa", "vda")}

    def keeper(name):
        def keep(**kw):
            built.append(makers[name](**kw))
            return built[-1]
        return keep

    def command(tag, argv, n_frames, profiled=False):
        """The command through cli/main.py; ``profiled``: the run itself
        under torch.profiler, its wall the traced run's (a 40-frame clip
        is one window of 110: the run's device time is the window's)."""
        built.clear()
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prof = (profile_fn(P, f"{tag}, the run", lambda: cli.main(argv),
                           card) if profiled else cli.main(argv))
        torch.cuda.synchronize()
        wall = (prof["wall_ms"] / 1e3 if profiled
                else time.perf_counter() - t0)
        expect_counts(f"{P} {tag}", {}, "no kernel of the repo on this path")
        r = {"wall_s": wall, "fps": n_frames / wall,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if profiled:
            r["profile"] = prof
        log(f"[{P}] ({card}) {tag}: {wall:.3f} s{' traced' * profiled}, "
            f"{r['fps']:.3f} frames/s, peak {r['peak_gib']:.2f} GiB (the "
            f"phase at {time.perf_counter() - t_phase:.1f} s)")
        return r

    def depth_range(d):
        return [float(d.min()), float(d.max())]

    for k in makers:
        dstage._ENGINE_CLASSES[k] = keeper(k)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            clip = os.path.join(tmp, "clip.mkv")
            vio.save_rgb_video(frames[:n], clip, 24)
            ref = os.path.join(tmp, "ref.mkv")
            vio.save_depth_video(metric[:n], ref, 24, 100.0)
            out = clip + "_depth.mkv"

            # (a) DepthCrafter, the SVD graph, at the defaults
            r = command("(a) engine depthcrafter --model svd", [
                "engine", "depthcrafter", "--color_video", clip,
                "--depth_video", ref, "--model", "svd"], n, profiled=True)
            eng = built[0]
            if (not hasattr(eng.cfg, "cross_attention_dim")
                    or eng.work_hw != depthcrafter_work_hw(H, W)
                    or eng.window != 110):
                raise RuntimeError(f"{P} (a): engine {eng.cfg}, "
                                   f"{eng.work_hw}, window {eng.window}")
            r["params_m"] = sum(p.numel() for p in eng.model.parameters()
                                ) / 1e6
            r["depth_m"] = depth_range(check_depth_file(
                "(a)", out, n, phase=P))
            os.remove(out)
            res["depthcrafter"] = r
            log(f"[{P}] ({card}) (a) {r['params_m']:.1f} M parameters, "
                f"depth {r['depth_m'][0]:.3f}..{r['depth_m'][1]:.3f} m")

            # (a') the same graph and weights, prompted, two windows
            r = command("(a') depthcrafter --use_depth_prompting --window "
                        "25 --overlap 10", [
                            "engine", "depthcrafter", "--color_video", clip,
                            "--depth_video", ref, "--model", "svd",
                            "--use_depth_prompting", "--window", "25",
                            "--overlap", "10"], n)
            eng = built[0]
            r["depth_m"] = depth_range(check_depth_file(
                "(a')", out, n, phase=P))
            os.remove(out)
            res["depthcrafter_prompted"] = r
            del eng
            built.clear()
            gc.collect()
            torch.cuda.empty_cache()

            # (b) GeometryCrafter with the point-map VAE from a file
            t0 = time.perf_counter()
            pth = os.path.join(tmp, "pmap_vae.pth")
            sd = upstream_state_dict(svd_vae_shapes(svd.PMAP_VAE), gen, dev)
            n_params = sum(v.numel() for v in sd.values())
            torch.save(sd, pth)
            del sd
            tree = convert.convert_torch_file(pth, "pmap_vae")
            ckpt = os.path.join(tmp, "pmap_vae.msgpack")
            convert.save_checkpoint(ckpt, tree)
            leaves, nbytes = same_bits_on_card(
                tree, convert.load_checkpoint(ckpt), dev)
            conv_s = time.perf_counter() - t0
            del tree
            r = command("(b) engine geometrycrafter --model svd "
                        "--pmap_vae_checkpoint", [
                            "engine", "geometrycrafter", "--color_video",
                            clip, "--model", "svd", "--pmap_vae_checkpoint",
                            ckpt], n, profiled=True)
            eng = built[0]
            if (eng.pmap_enc is None or eng.work_hw != DE_GC_WORK
                    or not hasattr(eng.cfg, "cross_attention_dim")):
                raise RuntimeError(f"{P} (b): engine {eng.cfg}, "
                                   f"{eng.work_hw}, pmap VAE "
                                   f"{eng.pmap_enc is not None}")
            r.update(pmap_vae_params_m=n_params / 1e6,
                     pmap_vae_file_mib=os.path.getsize(ckpt) / 2**20,
                     pmap_vae_convert_write_read_s=conv_s,
                     pmap_vae_leaves=leaves,
                     depth_m=depth_range(check_depth_file(
                         "(b)", out, n, phase=P)))
            os.remove(out)
            log(f"[{P}] ({card}) (b) point-map VAE: "
                f"{r['pmap_vae_params_m']:.1f} M parameters, "
                f"{r['pmap_vae_file_mib']:.1f} MiB, seeded, "
                f"converted, written and read back bit for bit ({leaves} "
                f"leaves, {nbytes / 2**20:.1f} MiB) in {conv_s:.3f} s; depth "
                f"{r['depth_m'][0]:.3f}..{r['depth_m'][1]:.3f} m")
            res["geometrycrafter"] = r
            del eng
            built.clear()
            gc.collect()
            torch.cuda.empty_cache()

            # (c) MVS on phase 11's seeded camera path
            clip_m = os.path.join(tmp, "clip16.mkv")
            vio.save_rgb_video(frames[:m], clip_m, 24)
            tf = os.path.join(tmp, "clip16_transformations.json")
            sidecar.save_transformations(tf, camera_path(m))
            out_m = clip_m + "_depth.mkv"
            for tag, extra in (("(c) engine mvsa", []),
                               ("(c) engine mvsa --rescale_to_cost_volume",
                                ["--rescale_to_cost_volume"])):
                r = command(tag, ["engine", "mvsa", "--color_video", clip_m,
                                  "--transformation_file", tf, "--xfov",
                                  "60"] + extra, m)
                eng = built[0]
                if eng.cfg.num_depths != 64 or eng.resize_w != 1024:
                    raise RuntimeError(f"{P} {tag}: {eng.cfg}")
                r["depth_m"] = depth_range(check_depth_file(
                    tag, out_m, m, phase=P))
                os.remove(out_m)
                tfs = camera_path(m)
                r["profile"] = profile_fn(P, f"{tag}: one batch of 4", (
                    lambda: eng.infer_video(frames[:4], tfs[:4], 60.0)), card)
                res["mvsa_rescaled" if extra else "mvsa"] = r
            del eng
            built.clear()

            # (d) upscale: PromptDA ViT-L from a converted promptda_hf file
            t0 = time.perf_counter()
            cfg = promptda.PromptDAConfig()
            hw14 = (H // 14 * 14, W // 14 * 14)
            grid = (hw14[0] // 14, hw14[1] // 14)
            pth = os.path.join(tmp, "promptda.pth")
            sd = upstream_state_dict(promptda_hf_shapes(
                cfg.vit, cfg.dpt, grid[0] * grid[1]), gen, dev)
            n_params = sum(v.numel() for v in sd.values())
            torch.save(sd, pth)
            del sd
            tree = convert.convert_torch_file(pth, "promptda_hf", cfg.vit)
            os.remove(pth)
            ckpt = os.path.join(tmp, "promptda.msgpack")
            convert.save_checkpoint(ckpt, tree)
            conv_s = time.perf_counter() - t0
            del tree
            prompt = F.interpolate(torch.from_numpy(metric[:m])[:, None],
                                   size=DE_PROMPT_HW, mode="area")[:, 0]
            prompt_path = os.path.join(tmp, "prompt.mkv")
            vio.save_depth_video(prompt.numpy(), prompt_path, 24, 100.0)
            r = command("(d) upscale (PromptDA ViT-L, batch 4)", [
                "upscale", "--color_video", clip_m, "--depth_video",
                prompt_path, "--checkpoint", ckpt], m)
            up = check_depth_file("(d)", prompt_path + "_upscaled.mkv", m,
                                  phase=P)
            r.update(params_m=n_params / 1e6, convert_write_s=conv_s,
                     file_gib=os.path.getsize(ckpt) / 2**30,
                     depth_m=depth_range(up))
            with torch.device(dev):
                model = promptda.PromptDA(cfg, hw14)
            from_jax.load_params(model, convert.load_checkpoint(ckpt),
                                 ignore_unused=True)
            model = model.eval()
            x = torch.from_numpy(frames[:4]).to(dev).float() / 255.0
            x = F.interpolate(x.permute(0, 3, 1, 2), size=hw14,
                              mode="bilinear", antialias=True).permute(
                                  0, 2, 3, 1)
            p4 = prompt[:4].to(dev)
            with torch.no_grad():
                r["profile"] = profile_fn(P, "(d) one batch of 4", (
                    lambda: model(x, p4)), card)
            log(f"[{P}] ({card}) (d) {r['params_m']:.1f} M parameters, "
                f"{r['file_gib']:.2f} GiB file converted and written in "
                f"{conv_s:.3f} s, prompt {DE_PROMPT_HW[1]}x{DE_PROMPT_HW[0]}"
                f" -> {W}x{H}, depth {r['depth_m'][0]:.3f}.."
                f"{r['depth_m'][1]:.3f} m")
            res["upscale"] = r
            del model, x, p4
            gc.collect()
            torch.cuda.empty_cache()

            # (e) depth --quantize int8 beside bfloat16, the same weights
            paths, disp = {}, {}
            for q in ("bfloat16", "int8"):
                c = os.path.join(tmp, f"{q}.mkv")
                os.link(clip, c)
                argv = ["depth", "--color_video", c]
                if q == "int8":
                    argv += ["--quantize", "int8"]
                r = command(f"(e) depth {' '.join(argv[3:]) or '(bfloat16)'}",
                            argv, n)
                eng = built[0]
                if eng.cfg.vit.quant != (q if q == "int8" else None):
                    raise RuntimeError(f"{P} (e): vit quant "
                                       f"{eng.cfg.vit.quant}")
                calls = [0]
                mm = quant.int8_matmul

                def counted(*a):
                    calls[0] += 1
                    return mm(*a)
                quant.int8_matmul = counted
                try:
                    r["profile"] = profile_fn(
                        P, f"(e) {q}: one 32-frame window",
                        lambda: eng.infer_video(frames[:32]), card)
                finally:
                    quant.int8_matmul = mm
                r["int8_matmuls"] = calls[0]
                if (calls[0] > 0) != (q == "int8"):
                    raise RuntimeError(f"{P} (e) {q}: {calls[0]} int8 "
                                       f"matmuls")
                work = depth_anything.working_resolution(H, W, 518, 14)
                model, _ = eng.models(work)
                disp[q] = vd.infer_video_depth(
                    model, frames[:n], work, (H, W),
                    window=eng.cfg.window, overlap=eng.cfg.overlap,
                    device=dev).float().cpu().numpy()
                paths[q] = c + "_depth.mkv"
                res[f"depth_{q}"] = r
                del eng
                built.clear()
            d = {q: check_depth_file(f"(e) {q}", pth_, n, phase=P)
                 for q, pth_ in paths.items()}
            depth_diff = np.abs(d["int8"] - d["bfloat16"]) / max(
                float(np.abs(d["bfloat16"]).max()), 1e-9)
            diff = np.abs(disp["int8"] - disp["bfloat16"]) / max(
                float(np.abs(disp["bfloat16"]).max()), 1e-9)
            qd = {"max": float(diff.max()), "mean": float(diff.mean()),
                  "depth_max": float(depth_diff.max()),
                  "depth_mean": float(depth_diff.mean()),
                  "int8_over_bf16_fps": res["depth_int8"]["fps"]
                  / res["depth_bfloat16"]["fps"],
                  "int8_over_bf16_window_ms":
                      res["depth_int8"]["profile"]["wall_ms"]
                      / res["depth_bfloat16"]["profile"]["wall_ms"]}
            res["quant"] = qd
            log(f"[{P}] ({card}) (e) int8 vs bfloat16: relative disparity "
                f"max {qd['max']:.3e}, mean {qd['mean']:.3e} of the largest "
                f"(limits {DE_QUANT_MAX}, {DE_QUANT_MEAN}); the metric depth "
                f"files max {qd['depth_max']:.3e}, mean "
                f"{qd['depth_mean']:.3e} (not gated); frames/s int8 "
                f"{res['depth_int8']['fps']:.3f}, bfloat16 "
                f"{res['depth_bfloat16']['fps']:.3f} (ratio "
                f"{qd['int8_over_bf16_fps']:.3f}); one window int8 / bf16 "
                f"{qd['int8_over_bf16_window_ms']:.3f}; int8 matmuls per "
                f"window {res['depth_int8']['int8_matmuls']}")
            if qd["max"] > DE_QUANT_MAX or qd["mean"] > DE_QUANT_MEAN:
                raise RuntimeError(f"{P} (e): int8 depth {qd} off bfloat16")

            # (f) the movie's step 2, depthcrafter then geometrycrafter
            for engine in ("depthcrafter", "geometrycrafter"):
                scene = os.path.join(tmp, engine, "scene_1.mkv")
                vio.save_rgb_video(frames[:n], scene, 24)
                scenes = [{"Scene Number": "1", "finished": False,
                           "scene_video_file": scene,
                           "depth_video_file": scene + "_depth.mkv"}]
                zero_counts()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                prof = profile_fn(
                    P, f"(f) movie step 2 {engine}, the run",
                    lambda: movie.step2_estimate_depth(
                        scenes, engine=engine,
                        engine_kwargs={"size": "vits", "input_size": 518},
                        device=dev), card)
                wall = prof["wall_ms"] / 1e3
                expect_counts(f"{P} (f) movie step 2 {engine}", {},
                              "no kernel of the repo on this path")
                dr = depth_range(check_depth_file(
                    f"(f) {engine}", scene + "_depth.mkv", n, phase=P))
                if os.path.exists(scene + "_ref_depth.mkv") != (
                        engine == "depthcrafter"):
                    raise RuntimeError(f"{P} (f) {engine}: reference pass")
                r = {"wall_s": wall, "fps": n / wall, "depth_m": dr,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "profile": prof}
                res[f"movie_{engine}"] = r
                log(f"[{P}] ({card}) (f) movie step 2 {engine} "
                    f"(DIFFUSION_TINY, the JAX package's default), {n} "
                    f"frames: {wall:.3f} s traced, {n / wall:.3f} frames/s, "
                    f"peak {r['peak_gib']:.2f} GiB")
                built.clear()
    finally:
        for k, v in makers.items():
            dstage._ENGINE_CLASSES[k] = v
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["reference"] = phase_reference_depth_engines(dev, card)
    log(f"[{P}] ({card}) card vs CPU: {time.perf_counter() - t0:.3f} s")
    res["s"] = time.perf_counter() - t_phase
    log(f"[{P}] ({card}) phase: {res['s']:.3f} s")
    return res



# --- phase 14: tracking, pose and flow ---------------------------------------

TR_FRAMES = 40          # phase 3's clip: track, align, slam
TR_FLOW_FRAMES = 16     # (c): flow on the first 16 frames at batch 4
TR_PROFILE_FRAMES = 8   # (a): the LK clip profiled on its first 8 frames
TR_SEED = 14
# card vs CPU at the tiny presets (the CPU tests' tolerances): model
# outputs and poses within 1e-4 of the largest, LK positions within 1e-3
# px where both keep the track, validity equal on all but 0.1%
TR_REF_TOL, TR_REF_PX, TR_REF_FLIPS = 1e-4, 1e-3, 1e-3


def _conv_shape(s, name, out_ch, in_ch, kh, kw=None, bias=True):
    s[name + ".weight"] = (out_ch, in_ch, kh, kw or kh)
    if bias:
        s[name + ".bias"] = (out_ch,)


def _bn_shape(s, name, ch):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        s[f"{name}.{leaf}"] = (ch,)


def raft_shapes(cfg):
    """{name: shape} of a torchvision ``raft_large`` state dict at ``cfg``'s
    widths."""
    s = {}
    for te, batch, out in (("feature_encoder", False, cfg.feat_dim),
                           ("context_encoder", True,
                            cfg.hidden_dim + cfg.context_dim)):
        _conv_shape(s, f"{te}.convnormrelu.0", cfg.stem, 3, 7, bias=False)
        if batch:
            _bn_shape(s, f"{te}.convnormrelu.1", cfg.stem)
        cin = cfg.stem
        for li, (width, stride) in enumerate(zip(cfg.layers, (1, 2, 2))):
            for bi in (0, 1):
                b = f"{te}.layer{li + 1}.{bi}"
                c0 = cin if bi == 0 else width
                _conv_shape(s, b + ".convnormrelu1.0", width, c0, 3,
                            bias=False)
                _conv_shape(s, b + ".convnormrelu2.0", width, width, 3,
                            bias=False)
                if batch:
                    _bn_shape(s, b + ".convnormrelu1.1", width)
                    _bn_shape(s, b + ".convnormrelu2.1", width)
                if bi == 0 and (stride != 1 or c0 != width):
                    _conv_shape(s, b + ".downsample.0.0", width, c0, 1,
                                bias=False)
                    if batch:
                        _bn_shape(s, b + ".downsample.0.1", width)
            cin = width
        _conv_shape(s, f"{te}.conv", out, cin, 1)
    me = "update_block.motion_encoder"
    cor = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
    _conv_shape(s, f"{me}.convcorr1.0", cfg.motion_corr[0], cor, 1)
    _conv_shape(s, f"{me}.convcorr2.0", cfg.motion_corr[1],
                cfg.motion_corr[0], 3)
    _conv_shape(s, f"{me}.convflow1.0", cfg.motion_flow[0], 2, 7)
    _conv_shape(s, f"{me}.convflow2.0", cfg.motion_flow[1],
                cfg.motion_flow[0], 3)
    _conv_shape(s, f"{me}.conv.0", cfg.motion_out - 2,
                cfg.motion_corr[1] + cfg.motion_flow[1], 3)
    gru_in = cfg.hidden_dim + cfg.context_dim + cfg.motion_out
    for g, (kh, kw) in ((1, (1, 5)), (2, (5, 1))):
        for n in ("convz", "convr", "convq"):
            _conv_shape(s, f"update_block.recurrent_block.convgru{g}.{n}",
                        cfg.hidden_dim, gru_in, kh, kw)
    _conv_shape(s, "update_block.flow_head.conv1", cfg.flow_head_hidden,
                cfg.hidden_dim, 3)
    _conv_shape(s, "update_block.flow_head.conv2", 2, cfg.flow_head_hidden,
                3)
    _conv_shape(s, "mask_predictor.convrelu.0", cfg.flow_head_hidden,
                cfg.hidden_dim, 3)
    _conv_shape(s, "mask_predictor.conv", 8 * 8 * 9, cfg.flow_head_hidden, 1)
    return s


def droid_shapes(cfg, prefix="module."):
    """{name: shape} of a DROID-SLAM / Mega-SAM state dict at ``cfg``'s
    widths (``module.``: Mega-SAM's DataParallel file), with one tensor of
    Mega-SAM's motion head, which the converter ignores."""
    s = {}
    for enc, out in (("fnet", cfg.feat_dim), ("cnet", cfg.hidden
                                              + cfg.context)):
        _conv_shape(s, f"{prefix}{enc}.conv1", cfg.stem, 3, 7)
        cin = cfg.stem
        for li, width in enumerate(cfg.layers):
            for ni in (0, 1):
                b = f"{prefix}{enc}.layer{li + 1}.{ni}"
                c0 = cin if ni == 0 else width
                _conv_shape(s, b + ".conv1", width, c0, 3)
                _conv_shape(s, b + ".conv2", width, width, 3)
                if ni == 0 and (li > 0 or c0 != width):
                    _conv_shape(s, b + ".downsample.0", width, c0, 1)
            cin = width
        _conv_shape(s, f"{prefix}{enc}.conv2", out, cin, 1)
    u = prefix + "update."
    hid = cfg.hidden
    width = 128 if cfg.feat_dim >= 128 else hid * 2
    _conv_shape(s, u + "corr_encoder.0", width, cfg.cor_planes, 1)
    _conv_shape(s, u + "corr_encoder.2", hid, width, 3)
    _conv_shape(s, u + "flow_encoder.0", width, 4, 7)
    _conv_shape(s, u + "flow_encoder.2", hid // 2, width, 3)
    gin = hid + cfg.context + hid + hid // 2
    for n in ("convz", "convr", "convq"):
        _conv_shape(s, f"{u}gru.{n}", hid, gin, 3)
        _conv_shape(s, f"{u}gru.{n}_glo", hid, hid, 1)
    _conv_shape(s, u + "gru.w", hid, hid, 1)
    for head in ("delta", "weight"):
        _conv_shape(s, f"{u}{head}.0", hid, hid, 3)
        _conv_shape(s, f"{u}{head}.2", 2, hid, 3)
    _conv_shape(s, u + "agg.conv1", hid, hid, 3)
    _conv_shape(s, u + "agg.conv2", hid, hid, 3)
    _conv_shape(s, u + "agg.eta.0", 1, hid, 3)
    _conv_shape(s, u + "agg.upmask.0", cfg.upsample_factor ** 2 * 9, hid, 1)
    _conv_shape(s, u + "motion_head.0", 2, hid, 3)
    return s


def cotracker3_shapes(cfg):
    """{name: shape} of a ``cotracker3_offline`` state dict at ``cfg``'s
    widths (upstream's ``virual_tracks`` spelling)."""
    s = {}
    d = cfg.latent_dim
    dims = (d // 2, (d // 4) * 3, d, d)
    _conv_shape(s, "fnet.conv1", d // 2, 3, 7)
    cin = d // 2
    for li, (width, stride) in enumerate(zip(dims, (1, 2, 2, 2))):
        for bi in (0, 1):
            b = f"fnet.layer{li + 1}.{bi}"
            c0 = cin if bi == 0 else width
            _conv_shape(s, b + ".conv1", width, c0, 3)
            _conv_shape(s, b + ".conv2", width, width, 3)
            if bi == 0 and (stride != 1 or c0 != width):
                _conv_shape(s, b + ".downsample.0", width, c0, 1)
        cin = width
    _conv_shape(s, "fnet.conv2", 2 * d, sum(dims), 3)
    _conv_shape(s, "fnet.conv3", d, 2 * d, 1)
    s["corr_mlp.fc1.weight"] = (cfg.corr_mlp_hidden, cfg.window ** 4)
    s["corr_mlp.fc1.bias"] = (cfg.corr_mlp_hidden,)
    s["corr_mlp.fc2.weight"] = (cfg.corr_emb_dim, cfg.corr_mlp_hidden)
    s["corr_mlp.fc2.bias"] = (cfg.corr_emb_dim,)
    hs = cfg.hidden_size
    mlp = int(hs * cfg.mlp_ratio)
    u = "updateformer."
    s[u + "input_transform.weight"] = (hs, cfg.input_dim)
    s[u + "input_transform.bias"] = (hs,)
    s[u + "virual_tracks"] = (1, cfg.num_virtual_tracks, 1, hs)

    def block(p, attn):
        norms = ("norm1", "norm2") + (("norm_context",) if attn ==
                                      "cross_attn" else ())
        for n in norms:
            s[f"{p}.{n}.weight"] = (hs,)
            s[f"{p}.{n}.bias"] = (hs,)
        for m, out in (("to_q", hs), ("to_kv", 2 * hs), ("to_out", hs)):
            s[f"{p}.{attn}.{m}.weight"] = (out, hs)
            s[f"{p}.{attn}.{m}.bias"] = (out,)
        s[f"{p}.mlp.fc1.weight"] = (mlp, hs)
        s[f"{p}.mlp.fc1.bias"] = (mlp,)
        s[f"{p}.mlp.fc2.weight"] = (hs, mlp)
        s[f"{p}.mlp.fc2.bias"] = (hs,)
    for i in range(cfg.time_depth):
        block(f"{u}time_blocks.{i}", "attn")
    for j in range(cfg.space_depth):
        block(f"{u}space_virtual_blocks.{j}", "attn")
        block(f"{u}space_point2virtual_blocks.{j}", "cross_attn")
        block(f"{u}space_virtual2point_blocks.{j}", "cross_attn")
    for head in ("flow_head", "vis_conf_head"):
        s[f"{u}{head}.weight"] = (2, hs)
        s[f"{u}{head}.bias"] = (2,)
    return s


def converted_file(tmp, name, kind, shapes, gen, dev, cfg=None):
    """A seeded upstream-layout state dict written with torch.save,
    converted by convert_torch_file, written by save_checkpoint -> (path,
    seconds, parameter count)."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import convert

    t0 = time.perf_counter()
    pth = os.path.join(tmp, name + ".pth")
    torch.save(upstream_state_dict(shapes, gen, dev), pth)
    tree = convert.convert_torch_file(pth, kind, cfg)
    path = os.path.join(tmp, name + ".msgpack")
    convert.save_checkpoint(path, tree)
    n = sum(int(np.prod(np.shape(leaf))) for _, leaf in tree_leaves(tree))
    return path, time.perf_counter() - t0, n


def check_tracks(tag, path, n):
    """The tracking file's frames and tracks -> (frames with a track,
    distinct ids)."""
    import numpy as np

    from metric_depth_video_toolbox_tpu_torch.io import sidecar

    rows = sidecar.load_tracking(path)
    if len(rows) != n:
        raise RuntimeError(f"{tag}: {len(rows)} frames of tracks, not {n}")
    ids = {int(r[0]) for f in rows for r in f}
    if not all(np.isfinite(f).all() for f in rows):
        raise RuntimeError(f"{tag}: non-finite track rows")
    return sum(1 for f in rows if len(f)), len(ids)


def check_poses(tag, path, n):
    import numpy as np

    from metric_depth_video_toolbox_tpu_torch.io import sidecar

    tr = sidecar.load_transformations(path)
    if tr.shape != (n, 4, 4) or not np.isfinite(tr).all():
        raise RuntimeError(f"{tag}: transformations {tr.shape}, finite "
                           f"{np.isfinite(tr).all()}")
    if np.abs(tr[0] - np.eye(4)).max() > 1e-4:
        raise RuntimeError(f"{tag}: frame 0 is not the identity")
    return float(np.linalg.norm(tr[-1][:3, 3]))


def phase_reference_tracking(dev, card):
    """The tracking models at their tiny presets in float32 on the card and
    on the CPU, on the same inputs and weights (drawn on the CPU): LK
    over a panning clip, CoTracker3 at COTRACKER3_TINY (its flow head
    scaled by 0.01 and its visibility bias at 3, as the CPU tests share),
    RAFT_TINY (a 9-row feature grid: the odd pyramid level), DroidNet at
    DROID_TINY and one window of the learned front-end, and the bundle
    adjustment. -> {name: difference share}"""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import cotracker as ct
    from metric_depth_video_toolbox_tpu_torch.models import droid as dm
    from metric_depth_video_toolbox_tpu_torch.models import from_jax
    from metric_depth_video_toolbox_tpu_torch.models import raft as rf
    from metric_depth_video_toolbox_tpu_torch.models import tracker as trk
    from metric_depth_video_toolbox_tpu_torch.pipeline import slam

    cpu = torch.device("cpu")
    rng = np.random.default_rng(TR_SEED)
    out = {}

    def share(a, b):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))

    def both(make, fn):
        """fn(model, device) on the CPU and on the card; the model built
        once (seeded on the CPU), copied to the card."""
        m = make()
        want = fn(m, cpu)
        got = fn(m.to(dev), dev)
        m.to(cpu)
        return got, want

    # LK over a panning texture
    base = rng.integers(0, 200, (25, 40, 3)).astype(np.float32)
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(base).permute(2, 0, 1)[None], scale_factor=4,
        mode="bilinear")[0].permute(1, 2, 0).numpy()
    clip = np.stack([tex[:72, 2 * i:2 * i + 96] for i in range(8)]).astype(
        np.uint8)
    pts, ok = trk.generate_grid_queries(clip[0], grid=8)
    res = []
    for d in (dev, cpu):
        traj, vis = trk.lk_track_clip(torch.from_numpy(clip).to(d),
                                      torch.from_numpy(pts).to(d),
                                      torch.from_numpy(ok).to(d))
        res.append((traj.cpu().numpy(), vis.cpu().numpy() > 0))
    (tg, vg), (tw, vw) = res
    flips = float((vg != vw).mean())
    both_ok = vg & vw
    px = float(np.abs(tg[both_ok] - tw[both_ok]).max())
    if flips > TR_REF_FLIPS or px > TR_REF_PX or not both_ok.any():
        raise RuntimeError(f"tracking reference: LK card vs CPU: {flips} "
                           f"validity flips, {px} px")
    out["lk_px"], out["lk_flips"] = px, flips

    # CoTracker3 tiny
    def cotracker():
        m = ct.CoTracker3(ct.COTRACKER3_TINY)
        from_jax.flax_like_init(m, torch.Generator().manual_seed(1),
                                normal=("virtual_tracks",))
        with torch.no_grad():
            m.updateformer.flow_head.weight.mul_(0.01)
            m.updateformer.vis_conf_head.bias.fill_(3.0)
        return m.eval()
    video = torch.from_numpy(rng.uniform(0, 255, (4, 48, 64, 3)).astype(
        np.float32))
    queries = torch.tensor([[0, 10.3, 12.7], [1, 30.1, 20.4],
                            [0, 50.0, 40.2], [3, 63.5, 47.5]])
    with torch.no_grad():
        got, want = both(cotracker, lambda m, d: m(video.to(d),
                                                   queries.to(d)))
    out["cotracker3"] = max(share(got[k], want[k]) for k in want)

    # RAFT tiny, 72 x 64 frames: a 9 x 8 feature grid
    a = torch.from_numpy(rng.integers(0, 255, (2, 72, 64, 3)).astype(
        np.uint8))
    b = torch.roll(a, 2, dims=2)

    def raft():
        return from_jax.flax_like_init(rf.RAFT(rf.RAFT_TINY),
                                       torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, want = both(raft, lambda m, d: m(a.to(d), b.to(d)))
    out["raft"] = share(got, want)

    # DroidNet tiny: features and one update over 4 edges
    img = torch.from_numpy(rng.uniform(0, 1, (3, 64, 80, 3)).astype(
        np.float32))
    corr = torch.from_numpy(rng.standard_normal(
        (4, dm.DROID_TINY.cor_planes, 8, 10)).astype(np.float32))
    flow = torch.from_numpy(rng.standard_normal((4, 4, 8, 10)).astype(
        np.float32))
    src = torch.tensor([0, 1, 1, 2])

    def droid():
        return from_jax.flax_like_init(dm.DroidNet(dm.DROID_TINY),
                                       torch.Generator().manual_seed(3))

    def droid_run(m, d):
        fm, net, inp = m.features(img.to(d))
        s = src.to(d)
        return (fm,) + tuple(m.update(net[s], inp[s], corr.to(d),
                                      flow.to(d), s, 3))
    with torch.no_grad():
        got, want = both(droid, droid_run)
    out["droid"] = max(share(g, w) for g, w in zip(got, want))

    # one window of the learned front-end (depths 1-8 m: a yaw and a
    # sideways move told apart)
    k8 = np.array([[10.0, 0, 6.0], [0, 10.0, 4.0], [0, 0, 1]], np.float32)
    depth8 = torch.from_numpy(rng.uniform(1, 8, (5, 8, 12)).astype(
        np.float32))
    imgs = torch.from_numpy(rng.uniform(0, 1, (5, 64, 96, 3)).astype(
        np.float32))
    wmask8 = torch.ones((5, 8, 12))

    def window(m, d):
        with torch.no_grad():
            feats = m.features(imgs.to(d))
        solve = slam._build_window_solver(m, dm.DROID_TINY, k8, 5, 8, 12, 2,
                                          2, 2)
        return solve(*feats, depth8.to(d), wmask8.to(d))
    got, want = both(droid, window)
    out["droid_window"] = max(share(g, w) for g, w in zip(got[:2],
                                                           want[:2]))

    # the bundle adjustment: 5 frames, 24 tracks, noisy initial poses
    n = 24
    pts3 = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                     rng.uniform(2.5, 4.5, n)], -1)
    kk = np.array([[80.0, 0, 48.0], [0, 80.0, 32.0], [0, 0, 1]], np.float32)
    uv = np.zeros((5, n, 2), np.float32)
    rv = np.zeros((5, 3), np.float32)
    tv = np.zeros((5, 3), np.float32)
    for fi in range(5):
        tv[fi] = [0.05 * fi, 0.01 * fi, 0.03 * fi]
        rv[fi] = [0.0, -0.012 * fi, 0.0]
        r = slam.solvers._so3_exp(torch.from_numpy(rv[fi])).numpy()
        pc = pts3 @ r.T + tv[fi]
        uv[fi] = pc[:, :2] / pc[:, 2:] * 80.0 + [48.0, 32.0]
    noise = rng.normal(0, 0.005, (2, 5, 3)).astype(np.float32)
    noise[:, 0] = 0
    args = [uv, np.ones((5, n), np.float32), pts3[:, 2].astype(np.float32),
            kk, rv + noise[0], tv + noise[1]]
    res = [slam.bundle_adjust(*[torch.from_numpy(x).to(d) for x in args],
                              iters=4, optimize_focal=True)
           for d in (dev, cpu)]
    out["bundle_adjust"] = max(share(g, w) for g, w in zip(
        res[0][:2], res[1][:2]))
    bad = {k: v for k, v in out.items() if not k.startswith("lk")
           and v > TR_REF_TOL}
    if bad:
        raise RuntimeError(f"tracking reference: card vs CPU beyond "
                           f"{TR_REF_TOL}: {bad}")
    log(f"[tracking] ({card}) card vs CPU, tiny presets, float32: " +
        ", ".join(f"{k} {v:.3e}" for k, v in out.items()))
    return out


def phase_tracking(metric, frames, dev, zero_counts, expect_counts, card):
    """Tracking, pose and flow file to file through cli/main.py on phase
    3's 1080p clip (its depth mapped onto 1-30 m, as phase 11's), seeded
    weights, no kernel of the repo on any path: (a) ``track`` at the
    defaults (LK, grid 36, clip_len 120) and ``track --engine cotracker3
    --weights`` on a file converted from a seeded upstream-layout state
    dict at COTRACKER3; (b) ``align`` with each solver on (a)'s LK tracks;
    (c) ``flow`` (RAFT_LARGE from a converted file) on 16 frames at batch
    4; (d) ``slam`` without a checkpoint (LK, the two-group poses, the
    global bundle adjustment) and with a converted ``megasam`` file (DROID,
    the global bundle adjustment on). Each with its wall, frames/s, peak
    memory and one clip's, chunk's, pair's, batch's or window's device
    time, busy share and top operations; counts zeroed before and read
    after each run. Then phase_reference_tracking. -> numbers"""
    import gc
    import shutil

    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.cli import main as cli
    from metric_depth_video_toolbox_tpu_torch.cli import optical_flow
    from metric_depth_video_toolbox_tpu_torch.io import sidecar
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import convert
    from metric_depth_video_toolbox_tpu_torch.models import cotracker as ct
    from metric_depth_video_toolbox_tpu_torch.models import droid as dm
    from metric_depth_video_toolbox_tpu_torch.models import from_jax
    from metric_depth_video_toolbox_tpu_torch.models import raft as rf
    from metric_depth_video_toolbox_tpu_torch.models import tracker as trk
    from metric_depth_video_toolbox_tpu_torch.ops import codec
    from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
    from metric_depth_video_toolbox_tpu_torch.ops import image as im
    from metric_depth_video_toolbox_tpu_torch.pipeline import align, slam

    t_phase = time.perf_counter()
    n, nf = TR_FRAMES, TR_FLOW_FRAMES
    gen = torch.Generator(device=dev).manual_seed(TR_SEED)
    res = {}
    P = "tracking"

    def command(tag, argv, n_frames):
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        expect_counts(f"{P} {tag}", {}, "no kernel of the repo on this path")
        r = {"wall_s": wall, "fps": n_frames / wall,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        log(f"[{P}] ({card}) {tag}: {wall:.3f} s, {r['fps']:.3f} frames/s, "
            f"peak {r['peak_gib']:.2f} GiB (the phase at "
            f"{time.perf_counter() - t_phase:.1f} s)")
        return r

    def profiled(tag, fn):
        zero_counts()
        p = profile_fn(P, tag, fn, card)
        expect_counts(f"{P} {tag}", {}, "no kernel of the repo on this path")
        return p

    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.mkv")
        vio.save_rgb_video(frames[:n], clip, 24)
        depth = film_depth(metric[:n])
        depth_file = clip + "_depth.mkv"
        vio.save_depth_video(depth, depth_file, 24, 100.0)
        frames_dev = torch.from_numpy(np.ascontiguousarray(frames[:n])).to(
            dev)

        # (a) track: LK at the defaults, then CoTracker3 from a file
        r = command("(a) track (lk, grid 36, clip_len 120)",
                    ["track", "--color_video", clip], n)
        lk_tracks = os.path.join(tmp, "lk_tracking.json")
        shutil.copy(clip + "_tracking.json", lk_tracks)
        r["frames_with_tracks"], r["tracks"] = check_tracks(
            "(a) lk", lk_tracks, n)
        pts, ok = trk.generate_grid_queries(frames_dev[0], grid=36)
        pts_t = torch.from_numpy(pts).to(dev)
        ok_t = torch.from_numpy(ok).to(dev)
        # 8 frames: the tracer's teardown grows with the ~1400 launches of
        # each frame pair (40 frames cost it 10 s)
        r["profile"] = profiled(f"(a) lk_track_clip, {TR_PROFILE_FRAMES} "
                                f"frames, {len(pts)} queries",
                                lambda: trk.lk_track_clip(
                                    frames_dev[:TR_PROFILE_FRAMES], pts_t,
                                    ok_t))
        res["track_lk"] = r

        ckpt, secs, nparam = converted_file(
            tmp, "cotracker3", "cotracker3",
            cotracker3_shapes(ct.COTRACKER3), gen, dev)
        r = command("(a) track --engine cotracker3 --weights (COTRACKER3)",
                    ["track", "--color_video", clip, "--engine",
                     "cotracker3", "--weights", ckpt], n)
        r["frames_with_tracks"], r["tracks"] = check_tracks(
            "(a) cotracker3", clip + "_tracking.json", n)
        r["params_m"], r["convert_s"] = nparam / 1e6, secs
        eng = ct.CoTracker3Engine(params=convert.load_checkpoint(ckpt),
                                  device=dev)
        mh, mw = ct.COTRACKER3.model_resolution
        video = im.resize(frames_dev.to(torch.float32), (mh, mw))
        q = torch.cat([torch.zeros(256, 1, device=dev),
                       pts_t[:256] * torch.tensor(
                           [mw / W, mh / H], device=dev)], 1)
        with torch.no_grad():
            r["profile"] = profiled(
                f"(a) CoTracker3 one chunk: {n} frames at {mh} x {mw}, 256 "
                f"queries, {eng.iters} iterations",
                lambda: eng.model(video, q, iters=eng.iters))
        res["track_cotracker3"] = r
        del eng, video
        log(f"[{P}] (a) CoTracker3 {nparam / 1e6:.1f} M parameters, file "
            f"converted and written in {secs:.1f} s")

        # (b) align, each solver, on (a)'s LK tracks
        k = geo.camera_matrix_from_fov(W, H, xfov_deg=60.0).to(dev)
        dense, _ = sidecar.tracking_to_dense(sidecar.load_tracking(
            lk_tracks), max_tracks=4096)
        with vio.VideoReader(depth_file) as dv:
            rgb2 = torch.from_numpy(dv.read_batch(2)).to(dev)
        d0 = codec.decode_depth_frame(rgb2[0], 100.0, average_rg=True)
        d1 = codec.decode_depth_frame(rgb2[1], 100.0, average_rg=True)
        pair = (torch.from_numpy(dense[1, :, :2]).to(dev),
                torch.from_numpy(dense[0, :, :2]).to(dev), d1, d0, k,
                torch.from_numpy(dense[1, :, 2] * dense[0, :, 2]).to(dev))
        for solver, flags in (("two_group", []),
                              ("stationary", ["--assume_stationary_camera"]),
                              ("hybrid", ["--use_madpose"])):
            tag = f"(b) align {' '.join(flags) or '(two_group)'}"
            r = command(tag, ["align", "--depth_video", depth_file,
                              "--track_file", lk_tracks, "--xfov", "60"]
                        + flags, n)
            r["last_camera_m"] = check_poses(
                tag, depth_file + "_transformations.json", n)
            r["profile"] = profiled(
                f"(b) {solver}: one frame pair, {dense.shape[1]} tracks",
                lambda s=solver: align.SOLVERS[s](*pair))
            res[f"align_{solver}"] = r

        # (c) flow: RAFT_LARGE from a converted file, 16 frames, batch 4
        clip16 = os.path.join(tmp, "clip16.mkv")
        vio.save_rgb_video(frames[:nf], clip16, 24)
        raft_ckpt, secs, nparam = converted_file(
            tmp, "raft", "raft", raft_shapes(rf.RAFT_LARGE), gen, dev)
        r = command(f"(c) flow (RAFT_LARGE, batch 4), {nf} frames",
                    ["flow", "--color_video", clip16, "--checkpoint",
                     raft_ckpt], nf)
        flow_frames = vio.read_video_frames(clip16 + "_flow.mkv")[0]
        if flow_frames.shape != (nf, H, W, 3):
            raise RuntimeError(f"(c) flow video {flow_frames.shape}")
        r["params_m"], r["convert_s"] = nparam / 1e6, secs
        model = optical_flow.flow_model(raft_ckpt, device=dev)
        a, b = frames_dev[:4], frames_dev[1:5]
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            r["profile"] = profiled(
                "(c) RAFT_LARGE one batch of 4 pairs at 1080 x 1920 "
                "(12 iterations) + colour coding",
                lambda: rf.flow_to_rgb(model(a, b)))
        r["batch_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"[{P}] (c) RAFT_LARGE {nparam / 1e6:.2f} M parameters; one "
            f"batch of 4 pairs peaks at {r['batch_peak_gib']:.2f} GiB "
            f"(level 0 of the correlation: 4 x 32400^2 x 4 B = 15.6 GiB)")
        res["flow"] = r
        del model
        gc.collect()
        torch.cuda.empty_cache()

        # (d) slam: LK + global BA, then the learned front-end from a file
        r = command("(d) slam (LK, two-group poses, global BA 10 iters)",
                    ["slam", "--color_video", clip, "--depth_video",
                     depth_file, "--xfov", "60"], n)
        r["last_camera_m"] = check_poses(
            "(d) slam", depth_file + "_transformations.json", n)
        dense, _ = sidecar.tracking_to_dense(sidecar.load_tracking(
            clip + "_tracking.json"), max_tracks=512)
        init = sidecar.load_transformations(
            depth_file + "_init_transformations.json")
        xi = np.clip(np.round(dense[..., 0]).astype(int), 0, W - 1)
        yi = np.clip(np.round(dense[..., 1]).astype(int), 0, H - 1)
        depths_at = depth[np.arange(n)[:, None], yi, xi]
        k_np = k.cpu().numpy()
        wts = slam.motion_weights(dense, init, depths_at, k_np)
        r["profile"] = profiled(
            f"(d) bundle adjustment: {n} frames x {dense.shape[1]} tracks, "
            f"10 iterations",
            lambda: slam._refine(dense, depths_at, init, k_np, wts, 10,
                                 False, dev))
        res["slam_lk"] = r

        droid_ckpt, secs, nparam = converted_file(
            tmp, "megasam", "megasam", droid_shapes(dm.DROID), gen, dev)
        r = command("(d) slam --checkpoint megasam (DROID, bf16, global BA)",
                    ["slam", "--color_video", clip, "--depth_video",
                     depth_file, "--xfov", "60", "--checkpoint",
                     droid_ckpt], n)
        r["last_camera_m"] = check_poses(
            "(d) slam droid", depth_file + "_transformations.json", n)
        r["params_m"], r["convert_s"] = nparam / 1e6, secs
        params = convert.load_checkpoint(droid_ckpt)
        cfg = dm.config_from_params(params)
        net = from_jax.load_params(dm.DroidNet(cfg), params).to(dev).eval()
        scale = 336 / max(H, W)           # the CLI's --droid_work_long
        wh = max(16, int(round(H * scale / 16)) * 16)
        ww = max(16, int(round(W * scale / 16)) * 16)
        k8 = k_np.copy()
        k8[0] *= ww / W / 8.0
        k8[1] *= wh / H / 8.0
        win = min(12, n)                  # the CLI's --droid_window
        with torch.no_grad():
            feats = net.features(im.resize(
                frames_dev[:win].to(torch.float32) / 255.0, (wh, ww)))
        depth8 = im.resize_nchw(torch.from_numpy(depth[:win]).to(dev)[
            :, None], (wh // 8, ww // 8))[:, 0]
        solve = slam._build_window_solver(net, cfg, k8, win, wh // 8,
                                          ww // 8, 6, 2, 2)
        wmask8 = torch.ones_like(depth8)
        r["profile"] = profiled(
            f"(d) DROID one window: {win} frames, radius 2, {wh // 8} x "
            f"{ww // 8} grid, 6 updates x 2 Gauss-Newton steps",
            lambda: solve(*feats, depth8, wmask8))
        res["slam_droid"] = r
        del net, feats, params
    gc.collect()
    torch.cuda.empty_cache()
    res["reference"] = phase_reference_tracking(dev, card)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"[{P}] ({card}) phase {res['phase_s']:.1f} s")
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
    cli.add_argument("--only", choices=("single_frame", "depth_engines",
                                        "tracking"),
                     help="run the build, phases 3-4 (the clip and the SBS "
                          "frames it needs; tracking: phase 3 alone) and "
                          "this phase alone; prints no device line")
    opts = cli.parse_args()
    baseline_csrc = opts.baseline_csrc

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
    # the script's clock at the end of each phase
    phase_end_s = {}

    def mark(name):
        phase_end_s[name] = round(time.perf_counter() - t_script, 1)
    mark("build")
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
    if opts.only == "single_frame":
        metric, frames, _ = phase_depth(gen, dev)
        _, _, sbs, _ = phase_stereo(metric, frames, gen, dev)
        single_frame = phase_single_frame(frames, sbs, dev, zero_counts,
                                          counts, expect_counts, smi[0])
        log(json.dumps({"single_frame": single_frame, "card": smi[0]}))
        log(smi[0])
        return 0
    if opts.only == "tracking":
        metric, frames, _ = phase_depth(gen, dev)
        mark("depth")
        gc.collect()
        torch.cuda.empty_cache()
        tracking = phase_tracking(metric, frames, dev, zero_counts,
                                  expect_counts, smi[0])
        mark("tracking")
        log(json.dumps({"tracking": tracking, "card": smi[0]}))
        log(json.dumps({"phase_end_s": phase_end_s}))
        log(smi[0])
        return 0
    if opts.only == "depth_engines":
        metric, frames, _ = phase_depth(gen, dev)
        phase_stereo(metric, frames, gen, dev)
        gc.collect()
        torch.cuda.empty_cache()
        depth_engines = phase_depth_engines(metric, frames, dev, zero_counts,
                                            expect_counts, smi[0])
        log(json.dumps({"depth_engines": depth_engines, "card": smi[0]}))
        log(smi[0])
        return 0
    sweep, dual, sweep_calls, dual_args = phase_kernels(gen, dev)
    ablation = phase_sweep_ablation(sweep_calls, dual_args, baseline_csrc)
    del sweep_calls, dual_args
    packed = phase_kernels_packed(dev)
    attention = phase_kernels_attention(gen, dev)
    mark("kernels")

    zero_counts()
    metric, frames, depth_fps = phase_depth(gen, dev)
    stereo_fps, batches, sbs, sbs_mask = phase_stereo(metric, frames, gen,
                                                      dev)
    launches = 2 * batches
    expect_counts("depth + stereo", {"disparity_sweep": launches},
                  f"{batches} batches, main + anchor sweep per batch of "
                  f"{BATCH} frames x 2 eyes = 4 sweeps per frame")
    mark("depth + stereo")
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

    mark("stereo fused + infill")
    da3_res, da3_eng, da3_frames = phase_da3(dev, zero_counts, counts)
    mark("da3")

    movie_fps, movie_steps, movie_launches, movie_sweeps, movie_diffusion = \
        phase_movie(dev, zero_counts, expect_counts, smi[0])
    mark("movie")
    svd_infill = phase_svd_infill(sbs, sbs_mask, frames, dev, zero_counts,
                                  expect_counts, smi[0])
    mark("svd_infill")
    checkpoints = phase_checkpoints(
        frames, sbs, sbs_mask, da3_frames, depth_fps,
        da3_res["flash_packed"]["fps"], dev, zero_counts, counts, smi[0],
        t_script)

    mark("checkpoints")
    phase_reference(dev)
    phase_reference_movie(dev)
    phase_reference_infill(sbs, sbs_mask, frames, dev)
    phase_reference_svd_infill(dev, smi[0])
    phase_reference_da3(dev)
    mark("reference")
    phase_files(dev)
    mark("files")
    phase_profile(metric, frames, (eng, eye),
                  (da3_eng, da3_frames, da3_res["flash_packed"]["s"]), sbs,
                  sbs_mask, dev)

    mark("profile")
    # the last phases run no model of the earlier ones: free them
    del eng, drv, eye, da3_eng
    gc.collect()
    torch.cuda.empty_cache()
    stereo_paths = phase_stereo_paths(metric, frames, dev, zero_counts,
                                      expect_counts, smi[0])
    mark("stereo_paths")
    gc.collect()
    torch.cuda.empty_cache()
    single_frame = phase_single_frame(frames, sbs, dev, zero_counts, counts,
                                      expect_counts, smi[0])
    mark("single_frame")
    gc.collect()
    torch.cuda.empty_cache()
    depth_engines = phase_depth_engines(metric, frames, dev, zero_counts,
                                        expect_counts, smi[0])
    mark("depth_engines")
    gc.collect()
    torch.cuda.empty_cache()
    tracking = phase_tracking(metric, frames, dev, zero_counts,
                              expect_counts, smi[0])
    mark("tracking")

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
        # MoGe-L's single-view shape (phase 12, single_frame)
        "single_view_launches": single_frame["b4"]["launches"],
        "single_view": {k: single_frame["b4"][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "error_ratio", "route_max", "route_mean")},
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
    log(json.dumps({"single_frame": single_frame, "card": smi[0]}))
    log(json.dumps({"depth_engines": depth_engines, "card": smi[0]}))
    log(json.dumps({"tracking": tracking, "card": smi[0]}))
    log(json.dumps({"phase_end_s": phase_end_s}))
    log(json.dumps({"kernels": kernels}))
    log(smi[0])
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
