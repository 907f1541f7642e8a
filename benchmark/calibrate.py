#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the numbers that a run compares
with the plain reference, for the program on many seeds and for the
control on a few, in one process, at the cell's own sizes.

    python benchmark/calibrate.py --workload <cell> --program 11 12 ... \
        --control 31 32 33 [--int8 41 42] [--shot N] [--out FILE]

Per seed: the cell is built as a run builds it, the shot that the seed
draws (or shot ``N`` of the mix's order) goes through the depth and the
stereo stage, and the shot's depth and eight frames drawn from it are
compared as a run compares them. The control (``--control``) is the
reference put in the program's place one precision below the
configuration's bfloat16: every linear and convolution of the depth models
on float8 e4m3 operands, and the stereo step with its decoded depth rounded
to bfloat16. ``--int8`` reads the program's own int8 path (the ViT
blocks' matmuls, ``quantize="int8"``), which leaves the head and the
stereo stage as they are. Each reading is one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402


def reading(name, seed, mode, shot, device, rehearsal=None):
    """One seed's numbers. ``mode``: "program"; "control" (the reference
    at float8 matmuls for the depth, its stereo step with the depth
    rounded to bfloat16); "int8" (the program's own int8 path)."""
    import numpy as np
    import torch

    from reference import models as ref_models
    from reference import stereo as ref_stereo
    from traffic import generator

    t0 = time.perf_counter()
    cell = run.Cell(name, seed, device, rehearsal=rehearsal,
                    quantize="int8" if mode == "int8" else None)
    n = len(cell.shots.lengths)
    k = shot if shot is not None else int(
        generator.host_rng(seed, 3).integers(0, n))
    for j in range(k):          # the pool position a run reaches there
        cell.shots.shot(j)
    frames, conv = cell.shots.shot(k)
    t = frames.shape[0]
    pick = sorted(generator.host_rng(seed, 4).choice(
        t, min(8, t), replace=False).tolist())
    if mode == "control":
        cell.adapter.release()
        ref_models.no_tf32()
        with ref_models.float8_operands():
            out = cell.adapter.reference(frames)
        out["depth"] = out["depth"].cpu().numpy()
        xf = cell.xfovs(out, t)
        settings = cell.reference_settings()
        got = {}
        for i in pick:
            image, mask = ref_stereo.render_sbs(
                torch.as_tensor(out["depth"][i:i + 1]).to(device),
                torch.as_tensor(frames[i:i + 1]).to(device), [xf[i]],
                [conv], settings, round_depth_to=torch.bfloat16)
            got[i] = (image[0].cpu().numpy(), mask[0].cpu().numpy())
    else:
        out = cell.adapter.depth(frames)
        xf = cell.xfovs(out, t)
        got = {}
        cell.stereo(out["depth"], frames, xf, conv,
                    lambda i, a, b: got.__setitem__(i, (a, b)))
        cell.adapter.release()
    kept = [{"frame": frames[i], "depth": out["depth"][i].copy(),
             "xfov": float(xf[i]), "conv": conv, "image": got[i][0],
             "mask": got[i][1]} for i in pick]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    win = {"scene": [{"k": k, "frames": frames, "out": out}],
           "frames_kept": kept}
    numbers = run.check(cell, win)
    d = np.asarray(out["depth"])
    return {"mode": mode, "seed": seed, "shot": k, "frames": int(t),
            "numbers": numbers,
            "depth_stats": [float(d.min()), float(np.median(d)),
                            float(d.max())],
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--int8", type=int, nargs="*", default=[])
    ap.add_argument("--shot", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rehearse", default=None)
    args = ap.parse_args(argv)
    run.cache_dirs()
    import torch
    rehearsal = run.load_json(args.rehearse) if args.rehearse else None
    device = torch.device("cpu" if rehearsal else "cuda:0")
    lines = []
    for mode, seeds in (("program", args.program), ("control", args.control),
                        ("int8", args.int8)):
        for seed in seeds:
            r = reading(args.workload, seed, mode, args.shot, device,
                        rehearsal)
            lines.append(r)
            print(json.dumps(r), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
