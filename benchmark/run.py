#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``: the model's widths and engine settings, run by
the adapter ``engines/<kind>.py``) and a traffic mix
(``traffic/<mix>.json``, read by ``traffic/generator.py``). Set-up draws
the weights and the shots' frames on the card from the seed, builds the
port's engine, and runs every shape the shots will use once. The window
then hands the converter one shot at a time (a closed loop): the depth
stage (the engine's ``infer_video``) and the stereo stage (the depth coded
to RGB by ``ops/codec.py`` and ``pipeline/stereo.py::stereo_step`` in
batches). It runs whole passes of the mix's shots, at least one, and
starts no further pass once ``--seconds`` have passed, so every run
measures the same work whatever the speed.

With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read by
``metrics/<name>.py``. Once the window has closed, the program's output is
compared with the plain float32 reference (``reference/``): the depth of
a shot drawn from the seed among those done, and the stereo stage's
side-by-side image and infill mask of frames drawn from the seed.

``--rehearse FILE`` runs the same code on the CPU with the small
configuration and traffic of FILE (``tests/rehearse_<config>.json``) and
prints no metric.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

T_IMPORT = time.time()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "metric_depth_video_toolbox_tpu")
PORT = "metric_depth_video_toolbox_tpu_torch"


def process_start():
    """The wall time at which this process started (from /proc), or the
    time this module was first run."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_IMPORT


T_START = process_start()


def cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its kernels under ``build/`` beside its package."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("MDVT_PLATFORM", None)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(code, msg):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def refuse_jax():
    """Exit 4, printing no result, if JAX, Flax or the JAX package is
    loaded in this process."""
    bad = forbidden_modules()
    if bad:
        fail(4, f"modules of JAX or the JAX package were loaded: {bad}")


def load_json(path):
    return json.loads(Path(path).read_text())


def cell_metrics(bench, section, cell):
    """The metrics of ``section`` that the cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name, view):
    mod = importlib.import_module(f"metrics.{name}")
    return mod.read(view)


class RunView:
    """What the metric readers read: spans, counts, the window, the
    device's timeline (traced runs) and the peaks of the card."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def span_s(self, label):
        return sum(t1 - t0 for lab, t0, t1 in self.spans if lab == label)


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from ``rng``."""

    def __init__(self, k, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make):
        """Count one item; keep ``make()`` if it is drawn."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = make()


def stereo_inputs(xfovs, conv, w, h, master_xfov):
    """The stereo step's per-frame cameras, transforms, convergence depths
    and FOV scales, as the movie's step 5 (``render_stereo_video``) makes
    them."""
    import numpy as np
    import torch

    from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo

    ks, scales = [], []
    for xf in xfovs:
        ks.append(geo.camera_matrix_from_fov(w, h, xfov_deg=float(xf))
                  .numpy())
        scales.append(1.0 / (math.tan(math.radians(master_xfov / 2))
                             / math.tan(math.radians(float(xf) / 2))))
    b = len(xfovs)
    return (np.stack(ks).astype(np.float32),
            np.tile(np.eye(4, dtype=np.float32), (b, 1, 1)),
            np.full(b, conv, np.float32), np.asarray(scales, np.float32))


class Cell:
    """One cell's configuration, traffic and engine for one seed."""

    def __init__(self, name, seed, device, rehearsal=None, quantize=None):
        from traffic import generator

        self.name = name
        self.spec = load_json(HERE / "workloads" / f"{name}.json")
        if rehearsal is None:
            self.cfg = load_json(HERE / "configs"
                                 / f"{self.spec['config']}.json")
            self.mix = generator.load(self.spec["traffic"])
        else:
            self.cfg, self.mix = rehearsal["config"], rehearsal["traffic"]
        self.seed = seed
        self.device = device
        kind = importlib.import_module(f"engines.{self.cfg['kind']}")
        self.kind = kind
        self.adapter = kind.Adapter(self.cfg, seed, device,
                                    quantize=quantize)
        self.h, self.w = self.mix["height"], self.mix["width"]
        self.adapter.prepare(self.h, self.w)
        self.shots = generator.FilmShots(self.mix, seed, device)
        st = self.spec["stereo"]
        from metric_depth_video_toolbox_tpu_torch.pipeline import stereo
        self.stereo_cfg = stereo.StereoConfig(
            width=self.w, height=self.h, max_depth=st["max_depth"],
            pupillary_distance_m=st["pupillary_distance_mm"] / 1000.0,
            remove_edges=True, place_edge_points=True, make_infill_mask=True,
            has_convergence=True, warp_method="sweep",
            num_planes=st["num_planes"])

    def reference_settings(self):
        """The stereo settings of the cell, for the plain reference."""
        from reference import stereo as ref_stereo

        st = self.spec["stereo"]
        return ref_stereo.StereoSettings(
            max_depth=st["max_depth"],
            pupillary_distance_m=st["pupillary_distance_mm"] / 1000.0,
            num_planes=st["num_planes"], master_xfov=st["master_xfov"])

    def xfovs(self, out, n):
        import numpy as np
        if self.adapter.xfov_from_engine:
            return np.asarray(out["xfov"], np.float64)
        return np.full(n, self.spec["stereo"]["xfov_deg"])

    def stereo(self, depth, frames, xfovs, conv, keep=None):
        """The stereo stage over a shot in batches: the depth coded to RGB
        on the card, then ``stereo_step``. ``keep(i, image, mask)`` sees
        each frame's results."""
        import torch

        from metric_depth_video_toolbox_tpu_torch.ops import codec
        from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

        st = self.spec["stereo"]
        dev = self.device
        t = depth.shape[0]
        for b0 in range(0, t, st["batch"]):
            sl = slice(b0, min(b0 + st["batch"], t))
            ks, tfs, convs, scales = stereo_inputs(
                xfovs[sl], conv, self.w, self.h, st["master_xfov"])
            rgb = codec.encode_depth_frame(
                torch.as_tensor(depth[sl]).to(dev), st["max_depth"])
            out = stereo.stereo_step(
                self.stereo_cfg, rgb, torch.as_tensor(frames[sl]).to(dev),
                torch.as_tensor(ks, device=dev),
                torch.as_tensor(tfs, device=dev),
                torch.as_tensor(convs, device=dev),
                torch.as_tensor(scales, device=dev))
            if keep is not None:
                for i in range(out["image"].shape[0]):
                    keep(b0 + i, out["image"][i], out["infill_mask"][i])

    def warm(self):
        """Every shape the shots use, once: the depth stage on a clip of
        each length class the adapter names, the stereo stage at each
        batch size the shots give."""
        import numpy as np

        lengths = self.shots.lengths
        batch = self.spec["stereo"]["batch"]
        pool = self.shots.pool
        for t in self.adapter.warm_lengths(lengths):
            out = self.adapter.depth(pool[:t])
        sizes = sorted({min(batch, t - b0) for t in lengths
                        for b0 in range(0, t, batch)}, reverse=True)
        n = out["depth"].shape[0]
        idx = np.arange(max(sizes)) % n       # the last clip's depth, again
        depth, xf = out["depth"][idx], self.xfovs(out, n)[idx]
        for b in sizes:
            self.stereo(depth[:b], pool[:b], xf[:b], 5.0)


def run_window(cell, seconds, trace, sample_rng, n_frames_kept, device):
    """The measured window: whole passes of the mix's shots, at least one,
    and no pass started after ``seconds``. -> dict of spans, counts and
    kept outputs."""
    import torch

    import devtrace

    spans = []
    rec = devtrace.Recorder(trace)
    scenes = Reservoir(1, sample_rng)
    frames_kept = Reservoir(n_frames_kept, sample_rng)
    done = {"attempted": 0, "failed": 0, "frames": 0, "flops": 0,
            "stereo_bytes": 0, "shot_ends_s": []}
    from counts import flops

    def span(label, fn):
        rec.span(label)
        t0 = time.perf_counter()
        out = fn()
        spans.append((label, t0, time.perf_counter()))
        return out

    t_first = time.perf_counter()
    n_shots = len(cell.shots.lengths)
    k = 0
    while k % n_shots or k == 0 or time.perf_counter() - t_first \
            - rec.overhead_s < seconds:
        frames, conv = cell.shots.shot(k)
        t = frames.shape[0]
        done["attempted"] += 1
        try:
            got = {}

            def keep(i, image, mask):
                got[i] = (image, mask)
            with rec.session():
                out = span("depth", lambda: cell.adapter.depth(frames))
                xf = cell.xfovs(out, t)
                span("stereo", lambda: cell.stereo(out["depth"], frames, xf,
                                                   conv, keep))
            if len(got) != t:
                raise RuntimeError(f"{len(got)} SBS frames of {t}")
        except Exception:     # a scene the program failed
            done["failed"] += 1
            traceback.print_exc()
            k += 1
            continue
        done["frames"] += t
        done["shot_ends_s"].append(round(
            time.perf_counter() - t_first - rec.overhead_s, 3))
        done["flops"] += cell.adapter.scene_flops(t)
        done["stereo_bytes"] += flops.stereo_least_bytes(t, cell.h, cell.w)
        scenes.offer(lambda: {"k": k, "frames": frames, "out": out})
        for i in range(t):
            frames_kept.offer(lambda: {
                "frame": frames[i], "depth": out["depth"][i].copy(),
                "xfov": float(xf[i]), "conv": conv,
                "image": got[i][0], "mask": got[i][1]})
        k += 1
    t_end = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"spans": spans, "timeline": rec.timeline(),
            "window_s": t_end - t_first - rec.overhead_s,
            "passes": k // n_shots,
            "scene": scenes.items,
            "frames_kept": frames_kept.items, **done}


def check(cell, win):
    """The comparisons with the plain reference: the depth (and cameras) of
    the kept shot, the stereo stage's image and mask of the kept frames.
    -> {number: value}"""
    import numpy as np
    import torch

    from reference import models as ref_models
    from reference import stereo as ref_stereo

    ref_models.no_tf32()
    out = {}
    if win["scene"]:
        sc = win["scene"][0]
        ref = cell.adapter.reference(sc["frames"])
        out.update(cell.kind.compare(sc["out"], ref, cell.device))
        del ref
    kept = win["frames_kept"]
    if kept:
        settings = cell.reference_settings()
        dev = cell.device
        off = total = worst = 0
        for j in range(0, len(kept), 4):
            part = kept[j:j + 4]
            image, mask = ref_stereo.render_sbs(
                torch.as_tensor(np.stack([p["depth"] for p in part])).to(dev),
                torch.as_tensor(np.stack([p["frame"] for p in part])).to(dev),
                [p["xfov"] for p in part], [p["conv"] for p in part],
                settings)
            got = torch.as_tensor(np.stack(
                [np.concatenate([p["image"], p["mask"]], 1) for p in part]))
            want = torch.cat([image, mask], 2).cpu()
            diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
            off += int((diff > 1).sum())
            total += diff.numel()
            worst = max(worst, int(diff.max()))
        out["sbs_bytes_off"] = off / total
        out["sbs_max_diff"] = float(worst)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", default=None, metavar="FILE",
                    help="run on the CPU with the small configuration and "
                         "traffic of FILE; prints no metric")
    args = ap.parse_args(argv)

    cache_dirs()
    sys.path[:0] = [str(HERE), str(ROOT)]
    bench_file = ROOT / "BENCHMARK.json"
    if not (ROOT / PORT).is_dir():
        fail(3, f"the program under test, {PORT}/, is not in {ROOT}")
    if not bench_file.exists():
        fail(3, f"no {bench_file}")
    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(2, f"no cell {args.workload!r} in BENCHMARK.json")
    chips = cells[args.workload]["chips"]

    import torch
    if args.rehearse:
        device = torch.device("cpu")
        torch.manual_seed(0)
    else:
        if not torch.cuda.is_available():
            fail(2, "no CUDA device: the benchmark measures the card and "
                    "does not fall back to the CPU")
        if torch.cuda.device_count() < chips:
            fail(2, f"the cell asks for {chips} cards, "
                    f"{torch.cuda.device_count()} are visible")
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)

    import numpy as np

    from traffic import generator

    cell = Cell(args.workload, args.seed, device,
                rehearsal=load_json(args.rehearse) if args.rehearse else None)
    cell.warm()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - T_START

    check_spec = cell.spec["check"]
    sample_rng = generator.host_rng(args.seed, 2)
    from metric_depth_video_toolbox_tpu_torch.ops import warp_sweep
    launches0 = dict(warp_sweep.LAUNCHES)
    win = run_window(cell, args.seconds, bool(args.trace), sample_rng,
                     check_spec["stereo_frames"], device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    launches = {k: v - launches0[k] for k, v in warp_sweep.LAUNCHES.items()}
    refuse_jax()

    timeline = win.pop("timeline")
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    from counts import flops
    view = RunView(spans=win["spans"], window_s=win["window_s"],
                   frames=win["frames"], flops=win["flops"],
                   stereo_bytes=win["stereo_bytes"], timeline=timeline,
                   peaks=flops.peaks(kind), peak_bytes=peak,
                   setup_s=setup_s)

    cell.adapter.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(cell, win)
    limits = check_spec["limits"]
    compared = {k: {"value": numbers[k], "limit": limits[k]}
                for k in limits if k in numbers}
    missing = [k for k in limits if k not in numbers]
    correct = (win["failed"] == 0 and win["attempted"] > 0 and not missing
               and all(c["value"] <= c["limit"] for c in compared.values()))
    info = {k: v for k, v in numbers.items() if k not in limits}
    print(json.dumps({"launches": launches, "scenes": win["attempted"],
                      "passes": win["passes"], "frames": win["frames"],
                      "shot_ends_s":
                      win["shot_ends_s"], "unchecked": info}),
          flush=True)

    if args.rehearse:
        summary = {"rehearsal": {
            "correct_at_these_limits": correct, "attempted":
            win["attempted"], "failed": win["failed"], "frames":
            win["frames"], "checks": compared}}
        refuse_jax()
        print(json.dumps(summary), flush=True)
        return summary

    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, section, args.workload):
        value = read_metric(m["name"], view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu", "kind": kind, "count": chips,
                   "memory_peak_bytes": peak}
    breakdown = None
    if timeline is not None:
        device_info["busy_s"] = timeline.busy_s()
        device_info["window_s"] = timeline.window_s
        breakdown = {"device_ops": timeline.top_ops(),
                     "idle_gaps": timeline.idle_gaps()}
    result = result_line(correct, win["attempted"], win["failed"], metrics,
                         device_info, breakdown, compared)
    for k, c in compared.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    for k in missing:
        print(f"check {k}: not read (limit {limits[k]!r})", file=sys.stderr)
    sys.stderr.flush()
    refuse_jax()      # again: the check and the metric readers import too
    print(json.dumps(result), flush=True)
    return result


def result_line(correct, attempted, failed, metrics, device, breakdown,
                checks):
    """The run's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, and last the
    numbers compared with their limits."""
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


if __name__ == "__main__":
    main()
