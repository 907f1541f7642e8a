"""Per-engine depth CLI family (the DA3 tool of the JAX package's
``cli/depth_engines.py``; its other engines are not ported yet, ROADMAP
A13).

  mdvt-torch engine da3   DA3 windowed multi-view depth + poses + xfovs
  mdvt-torch da3          the same

``mdvt-torch engine <name>`` dispatches as the JAX package's ``mdvt engine``
does; the engines other than da3 exit naming ROADMAP A13.

The same flags and defaults as the JAX package. Flags whose path is not
ported yet raise NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import argparse


def _base_parser(desc, require_fov=False):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--color_video", type=str, required=True)
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_frames", "--max_len", dest="max_frames",
                   default=-1, type=int)
    p.add_argument("--target_fps", default=-1, type=float,
                   help="resample the input to this fps before "
                        "inference (-1 = original fps)")
    p.add_argument("--output_dir", type=str,
                   help="write outputs here instead of next to the "
                        "input video")
    p.add_argument("--xfov", type=float, required=require_fov)
    p.add_argument("--yfov", type=float)
    p.add_argument("--model_size", default="vits")
    p.add_argument("--input_size", default=518, type=int)
    p.add_argument("--checkpoint", type=str,
                   help="converted checkpoint (not ported yet)")
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="int8 = dynamically quantized backbone matmuls "
                        "(not ported yet)")
    return p


def _relocate(outs, output_dir):
    """Move outputs (and their sidecars) into --output_dir."""
    import os
    import shutil
    if not output_dir:
        return outs
    os.makedirs(output_dir, exist_ok=True)
    moved = []
    for o in outs:
        for suffix in ("", "_xfovs.json", "_transformations.json"):
            src = o + suffix
            if os.path.exists(src):
                shutil.move(src, os.path.join(output_dir,
                                              os.path.basename(src)))
        moved.append(os.path.join(output_dir, os.path.basename(o)))
    return moved


def build_da3_parser():
    p = _base_parser("DA3-class windowed multi-view depth + poses.")
    p.set_defaults(model_size="vitl")
    p.add_argument("--images_per_batch", default=40, type=int)
    p.add_argument("--batch_overlap", default=6, type=int)
    p.add_argument("--nr_of_ref_frames", default=6, type=int)
    p.add_argument("--da3_resolution", default=504, type=int)
    p.add_argument("--backbone_checkpoint", type=str,
                   help="converted DINOv2 ViT checkpoint to graft into "
                        "the DA3 backbone (not ported yet)")
    p.add_argument("--xfov_file", type=str,
                   help="per-frame xfov json (e.g. *_xfovs.json): "
                        "known-intrinsics conditioning")
    return p


def run_da3(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage

    if args.checkpoint or args.backbone_checkpoint:
        raise NotImplementedError(
            "not ported yet: --checkpoint / --backbone_checkpoint (ROADMAP "
            "A5: need convert_da3 / the DINOv2 converter and a converted "
            "checkpoint)")
    xfovs = None
    if args.xfov_file:
        from metric_depth_video_toolbox_tpu_torch.io import sidecar
        xfovs = sidecar.load_xfovs(args.xfov_file)
    outs = dstage.run_batch(
        "da3", args.color_video, max_depth=args.max_depth,
        max_frames=args.max_frames, size=args.model_size,
        images_per_batch=args.images_per_batch,
        overlap=args.batch_overlap, num_ref_frames=args.nr_of_ref_frames,
        resolution=args.da3_resolution, xfov=args.xfov, yfov=args.yfov,
        xfovs=xfovs,
        quantize=None if args.quantize == "none" else args.quantize,
        device=device)
    outs = _relocate(outs, args.output_dir)
    for o in outs:
        print(f"depth video saved: {o}")
    return outs


def da3_main(argv=None):
    return run_da3(build_da3_parser().parse_args(argv))


# the JAX package's engines, in its order; None: not ported yet (A13)
MAINS = {
    "unidepth": None,
    "unik3d": None,
    "moge": None,
    "depthpro": None,
    "videoanythingmetric": None,
    "da3": da3_main,
    "depthcrafter": None,
    "geometrycrafter": None,
    "mvsa": None,
}


def main(argv=None):
    """``mdvt-torch engine <name> ...``: dispatch to one engine CLI."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: mdvt-torch engine <name> [engine flags]\n"
              f"engines: {', '.join(MAINS)}")
        return 0 if argv else 2
    name = argv[0]
    if name not in MAINS:
        print(f"unknown engine '{name}'; one of: {', '.join(MAINS)}")
        return 2
    if MAINS[name] is None:
        raise SystemExit(f"mdvt-torch engine {name}: not ported yet (see "
                         f"ROADMAP.md, A13)")
    return MAINS[name](argv[1:])
