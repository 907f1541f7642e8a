"""Per-engine depth CLI family (the port of the JAX package's
``cli/depth_engines.py``): one thin wrapper per engine.

  mdvt-torch engine unidepth   single-frame metric depth, --xfov required
  mdvt-torch engine unik3d     single-frame, per-frame FOV -> _xfovs.json
  mdvt-torch engine moge       single-frame, optional --xfov; _xfovs.json
  mdvt-torch engine depthpro   single-frame, the model's own FOV
  mdvt-torch engine videoanythingmetric   the VDA engine (--fp32)
  mdvt-torch engine da3        DA3 windowed multi-view depth + poses + xfovs
  mdvt-torch da3               the same as engine da3

``mdvt-torch engine <name>`` dispatches as the JAX package's ``mdvt engine``
does; depthcrafter, geometrycrafter and mvsa exit naming their ROADMAP item
(A13b, A13c). ``--checkpoint`` reads a converted checkpoint: a MoGe,
UniDepth-V2, UniK3D or DepthPro tree switches its engine onto the real
graph.

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
                   help="converted checkpoint (models.convert)")
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


def _quant(args):
    return None if args.quantize in (None, "none") else args.quantize


def _run_single_frame(args, save_xfovs, variant="da", device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage

    params = None
    if args.checkpoint:
        from metric_depth_video_toolbox_tpu_torch.models import convert
        params = convert.load_checkpoint(args.checkpoint)
    outs = dstage.run_batch(
        "single_frame", args.color_video, max_depth=args.max_depth,
        max_frames=args.max_frames, size=args.model_size,
        input_size=args.input_size, params=params, xfov=args.xfov,
        yfov=args.yfov, save_xfovs=save_xfovs, variant=variant,
        target_fps=args.target_fps, quantize=_quant(args), device=device)
    outs = _relocate(outs, args.output_dir)
    for o in outs:
        print(f"depth video saved: {o}")
    return outs


def unidepth_main(argv=None):
    """Known-camera conditioning: --xfov is mandatory and its rays condition
    the model."""
    args = _base_parser("UniDepth-class per-frame metric depth "
                        "(FOV required).", require_fov=True).parse_args(argv)
    return _run_single_frame(args, save_xfovs=False, variant="unidepth")


def unik3d_main(argv=None):
    """Per-frame focal re-estimated from the model's 3D points ->
    *_xfovs.json."""
    args = _base_parser("UniK3D-class per-frame metric depth; estimates "
                        "per-frame FOV -> *_xfovs.json.").parse_args(argv)
    return _run_single_frame(args, save_xfovs=True, variant="unik3d")


def moge_main(argv=None):
    """Masked sky -> max_depth; an optional --xfov fixes the focal, else
    the point map's focal solve estimates it."""
    args = _base_parser("MoGe-class per-frame depth with optional fov_x; "
                        "writes xfovs.").parse_args(argv)
    return _run_single_frame(args, save_xfovs=True, variant="moge")


def depthpro_main(argv=None):
    """The model estimates its own focal length per frame ->
    *_xfovs.json."""
    args = _base_parser("DepthPro-class per-frame metric depth (estimates "
                        "focal length).").parse_args(argv)
    return _run_single_frame(args, save_xfovs=True, variant="depthpro")


def videoanythingmetric_main(argv=None):
    """The VDA engine with --fp32. As in the JAX package, --output_dir,
    --checkpoint, --xfov and --yfov are accepted and not passed on."""
    p = _base_parser("Metric-Video-Depth-Anything-class direct metric "
                     "video depth.")
    p.add_argument("--fp32", action="store_true",
                   help="full-precision inference (default bfloat16)")
    args = p.parse_args(argv)
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    outs = dstage.run_batch("vda", args.color_video,
                            max_depth=args.max_depth,
                            max_frames=args.max_frames,
                            size=args.model_size,
                            input_size=args.input_size,
                            fp32=args.fp32,
                            target_fps=args.target_fps,
                            quantize=_quant(args))
    for o in outs:
        print(f"depth video saved: {o}")
    return outs


def build_da3_parser():
    p = _base_parser("DA3-class windowed multi-view depth + poses.")
    p.set_defaults(model_size="vitl")
    p.add_argument("--images_per_batch", default=40, type=int)
    p.add_argument("--batch_overlap", default=6, type=int)
    p.add_argument("--nr_of_ref_frames", default=6, type=int)
    p.add_argument("--da3_resolution", default=504, type=int)
    p.add_argument("--backbone_checkpoint", type=str,
                   help="converted DINOv2 ViT checkpoint to graft into "
                        "the DA3 backbone")
    p.add_argument("--xfov_file", type=str,
                   help="per-frame xfov json (e.g. *_xfovs.json): "
                        "known-intrinsics conditioning")
    return p


def run_da3(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage

    # --checkpoint is accepted and ignored, as by the JAX package's
    # da3_main; --backbone_checkpoint's weights are grafted
    xfovs = None
    if args.xfov_file:
        from metric_depth_video_toolbox_tpu_torch.io import sidecar
        xfovs = sidecar.load_xfovs(args.xfov_file)
    outs = dstage.run_batch(
        "da3", args.color_video, max_depth=args.max_depth,
        max_frames=args.max_frames, size=args.model_size,
        images_per_batch=args.images_per_batch,
        overlap=args.batch_overlap, num_ref_frames=args.nr_of_ref_frames,
        resolution=args.da3_resolution,
        backbone=args.backbone_checkpoint, xfov=args.xfov, yfov=args.yfov,
        xfovs=xfovs, quantize=_quant(args), device=device)
    outs = _relocate(outs, args.output_dir)
    for o in outs:
        print(f"depth video saved: {o}")
    return outs


def da3_main(argv=None):
    return run_da3(build_da3_parser().parse_args(argv))


# the JAX package's engines, in its order; None: not ported yet
MAINS = {
    "unidepth": unidepth_main,
    "unik3d": unik3d_main,
    "moge": moge_main,
    "depthpro": depthpro_main,
    "videoanythingmetric": videoanythingmetric_main,
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
        from metric_depth_video_toolbox_tpu_torch.pipeline.depth import \
            LATER_ENGINES
        raise SystemExit(f"mdvt-torch engine {name}: not ported yet (see "
                         f"ROADMAP.md, {LATER_ENGINES[name]})")
    return MAINS[name](argv[1:])
