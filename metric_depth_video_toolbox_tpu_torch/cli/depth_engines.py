"""Per-engine depth CLI family (the port of the JAX package's
``cli/depth_engines.py``): one thin wrapper per engine.

  mdvt-torch engine unidepth   single-frame metric depth, --xfov required
  mdvt-torch engine unik3d     single-frame, per-frame FOV -> _xfovs.json
  mdvt-torch engine moge       single-frame, optional --xfov; _xfovs.json
  mdvt-torch engine depthpro   single-frame, the model's own FOV
  mdvt-torch engine videoanythingmetric   the VDA engine (--fp32)
  mdvt-torch engine da3        DA3 windowed multi-view depth + poses + xfovs
  mdvt-torch da3               the same as engine da3
  mdvt-torch engine depthcrafter     diffusion video depth, made metric
                                     against --depth_video
  mdvt-torch engine geometrycrafter  diffusion point-map stabilizer of a
                                     prior (--depth_video, else MoGe)
  mdvt-torch engine mvsa       pose-conditioned plane-sweep MVS
                               (--transformation_file, --xfov)

``mdvt-torch engine <name>`` dispatches as the JAX package's ``mdvt engine``
does. ``--checkpoint`` reads a converted checkpoint: a MoGe, UniDepth-V2,
UniK3D or DepthPro tree switches its engine onto the real graph; for the
diffusion engines it implies the SVD graph (``--model svd``).
``--quantize int8`` runs the ViT blocks' matmuls in int8 (``ops/quant.py``).

The same flags and defaults as the JAX package.
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
                        "(memory and bandwidth mode; no separate "
                        "checkpoint needed; ops/quant.py)")
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


QUANT_NOTE = ("note: --quantize int8 quantizes the ViT blocks' weights and "
              "activations at every call and multiplies them with the "
              "int8 GEMM (torch._int_mm on the card); it halves the "
              "matmuls' operand traffic, and its speed against bfloat16 is "
              "the card's: see PERF.md")


def _quant(args):
    if args.quantize == "int8":
        print(QUANT_NOTE)
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


def _diffusion_extra(args):
    """cfg / params of the diffusion engines: ``--model svd`` or any
    ``--checkpoint`` (DepthCrafter and GeometryCrafter are SVD fine-tunes)
    selects the SVD graph; else the engine's default, DIFFUSION_TINY."""
    extra = {}
    if args.model == "svd" or args.checkpoint:
        from metric_depth_video_toolbox_tpu_torch.models import svd as svdm
        extra["cfg"] = svdm.SVDConfig()
    if args.checkpoint:
        from metric_depth_video_toolbox_tpu_torch.models import convert
        extra["params"] = convert.load_checkpoint(args.checkpoint)
    return extra


def _add_diffusion_model_flag(p):
    p.add_argument("--model", choices=("tiny", "svd"), default="tiny",
                   help="'svd' = the production SVD-class graph (implied "
                        "by --checkpoint); 'tiny' = a small seeded stand-in "
                        "for smoke runs")
    p.add_argument("--max_res", type=int,
                   help="cap the diffusion working resolution's long side "
                        "(aspect kept, sides rounded to multiples of 64; "
                        "the engine's default cap is 768)")


def _diffusion_work_hw(args):
    """--max_res -> work_hw from the input video's aspect ratio (16 x 9
    when the video cannot be read, as in the JAX package)."""
    if not args.max_res:
        return {}
    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    try:
        _, w, h, _ = vio.video_info(args.color_video)
    except (OSError, RuntimeError, ValueError):
        w = h = 0
    w, h = w or 16, h or 9
    scale = args.max_res / max(w, h)
    return {"work_hw": (max(64, int(round(h * scale / 64)) * 64),
                        max(64, int(round(w * scale / 64)) * 64))}


def depthcrafter_main(argv=None, device=None):
    p = _base_parser("DepthCrafter-class diffusion video depth "
                     "(requires --depth_video reference).")
    p.add_argument("--depth_video", type=str, required=True)
    p.add_argument("--window", default=110, type=int)
    p.add_argument("--overlap", default=25, type=int)
    p.add_argument("--use_depth_prompting", action="store_true",
                   help="experimental: prompt the sampler with the "
                        "reference depth's VAE latent (SDEdit-style init)")
    _add_diffusion_model_flag(p)
    args = p.parse_args(argv)
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    outs = dstage.run_batch(
        "depthcrafter", args.color_video, max_depth=args.max_depth,
        max_frames=args.max_frames, reference_depth_video=args.depth_video,
        window=args.window, overlap=args.overlap,
        use_depth_prompting=args.use_depth_prompting, device=device,
        **_diffusion_work_hw(args), **_diffusion_extra(args))
    for o in outs:
        print(f"depth video saved: {o}")
    return outs


def geometrycrafter_main(argv=None, device=None):
    """The prior depth becomes point maps that condition the denoiser with
    the RGB latent; without --depth_video a MoGe pass is the prior."""
    p = _base_parser("GeometryCrafter-class diffusion depth stabilizer "
                     "(prior = MoGe or a depth video).")
    p.add_argument("--depth_video", type=str,
                   help="prior depth video to stabilize")
    p.add_argument("--window", default=110, type=int)
    p.add_argument("--overlap", default=5, type=int)
    p.add_argument("--xfov_file", type=str,
                   help="per-frame xfov json for the point-map "
                        "unprojection; its median FOV is used (the point "
                        "maps are median-z normalized)")
    p.add_argument("--pmap_vae_checkpoint", type=str,
                   help="converted point_map_vae checkpoint: the dedicated "
                        "point-map encoder and temporal decoder (xyz + "
                        "valid mask) replace the shared denoiser VAE for "
                        "the point-map latents")
    _add_diffusion_model_flag(p)
    args = p.parse_args(argv)
    xfov = args.xfov
    if args.xfov_file:
        import numpy as np

        from metric_depth_video_toolbox_tpu_torch.io import sidecar
        xfov = float(np.median(sidecar.load_xfovs(args.xfov_file)))
    extra = _diffusion_extra(args)
    if args.pmap_vae_checkpoint:
        from metric_depth_video_toolbox_tpu_torch.models import convert
        extra["pmap_vae_params"] = convert.load_checkpoint(
            args.pmap_vae_checkpoint)
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    outs = dstage.run_batch(
        "geometrycrafter", args.color_video, max_depth=args.max_depth,
        max_frames=args.max_frames, xfov=xfov,
        reference_depth_video=args.depth_video, window=args.window,
        overlap=args.overlap, size=args.model_size, device=device,
        **_diffusion_work_hw(args), **extra)
    for o in outs:
        print(f"depth video saved: {o}")
    return outs


def mvsa_main(argv=None, device=None):
    """Plane-sweep cost-volume MVS: --window source views around each
    frame, --resize_w the model's input width."""
    p = _base_parser("MVSAnywhere-class pose-conditioned multi-view "
                     "stereo depth.", require_fov=True)
    p.add_argument("--transformation_file", type=str, required=True)
    p.add_argument("--window", default=7, type=int,
                   help="ref count around target (odd recommended)")
    p.add_argument("--resize_w", default=1024, type=int,
                   help="model input width; keeps aspect")
    p.add_argument("--rescale_to_cost_volume", action="store_true",
                   help="apply the median cost-volume/refined depth "
                   "ratio per frame")
    p.add_argument("--fast_cost_volume", action="store_true",
                   help="speed over quality: half the plane-sweep "
                        "hypotheses")
    args = p.parse_args(argv)
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    params = None
    if args.checkpoint:
        from metric_depth_video_toolbox_tpu_torch.models import convert
        params = convert.load_checkpoint(args.checkpoint)
    outs = dstage.run_batch(
        "mvsa", args.color_video, max_depth=args.max_depth,
        max_frames=args.max_frames, xfov=args.xfov, yfov=args.yfov,
        transformation_file=args.transformation_file,
        size=args.model_size, window=args.window, resize_w=args.resize_w,
        rescale_to_cost_volume=args.rescale_to_cost_volume,
        fast_cost_volume=args.fast_cost_volume, params=params,
        device=device)
    for o in outs:
        print(f"depth video saved: {o}")
    return outs


# the JAX package's engines, in its order
MAINS = {
    "unidepth": unidepth_main,
    "unik3d": unik3d_main,
    "moge": moge_main,
    "depthpro": depthpro_main,
    "videoanythingmetric": videoanythingmetric_main,
    "da3": da3_main,
    "depthcrafter": depthcrafter_main,
    "geometrycrafter": geometrycrafter_main,
    "mvsa": mvsa_main,
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
    return MAINS[name](argv[1:])
