"""CLI: depth video + 2D tracks -> per-frame camera transforms (the port of
``cli/align_3d_points.py``, the same flags and defaults) ->
``<depth_video>_transformations.json`` (and ``<depth_video>_debug.mkv``
with ``--color_video``, ``_transformations.json_diagnostics.json`` with
``--diagnostics``). Runs on the CUDA device unless ``MDVT_PLATFORM=cpu``."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Solve per-frame camera poses from 2D tracks + depth.")
    p.add_argument("--depth_video", type=str, required=True)
    p.add_argument("--track_file", type=str, required=True)
    p.add_argument("--color_video", type=str,
                   help="color video; enables the debug overlay video")
    p.add_argument("--xfov", type=float)
    p.add_argument("--yfov", type=float)
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--mask_video", type=str)
    p.add_argument("--strict_mask", action="store_true")
    p.add_argument("--use_madpose", action="store_true",
                   help="hybrid pose+depth-scale solver")
    p.add_argument("--assume_stationary_camera", action="store_true")
    p.add_argument("--diagnostics", action="store_true",
                   help="forward-intersection triangulation residuals "
                   "vs frame n-15")
    return p


def run(args, device=None, hybrid_samples=None):
    """``hybrid_samples``: the hybrid solver's minimal sets per frame pair
    (see ``pipeline.align.align_video``)."""
    from metric_depth_video_toolbox_tpu_torch.pipeline import align
    if args.xfov is None and args.yfov is None:
        raise SystemExit("--xfov or --yfov is required")
    solver = "two_group"
    if args.use_madpose:
        solver = "hybrid"
    elif args.assume_stationary_camera:
        solver = "stationary"
    out = align.align_video(
        args.depth_video, args.track_file, xfov=args.xfov, yfov=args.yfov,
        max_depth=args.max_depth, solver=solver,
        mask_video=args.mask_video, strict_mask=args.strict_mask,
        max_frames=args.max_frames, color_video=args.color_video,
        diagnostics=args.diagnostics, device=device,
        hybrid_samples=hybrid_samples)
    print(f"transformations saved: {out}")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
