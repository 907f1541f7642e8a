"""CLI: moving objects and tracking errors from tracks against depth, with
the flags and defaults of the JAX package's ``cli/analyse_depth.py``;
writes a point cloud with the moving tracks red
(``pipeline/analyse.py::analyse_depth_movement``)."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Detect moving objects / tracking errors; writes a "
                    "movement-colored point cloud.")
    p.add_argument("--depth_video", type=str, required=True)
    p.add_argument("--track_file", type=str, required=True)
    p.add_argument("--transformation_file", type=str)
    p.add_argument("--xfov", type=float)
    p.add_argument("--yfov", type=float)
    p.add_argument("--mask_video", type=str,
                   help="black/white mask video: white = exclude from "
                        "analysis")
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_frames", default=-1, type=int)
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import analyse
    out, moving = analyse.analyse_depth_movement(
        args.depth_video, args.track_file,
        transformation_file=args.transformation_file, xfov=args.xfov,
        yfov=args.yfov, mask_video=args.mask_video,
        max_depth=args.max_depth, max_frames=args.max_frames, device=device)
    print(f"movement cloud: {out}")
    print(f"moving tracks: {moving}")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
