"""CLI: camera tracking with global bundle adjustment (the port of
``cli/sam_track_video.py``, the same flags and defaults) ->
``<depth_video>_transformations.json``. Without ``--checkpoint``: LK tracks,
pairwise poses and the global bundle adjustment (also writing
``<color_video>_tracking.json`` and ``<depth_video>_init_transformations
.json``; ``--save_motion_video`` adds ``_transformations.json_motion.mkv``).
With a converted megasam / droid checkpoint: the learned DROID-class
front-end, then the global bundle adjustment unless ``--no_global_ba``.
Runs on the CUDA device unless ``MDVT_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Track the camera through a video using dense point "
                    "tracks + metric depth + global bundle adjustment.")
    p.add_argument("--color_video", type=str, required=True)
    p.add_argument("--depth_video", type=str, required=True)
    p.add_argument("--xfov", type=float)
    p.add_argument("--yfov", type=float)
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--mask_video", type=str,
                   help="motion mask: tracks on masked pixels are "
                        "excluded from the bundle adjustment")
    p.add_argument("--optimize_intrinsic", action="store_true")
    p.add_argument("--ba_iters", default=10, type=int)
    p.add_argument("--save_motion_video", action="store_true")
    p.add_argument("--checkpoint", type=str,
                   help="converted megasam/droid checkpoint "
                        "(models.convert convert_droid): switches onto "
                        "the learned DROID-class front-end; without one "
                        "the LK + Gauss-Newton global BA runs")
    p.add_argument("--droid_window", default=12, type=int,
                   help="frame-graph window for the learned front-end")
    p.add_argument("--droid_iters", default=6, type=int,
                   help="learned update iterations per window")
    p.add_argument("--droid_work_long", default=336, type=int,
                   help="long side of the front-end working resolution "
                        "(features run at 1/8 of this)")
    p.add_argument("--no_global_ba", action="store_true",
                   help="skip the final full-clip bundle adjustment "
                        "after the learned front-end")
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import slam
    if args.xfov is None and args.yfov is None:
        raise SystemExit("--xfov or --yfov is required")
    if args.checkpoint:
        from metric_depth_video_toolbox_tpu_torch.models import convert
        out, res = slam.droid_track_video(
            args.color_video, args.depth_video,
            params=convert.load_checkpoint(args.checkpoint),
            xfov=args.xfov, yfov=args.yfov, max_depth=args.max_depth,
            max_frames=args.max_frames, window=args.droid_window,
            iters=args.droid_iters, work_long=args.droid_work_long,
            mask_video=args.mask_video,
            global_ba=not args.no_global_ba, ba_iters=args.ba_iters,
            device=device)
        print(f"transformations saved: {out} "
              f"(mean residual {res:.2f} px)")
        return out
    out, res = slam.slam_track_video(
        args.color_video, args.depth_video, xfov=args.xfov, yfov=args.yfov,
        max_depth=args.max_depth, max_frames=args.max_frames,
        optimize_intrinsic=args.optimize_intrinsic,
        ba_iters=args.ba_iters, save_motion_video=args.save_motion_video,
        mask_video=args.mask_video, device=device)
    print(f"transformations saved: {out} (mean reproj err {res:.2f} px)")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
