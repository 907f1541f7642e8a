"""CLI: colour video -> 2D point tracks (the port of
``cli/track_points_in_video.py``, the same flags and defaults) ->
``<color_video>_tracking.json`` (and ``_tracking.json_tracked.mkv`` with
``--track_visualization``). Runs on the CUDA device unless
``MDVT_PLATFORM=cpu``."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Track points through a video -> *_tracking.json.")
    p.add_argument("--color_video", type=str, required=True)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--grid", default=36, type=int)
    p.add_argument("--clip_len", default=120, type=int)
    p.add_argument("--downscale", default=1, type=int,
                   help="downscale frames before tracking (coordinates "
                        "are scaled back to full resolution)")
    p.add_argument("--nr_iterations", default=1, type=int,
                   help="repeat tracking with shifted grids; more "
                        "iterations = more points")
    p.add_argument("--steps_bewtwen_track_init",
                   "--steps_between_track_init",
                   dest="steps_between_init", default=60, type=int,
                   help="clip stride: how often to seek new tracking "
                        "points, in frames (staggered overlap streams)")
    p.add_argument("--track_visualization",
                   "--save_visulization_video",
                   dest="track_visualization", action="store_true")
    p.add_argument("--engine", default="lk",
                   choices=["lk", "cotracker3"],
                   help="tracking core: pyramidal LK (default) or "
                        "CoTracker3 (seeded weights without --weights)")
    p.add_argument("--weights", default=None, type=str,
                   help="converted cotracker3 checkpoint (models.convert) "
                        "or the torch scaled_offline.pth (converted on "
                        "load)")
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import tracking
    out = tracking.track_video(
        args.color_video, clip_len=args.clip_len, grid=args.grid,
        max_frames=args.max_frames, save_viz=args.track_visualization,
        downscale=args.downscale, nr_iterations=args.nr_iterations,
        steps_between_init=args.steps_between_init,
        engine=args.engine, weights=args.weights, device=device)
    print(f"tracking saved: {out}")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
