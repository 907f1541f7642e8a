"""CLI: scene cuts from a tracking file, with the flags and defaults of
the JAX package's ``cli/analyse_tracking.py``
(``pipeline/analyse.py::detect_cuts_from_tracking``, host only)."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Detect scene cuts from track connectivity.")
    p.add_argument("--track_file", type=str, required=True)
    p.add_argument("--color_video", type=str,
                   help="used only for the frame rate")
    p.add_argument("--fps", type=float, default=24.0)
    return p


def run(args):
    from metric_depth_video_toolbox_tpu_torch.pipeline import analyse
    fps = args.fps
    if args.color_video:
        from metric_depth_video_toolbox_tpu_torch.io import video as vio
        _, _, _, fps = vio.video_info(args.color_video)
    events = analyse.detect_cuts_from_tracking(args.track_file, fps=fps)
    for frame, kind in events:
        print(f"--- frame {frame} {frame / fps:.2f}s --- {kind}")
    return events


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
