"""CLI: split a side-by-side video into ``_left.mkv`` / ``_right.mkv``
(the port of the JAX package's ``cli/split_sbs_video.py``: lossless video
in, two lossless half-width videos out, frame for frame)."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Split a side-by-side video into _left/_right videos.")
    p.add_argument("--sbs_video", "--color_video", dest="sbs_video",
                   type=str, required=True)
    p.add_argument("--max_frames", default=-1, type=int)
    return p


def run(args):
    from metric_depth_video_toolbox_tpu_torch.io import video as vio

    with vio.VideoReader(args.sbs_video, max_frames=args.max_frames) as r:
        half = r.width // 2
        left = vio.VideoWriter(args.sbs_video + "_left.mkv", r.fps, half,
                               r.height)
        right = vio.VideoWriter(args.sbs_video + "_right.mkv", r.fps, half,
                                r.height)
        n = 0
        for frame in r:
            left.write(frame[:, :half])
            right.write(frame[:, half:])
            n += 1
    left.commit(n)
    right.commit(n)
    print(f"wrote {n} frames to _left/_right videos")
    return args.sbs_video + "_left.mkv", args.sbs_video + "_right.mkv"


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
