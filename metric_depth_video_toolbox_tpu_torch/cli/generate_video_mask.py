"""CLI: color video -> subject mask video (the port of
``cli/generate_video_mask.py``, the same flags and defaults)."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Generate a black/white subject mask video.")
    p.add_argument("--color_video", type=str, required=True,
                   help="video file or .txt list")
    p.add_argument("--output", type=str)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--max_frames", default=-1, type=int)
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    from metric_depth_video_toolbox_tpu_torch.pipeline import masks

    eng = masks.MaskEngine(device=device)
    outs = []
    for v in dstage.expand_batch(args.color_video):
        outs.append(masks.generate_video_mask(
            v, output=args.output if not outs and args.output else None,
            batch_size=args.batch_size, engine=eng,
            max_frames=args.max_frames))
        print(f"mask video saved: {outs[-1]}")
    return outs


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
