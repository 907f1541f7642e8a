"""CLI: color video -> metric depth video via the VDA engine.

The same flags and defaults as the JAX package's
``cli/video_metric_convert.py``, including the ``.txt`` batch-list
protocol. Flags whose path is not ported yet raise NotImplementedError.
"""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Temporally consistent metric depth video from a color "
                    "video (Video-Depth-Anything-class engine).")
    p.add_argument("--color_video", type=str, required=True,
                   help="video file or .txt list of video files")
    p.add_argument("--depth_video", type=str,
                   help="reference metric depth video used as the anchor "
                        "instead of the single-frame metric model")
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--target_fps", default=-1, type=int,
                   help="decimate input to this fps (-1 = original)")
    p.add_argument("--input_size", default=518, type=int)
    p.add_argument("--model_size", "--model", dest="model_size",
                   default="vits",
                   choices=["vitt", "vits", "vitb", "vitl", "vitg"])
    p.add_argument("--fp32", action="store_true",
                   help="full float32 inference (default is bfloat16)")
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="int8 = dynamically quantized backbone matmuls "
                        "(not ported yet)")
    p.add_argument("--window", type=int, default=None)
    p.add_argument("--rolling_average", type=int, default=0, metavar="N",
                   help="rolling-average affine->metric alignment over an "
                        "N-frame window (0 = first-frames fit)")
    p.add_argument("--no_rolling_average", action="store_true",
                   help="force the first-frames fit (the default)")
    p.add_argument("--checkpoint", type=str,
                   help="converted checkpoint (not ported yet)")
    p.add_argument("--profile", type=str, metavar="DIR",
                   help="capture a profiler trace into DIR (not ported "
                        "yet)")
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage

    if args.checkpoint:
        raise NotImplementedError("not ported yet: --checkpoint "
                                  "(ROADMAP A5: checkpoint converters)")
    if args.profile:
        raise NotImplementedError("not ported yet: --profile")
    outs = dstage.run_batch(
        "vda", args.color_video, max_depth=args.max_depth,
        max_frames=args.max_frames, target_fps=args.target_fps,
        input_size=args.input_size, size=args.model_size,
        window=args.window, fp32=args.fp32,
        reference_depth_video=args.depth_video,
        quantize=None if args.quantize == "none" else args.quantize,
        rolling_average=(0 if args.no_rolling_average
                         else args.rolling_average),
        device=device)
    for o in outs:
        print(f"depth video saved: {o}")
    return outs


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
