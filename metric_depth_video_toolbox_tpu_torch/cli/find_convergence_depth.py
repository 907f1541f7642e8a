"""CLI: depth video (+ mask video) -> per-frame convergence depths (the
port of ``cli/find_convergence_depth.py``, the same flags and
defaults)."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Find the convergence (focus) depth per frame.")
    p.add_argument("--depth_video", type=str, required=True)
    p.add_argument("--mask_video", type=str)
    p.add_argument("--max_depth", default=100, type=float)
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import convergence
    out = convergence.find_convergence_depths(
        args.depth_video, mask_video=args.mask_video,
        max_depth=args.max_depth, device=device)
    print(f"convergence depths saved: {out}")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
