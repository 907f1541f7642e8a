"""CLI: full 2D movie -> 3D SBS movie (the port of ``cli/movie_2_3d.py``,
the same flags and defaults).

``--depth_engine`` vda (default), da3, videoanythingmetric, a
single-frame engine (unidepth, unik3d, moge, depthpro, single_frame: two
passes per scene, the second locked to the first's median FOV),
depthcrafter (after a single-frame reference pass per scene),
geometrycrafter (on a MoGe prior) or mvsa (which needs a camera track the
movie has not: the single-frame engine runs instead, with a message).
``--quantize int8`` runs the depth stage's ViT matmuls in int8.
``--parallel`` > 1 raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Convert a full 2D movie into a 3D SBS movie.")
    p.add_argument("--color_video", type=str, required=True)
    p.add_argument("--output_dir", type=str)
    p.add_argument("--depth_engine", type=str, default="vda")
    p.add_argument("--model_size", type=str, default="vits",
                   choices=["vitt", "vits", "vitb", "vitl", "vitg"])
    p.add_argument("--input_size", type=int, default=518)
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="int8 = quantized backbone matmuls for the depth "
                        "stage (ops/quant.py)")
    p.add_argument("--infill_engine", type=str, default="basic",
                   choices=["none", "basic", "diffusion"])
    p.add_argument("--xfov", type=float)
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_scene_frames", default=1500, type=int)
    p.add_argument("--scene_file", type=str)
    p.add_argument("--csv_delimiter", type=str, default=",",
                   help="delimiter used in the scene csv")
    p.add_argument("--end_scene", default=-1, type=int)
    p.add_argument("--no_render", action="store_true",
                   help="skip rendering and subsequent steps")
    p.add_argument("--skip_masks", action="store_true",
                   help="skip subject-mask generation (convergence then "
                        "uses the whole frame)")
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--parallel", default=0, type=int,
                   help="host IO worker threads (not ported yet beyond 1)")
    p.add_argument("--gui", action="store_true",
                   help="this build is headless; points to the project "
                        "manager (mdvt project)")
    return p


def run(args, device=None):
    if args.gui:
        raise SystemExit(
            "this build is headless; use the project manager instead: "
            "mdvt project --help")
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie
    out = movie.movie_to_3d(
        args.color_video, output_dir=args.output_dir,
        engine=args.depth_engine, infill_engine=args.infill_engine,
        xfov=args.xfov, max_depth=args.max_depth,
        max_scene_frames=args.max_scene_frames,
        scene_file=args.scene_file, csv_delimiter=args.csv_delimiter,
        end_scene=args.end_scene, no_render=args.no_render,
        batch_size=args.batch_size, parallel=args.parallel,
        generate_masks=not args.skip_masks,
        engine_kwargs={"size": args.model_size,
                       "input_size": args.input_size,
                       "quantize": (None if args.quantize == "none"
                                    else args.quantize)},
        device=device)
    if args.no_render:
        print("stopped before rendering (--no_render)")
    else:
        print(f"3D movie saved: {out}")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
