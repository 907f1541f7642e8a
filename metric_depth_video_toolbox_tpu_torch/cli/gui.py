"""CLI: the web project GUI (``pipeline/gui.py``), with the flags and
defaults of the JAX package's ``cli/gui.py``; serves until interrupted."""

from __future__ import annotations

import argparse
import os


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Serve the project GUI for a project directory.")
    p.add_argument("--project_dir", type=str, required=True)
    p.add_argument("--port", type=int, default=8123)
    p.add_argument("--color_video", type=str,
                   help="create the project first if it does not exist")
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import gui, project

    cfg_path = os.path.join(args.project_dir, project.CONFIG_NAME)
    if not os.path.exists(cfg_path):
        if not args.color_video:
            raise SystemExit(
                f"no project at {args.project_dir}; pass --color_video "
                "to create one")
        project.create_project(args.project_dir, args.color_video)
    gui.serve(args.project_dir, port=args.port, device=device)


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
