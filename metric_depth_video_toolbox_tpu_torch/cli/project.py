"""CLI: headless project manager (the port of the JAX package's
``cli/project.py``): create / status / set (a per-scene override) / split
(a scene at a frame) / run (the movie pipeline, resumable)."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Manage a movie->3D project directory.")
    sub = p.add_subparsers(dest="verb", required=True)

    c = sub.add_parser("create", help="create a project for a movie")
    c.add_argument("--project_dir", required=True)
    c.add_argument("--color_video", required=True)
    c.add_argument("--depth_engine", default="vda")
    c.add_argument("--infill_engine", default="basic")
    c.add_argument("--xfov", type=float)

    s = sub.add_parser("status", help="per-scene progress table")
    s.add_argument("--project_dir", required=True)

    o = sub.add_parser("set", help="per-scene override "
                                   "(Engine/Infill/Convergence)")
    o.add_argument("--project_dir", required=True)
    o.add_argument("--scene", type=int, required=True)
    o.add_argument("--column", required=True,
                   choices=["Engine", "Infill", "Convergence"])
    o.add_argument("--value", required=True)

    sp = sub.add_parser("split", help="split a scene at a frame")
    sp.add_argument("--project_dir", required=True)
    sp.add_argument("--scene", type=int, required=True)
    sp.add_argument("--at_frame", type=int, required=True)

    r = sub.add_parser("run", help="run the pipeline (resumable)")
    r.add_argument("--project_dir", required=True)
    r.add_argument("--end_scene", type=int, default=-1)
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        project as proj_mod
    if args.verb == "create":
        proj = proj_mod.create_project(
            args.project_dir, args.color_video,
            depth_engine=args.depth_engine,
            infill_engine=args.infill_engine, xfov=args.xfov)
        print(f"project created: {proj.root} "
              f"({len(proj.scenes())} scenes)")
        return proj
    proj = proj_mod.open_project(args.project_dir)
    if args.verb == "status":
        rows = proj_mod.status(proj)
        cols = ["scene", "frames", "engine", "clip", "depth", "mask",
                "sbs", "infilled"]
        print(" | ".join(f"{c:>8s}" for c in cols))
        for r in rows:
            print(" | ".join(f"{str(r[c]):>8s}" for c in cols))
        return rows
    if args.verb == "set":
        proj_mod.set_scene_override(proj, args.scene, args.column,
                                    args.value)
        print(f"scene {args.scene}: {args.column} = {args.value}")
        return
    if args.verb == "split":
        out = proj_mod.split_scene(proj, args.scene, args.at_frame)
        print(f"scene {args.scene} split at {args.at_frame}; "
              f"{len(out)} scenes now")
        return out
    if args.verb == "run":
        out = proj_mod.run_project(proj, end_scene=args.end_scene,
                                   device=device)
        print(f"3D movie saved: {out}")
        return out


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
