"""CLI: view or render a depth video in 3D, with the flags and defaults of
the JAX package's ``cli/view_depthfile.py``. Without ``--render`` it serves
the interactive web viewer (``pipeline/viewer.py``) until interrupted; with
``--render`` it renders a free camera's view to a video
(``pipeline/view.py``)."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Render novel views of a metric depth video.")
    p.add_argument("--depth_video", type=str, required=True)
    p.add_argument("--color_video", type=str)
    p.add_argument("--xfov", type=float, default=50.0)
    p.add_argument("--yfov", type=float)
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--remove_edges", action="store_true",
                   help="cull stretched cells at depth discontinuities")
    p.add_argument("--show_camera", action="store_true",
                   help="draw the source camera frustum")
    p.add_argument("--draw_frame", default=-1, type=int,
                   help="render only this frame")
    p.add_argument("--compressed", action="store_true",
                   help="lossy codec output (smaller, lower quality)")
    p.add_argument("--transformation_lock_frame", default=0, type=int)
    p.add_argument("--transformation_file", type=str)
    p.add_argument("--mask_video", type=str)
    p.add_argument("--invert_mask", action="store_true")
    p.add_argument("--background_ply", type=str)
    p.add_argument("--render_as_pointcloud", action="store_true")
    p.add_argument("--x", type=float, default=0.0)
    p.add_argument("--y", type=float, default=0.0)
    p.add_argument("--z", type=float, default=0.0)
    p.add_argument("--tx", type=float)
    p.add_argument("--ty", type=float)
    p.add_argument("--tz", type=float)
    p.add_argument("--render", action="store_true",
                   help="render to video instead of the interactive viewer")
    p.add_argument("--port", type=int, default=8124,
                   help="interactive viewer port")
    p.add_argument("--viewer_max_points", type=int, default=400_000,
                   help="point budget per interactive frame")
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.io import sidecar
    from metric_depth_video_toolbox_tpu_torch.pipeline import view

    transforms = (sidecar.load_transformations(args.transformation_file)
                  if args.transformation_file else None)
    if not args.render:
        from metric_depth_video_toolbox_tpu_torch.pipeline import viewer
        viewer.serve(
            args.depth_video, color_video=args.color_video, port=args.port,
            background_ply=args.background_ply, mask_video=args.mask_video,
            invert_mask=args.invert_mask, xfov=args.xfov, yfov=args.yfov,
            max_depth=args.max_depth, transformations=transforms,
            transformation_lock_frame=args.transformation_lock_frame,
            remove_edges=args.remove_edges,
            max_points=args.viewer_max_points, max_frames=args.max_frames,
            device=device)
        return None
    target = None
    if args.tx is not None or args.ty is not None or args.tz is not None:
        target = (args.tx or 0.0, args.ty or 0.0, args.tz or 0.0)
    out = view.render_novel_view_video(
        args.depth_video, color_video=args.color_video, xfov=args.xfov,
        yfov=args.yfov, max_depth=args.max_depth,
        camera_pos=(args.x, args.y, args.z), look_at_target=target,
        transformations=transforms, mask_video=args.mask_video,
        invert_mask=args.invert_mask, background_ply=args.background_ply,
        as_pointcloud=args.render_as_pointcloud, max_frames=args.max_frames,
        remove_edges=args.remove_edges, show_camera=args.show_camera,
        draw_frame=args.draw_frame, compressed=args.compressed,
        transformation_lock_frame=args.transformation_lock_frame,
        device=device)
    print(f"render saved: {out}")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
