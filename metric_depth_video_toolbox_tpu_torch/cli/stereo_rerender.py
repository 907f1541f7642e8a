"""CLI: depth(+color) video -> stereo SBS / Touchly / VR180 video.

The same flags and defaults as the JAX package's
``cli/stereo_rerender.py``.
"""

from __future__ import annotations

import argparse
import json

def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Convert an RGB-encoded depth video and optional color "
                    "video into a stereoscopic 3D side-by-side output.")
    p.add_argument("--depth_video", type=str, required=True)
    p.add_argument("--color_video", type=str)
    p.add_argument("--xfov", type=float)
    p.add_argument("--yfov", type=float)
    p.add_argument("--xfov_file", type=str)
    p.add_argument("--master_xfov", type=float, default=45.0)
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--transformation_file", type=str)
    p.add_argument("--transformation_lock_frame", default=0, type=int)
    p.add_argument("--pupillary_distance", default=63, type=float)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--convergence_file", type=str)
    p.add_argument("--touchly0", action="store_true")
    p.add_argument("--touchly1", action="store_true")
    p.add_argument("--touchly_max_depth", default=5, type=float)
    p.add_argument("--touchly_min_depth", default=0, type=float)
    p.add_argument("--vr180", action="store_true")
    p.add_argument("--infill_mask", action="store_true")
    p.add_argument("--green_and_black_infill_mask", action="store_true")
    p.add_argument("--remove_edges", action="store_true")
    p.add_argument("--dont_remove_edges", action="store_true")
    p.add_argument("--dont_place_points_in_edges", action="store_true")
    p.add_argument("--do_basic_infill", action="store_true")
    p.add_argument("--create_sbs_depth_video", action="store_true")
    p.add_argument("--render_as_pointcloud", action="store_true",
                   help="splat points instead of filled surface cells")
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--num_planes", default=128, type=int,
                   help="disparity-sweep plane count (quality vs speed)")
    p.add_argument("--compressed", action="store_true",
                   help="lossy codec output (smaller, lower quality)")
    p.add_argument("--fused_anchor_sweep", action="store_true",
                   help="render main surface + edge anchors in one fused "
                        "sweep")
    p.add_argument("--mask_video", type=str,
                   help="foreground mask; switches to background-"
                        "accumulation rendering")
    p.add_argument("--save_background", action="store_true")
    p.add_argument("--profile", type=str, metavar="DIR",
                   help="capture a torch.profiler trace of the run into "
                        "DIR (a Chrome trace JSON)")
    p.add_argument("--load_background", type=str)
    return p


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.io import sidecar
    from metric_depth_video_toolbox_tpu_torch.pipeline import stereo
    from metric_depth_video_toolbox_tpu_torch.utils.timer import device_trace

    if args.xfov is None and args.yfov is None and args.xfov_file is None:
        raise SystemExit("Either --xfov_file, --xfov or --yfov is required.")
    if args.green_and_black_infill_mask and args.do_basic_infill:
        raise SystemExit("--green_and_black_infill_mask and "
                         "--do_basic_infill are incompatible.")

    xfovs = sidecar.load_xfovs(args.xfov_file) if args.xfov_file else None
    transformations = (sidecar.load_transformations(args.transformation_file)
                       if args.transformation_file else None)
    convergence = None
    if args.convergence_file:
        with open(args.convergence_file, encoding="utf-8") as f:
            convergence = json.load(f)

    remove_edges = (args.infill_mask or args.remove_edges
                    or args.do_basic_infill)
    if args.dont_remove_edges:
        remove_edges = False

    with device_trace(args.profile):
        out = stereo.render_stereo_video(
            args.depth_video, color_video=args.color_video, xfov=args.xfov,
            yfov=args.yfov, xfovs=xfovs, transformations=transformations,
            convergence_depths=convergence, master_xfov=args.master_xfov,
            max_depth=args.max_depth,
            pupillary_distance_mm=args.pupillary_distance,
            max_frames=args.max_frames, batch_size=args.batch_size,
            infill_mask=args.infill_mask, vr180=args.vr180,
            touchly0=args.touchly0, touchly1=args.touchly1,
            remove_edges=remove_edges, do_basic_infill=args.do_basic_infill,
            place_edge_points=not args.dont_place_points_in_edges,
            green_and_black_infill_mask=args.green_and_black_infill_mask,
            create_sbs_depth=args.create_sbs_depth_video,
            touchly_max_depth=args.touchly_max_depth,
            touchly_min_depth=args.touchly_min_depth,
            transformation_lock_frame=args.transformation_lock_frame,
            mask_video=args.mask_video, save_background=args.save_background,
            load_background=args.load_background,
            render_as_pointcloud=args.render_as_pointcloud,
            num_planes=args.num_planes, compressed=args.compressed,
            fused_anchor_sweep=args.fused_anchor_sweep, device=device)
    print(f"Processing complete. Output saved to: {out}")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
