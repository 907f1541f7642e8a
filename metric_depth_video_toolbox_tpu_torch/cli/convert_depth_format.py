"""CLI: depth video -> other formats (grayscale, PLY / OBJ, triangulated
clouds, the rescaled depth video, a turntable render of the clouds, the
camera track), with the flags and defaults of the JAX package's
``cli/convert_depth_format.py``; the work runs in ``pipeline/export.py``."""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Export a metric depth video to other formats.")
    p.add_argument("--depth_video", type=str, required=True)
    p.add_argument("--color_video", type=str)
    p.add_argument("--track_file", type=str)
    p.add_argument("--transformation_file", type=str)
    p.add_argument("--xfov", type=float)
    p.add_argument("--yfov", type=float)
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--min_frames", default=-1, type=int,
                   help="start conversion after nr of frames")
    p.add_argument("--save_ply", default=0,
                   help="int N: save every Nth frame as .ply; or a "
                        "folder: save every frame there")
    p.add_argument("--save_obj", default=0,
                   help="int N: save every Nth frame as .obj mesh; or a "
                        "folder: save every frame there")
    p.add_argument("--triangulate", "--use_triangulated_points",
                   dest="triangulate", action="store_true",
                   help="triangulate tracked points from multi-ray "
                        "intersection")
    p.add_argument("--min_observations",
                   "--tringulation_min_observations",
                   dest="min_observations", default=10, type=int,
                   help="observations required for a track to be "
                        "triangulated")
    p.add_argument("--save_rescaled_depth", action="store_true")
    p.add_argument("--global_align", action="store_true")
    p.add_argument("--save_grayscale", action="store_true")
    p.add_argument("--bit16", action="store_true",
                   help="16-bit mono grayscale video export")
    p.add_argument("--bit8", action="store_true",
                   help="8-bit rgb grayscale video export")
    p.add_argument("--remove_edges", action="store_true",
                   help="cull mesh faces at depth discontinuities in "
                        ".obj export")
    p.add_argument("--transformation_lock_frame", default=0, type=int,
                   help="the frame that the transformation will use as "
                        "a base")
    p.add_argument("--mask_video", type=str,
                   help="black and white mask video for things that "
                        "should not be tracked")
    p.add_argument("--strict_mask", action="store_true",
                   help="drop points that were EVER masked, even in "
                        "frames where they are not")
    p.add_argument("--merge_close_points", action="store_true",
                   help="merge triangulated points that are very close")
    p.add_argument("--save_normals", action="store_true",
                   help="estimate per-point normals for the exported "
                        "clouds (KNN covariance on the device, "
                        "ops/knn.py) "
                        "and write them into the PLYs")
    p.add_argument("--show_scene_point_clouds", action="store_true",
                   help="headless build: renders the resulting clouds "
                        "to an offline turntable video instead of a "
                        "window")
    p.add_argument("--show_both_point_clouds", action="store_true")
    p.add_argument("--save_alembic", action="store_true",
                   help="export camera track (+ triangulated cloud) for "
                        "DCC tools; .abc when bpy is available, JSON "
                        "camera track otherwise")
    return p


def _every_or_dir(value):
    """``--save_ply`` / ``--save_obj``: an integer N (every Nth frame) or a
    folder (every frame, written there). -> (every_n, folder)"""
    import os
    if value in (0, "0", None, ""):
        return 0, None
    try:
        return int(value), None
    except (TypeError, ValueError):
        os.makedirs(value, exist_ok=True)
        return 0, value


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.io import pointcloud as pcio
    from metric_depth_video_toolbox_tpu_torch.pipeline import export

    ply_every, ply_dir = _every_or_dir(args.save_ply)
    obj_every, obj_dir = _every_or_dir(args.save_obj)
    out = export.export_video(
        args.depth_video, tracking_file=args.track_file,
        transformation_file=args.transformation_file,
        color_video=args.color_video, xfov=args.xfov, yfov=args.yfov,
        max_depth=args.max_depth, max_frames=args.max_frames,
        min_frames=args.min_frames,
        save_ply_every=ply_every, save_obj_every=obj_every,
        ply_dir=ply_dir, obj_dir=obj_dir,
        min_observations=args.min_observations,
        triangulate=args.triangulate,
        save_rescaled_depth=args.save_rescaled_depth,
        global_align=args.global_align,
        grayscale=args.save_grayscale or args.bit16 or args.bit8,
        bit16_grayscale=args.bit16,
        remove_edges=args.remove_edges,
        lock_frame=args.transformation_lock_frame,
        mask_video=args.mask_video, strict_mask=args.strict_mask,
        merge_close_points=args.merge_close_points,
        save_normals=args.save_normals, device=device)
    if args.show_scene_point_clouds:
        sets = []
        if "avgmonodepth" in out:
            sets.append(pcio.read_ply(out["avgmonodepth"]))
        if "triangulated" in out and (args.show_both_point_clouds
                                      or not sets):
            sets.append(pcio.read_ply(out["triangulated"]))
        if sets:
            out["cloud_render"] = export.render_point_cloud_video(
                sets, args.depth_video + "_clouds.mkv",
                xfov=args.xfov or 60.0, device=device)
        else:
            print("no point clouds produced to show "
                  "(need --triangulate with a track file)")
    if args.save_alembic and args.transformation_file:
        from metric_depth_video_toolbox_tpu_torch.io import sidecar
        from metric_depth_video_toolbox_tpu_torch.io import video as vio
        transforms = sidecar.load_transformations(args.transformation_file)
        _, w, h, fps = vio.video_info(args.depth_video)
        pts = cols = None
        if "triangulated" in out:
            pts, cols = pcio.read_ply(out["triangulated"])
        out.update(export.export_camera_track(
            transforms, args.xfov or 50.0, w, h, fps, args.depth_video,
            points=pts, colors=cols))
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
