"""``mdvt-torch`` -- the port's entry point, multiplexing its tools.

  mdvt-torch movie     movie_2_3d: scenes -> depth -> masks -> convergence
                       -> stereo -> infill -> <movie>_SBS.mkv
  mdvt-torch depth     video_metric_convert (VDA engine)
  mdvt-torch engine    per-engine depth CLIs (unidepth, unik3d, moge,
                       depthpro, videoanythingmetric, da3, depthcrafter,
                       geometrycrafter, mvsa)
  mdvt-torch da3       DA3 multi-view depth + poses + xfovs (= engine da3)
  mdvt-torch stereo    stereo_rerender (SBS, Touchly, VR180, background)
  mdvt-torch mask      generate_video_mask (U²-Net subject masks)
  mdvt-torch convergence  find_convergence_depth
  mdvt-torch infill    SBS infill (every --infill_engine of the JAX CLI)
  mdvt-torch download-weights  fetch published checkpoints, --convert them
  mdvt-torch view      view_depthfile: the interactive web viewer, or with
                       --render the novel-view render to video
  mdvt-torch split-sbs split an SBS video into _left / _right videos
  mdvt-torch inpaint   inpaint a static overlay region in every frame
  mdvt-torch project   headless project manager (create, status, set,
                       split, run)
  mdvt-torch upscale   upscale a low-res metric depth video with the colour
                       video as guidance (PromptDA)
  mdvt-torch track     track_points_in_video (pyramidal LK or CoTracker3)
  mdvt-torch align     align_3d_points: camera poses from tracks + depth
  mdvt-torch flow      optical_flow (RAFT) -> colour-coded flow video
  mdvt-torch slam      sam_track_video: camera tracking with global bundle
                       adjustment (LK, or the DROID-class front-end)
  mdvt-torch export    convert_depth_format: grayscale, PLY / OBJ,
                       triangulated clouds, rescaled depth, camera track
  mdvt-torch analyse-depth     moving tracks against depth (movement cloud)
  mdvt-torch analyse-tracking  scene cuts from track connectivity
  mdvt-torch gui       the web project GUI (scenes, overrides, runs)

``mdvt-torch bench`` (the JAX package's root ``bench.py``) is not ported;
naming it says so. The tools run on the CUDA device unless
``MDVT_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import sys

# subcommand -> (module, its entry function)
SUBCOMMANDS = {
    "depth": ("metric_depth_video_toolbox_tpu_torch.cli."
              "video_metric_convert", "main"),
    "engine": ("metric_depth_video_toolbox_tpu_torch.cli.depth_engines",
               "main"),
    "da3": ("metric_depth_video_toolbox_tpu_torch.cli.depth_engines",
            "da3_main"),
    "stereo": ("metric_depth_video_toolbox_tpu_torch.cli.stereo_rerender",
               "main"),
    "infill": ("metric_depth_video_toolbox_tpu_torch.cli.infill", "main"),
    "mask": ("metric_depth_video_toolbox_tpu_torch.cli.generate_video_mask",
             "main"),
    "convergence": ("metric_depth_video_toolbox_tpu_torch.cli."
                    "find_convergence_depth", "main"),
    "movie": ("metric_depth_video_toolbox_tpu_torch.cli.movie_2_3d", "main"),
    "download-weights": ("metric_depth_video_toolbox_tpu_torch.cli."
                         "download_weights", "main"),
    "view": ("metric_depth_video_toolbox_tpu_torch.cli.view_depthfile",
             "main"),
    "split-sbs": ("metric_depth_video_toolbox_tpu_torch.cli.split_sbs_video",
                  "main"),
    "inpaint": ("metric_depth_video_toolbox_tpu_torch.cli.apply_inpainting",
                "main"),
    "project": ("metric_depth_video_toolbox_tpu_torch.cli.project", "main"),
    "upscale": ("metric_depth_video_toolbox_tpu_torch.cli.upscale_depth",
                "main"),
    "track": ("metric_depth_video_toolbox_tpu_torch.cli."
              "track_points_in_video", "main"),
    "align": ("metric_depth_video_toolbox_tpu_torch.cli.align_3d_points",
              "main"),
    "flow": ("metric_depth_video_toolbox_tpu_torch.cli.optical_flow",
             "main"),
    "slam": ("metric_depth_video_toolbox_tpu_torch.cli.sam_track_video",
             "main"),
    "export": ("metric_depth_video_toolbox_tpu_torch.cli."
               "convert_depth_format", "main"),
    "analyse-tracking": ("metric_depth_video_toolbox_tpu_torch.cli."
                         "analyse_tracking", "main"),
    "analyse-depth": ("metric_depth_video_toolbox_tpu_torch.cli."
                      "analyse_depth", "main"),
    "gui": ("metric_depth_video_toolbox_tpu_torch.cli.gui", "main"),
}

# the JAX package's other subcommand -> the ROADMAP item that covers it
NOT_PORTED = {"bench": "A9"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="mdvt-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("command", choices=list(SUBCOMMANDS) + list(
        NOT_PORTED))
    # the subcommand alone, so that its flags (--help too) reach its parser
    args = parser.parse_args(argv[:1])
    rest = argv[1:]
    if args.command in NOT_PORTED:
        raise SystemExit(f"mdvt-torch {args.command}: not ported yet "
                         f"(see ROADMAP.md, {NOT_PORTED[args.command]})")
    module, entry = SUBCOMMANDS[args.command]
    getattr(importlib.import_module(module), entry)(rest)


if __name__ == "__main__":
    main()
