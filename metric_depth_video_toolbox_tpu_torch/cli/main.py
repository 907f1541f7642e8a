"""``mdvt-torch`` -- the port's entry point, multiplexing its tools.

  mdvt-torch movie     movie_2_3d: scenes -> depth -> masks -> convergence
                       -> stereo -> infill -> <movie>_SBS.mkv
  mdvt-torch depth     video_metric_convert (VDA engine)
  mdvt-torch engine    per-engine depth CLIs (engine da3; the others are
                       not ported yet)
  mdvt-torch da3       DA3 multi-view depth + poses + xfovs (= engine da3)
  mdvt-torch stereo    stereo_rerender (SBS, Touchly, VR180, background)
  mdvt-torch mask      generate_video_mask (U²-Net subject masks)
  mdvt-torch convergence  find_convergence_depth
  mdvt-torch infill    SBS infill (every --infill_engine of the JAX CLI)
  mdvt-torch download-weights  fetch published checkpoints, --convert them
  mdvt-torch view      view_depthfile --render (novel-view render to video;
                       the interactive viewer is not ported yet)

The JAX package's other subcommands are not ported yet; naming one says
so. The tools run on the CUDA device unless ``MDVT_PLATFORM=cpu``.
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
}

NOT_PORTED = ("track", "align", "export", "split-sbs",
              "analyse-tracking", "analyse-depth", "flow", "slam", "upscale",
              "project", "inpaint", "gui", "bench")


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
                         "(see ROADMAP.md, queue A)")
    module, entry = SUBCOMMANDS[args.command]
    getattr(importlib.import_module(module), entry)(rest)


if __name__ == "__main__":
    main()
