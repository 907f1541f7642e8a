"""``mdvt-torch`` -- the port's entry point, multiplexing its tools.

  mdvt-torch depth     video_metric_convert (VDA engine)
  mdvt-torch stereo    stereo_rerender (disparity-sweep path)
  mdvt-torch infill    SBS infill (--infill_engine inspatio_world)

The JAX package's other subcommands are not ported yet; naming one says
so. The tools run on the CUDA device unless ``MDVT_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse
import importlib
import sys

SUBCOMMANDS = {
    "depth": "metric_depth_video_toolbox_tpu_torch.cli.video_metric_convert",
    "stereo": "metric_depth_video_toolbox_tpu_torch.cli.stereo_rerender",
    "infill": "metric_depth_video_toolbox_tpu_torch.cli.infill",
}

NOT_PORTED = ("mask", "convergence", "track", "align", "export", "movie",
              "view", "split-sbs", "analyse-tracking", "analyse-depth",
              "flow", "slam", "upscale", "project", "inpaint", "engine",
              "gui", "download-weights", "bench")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="mdvt-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("command", choices=list(SUBCOMMANDS) + list(
        NOT_PORTED))
    args, rest = parser.parse_known_args(argv)
    if args.command in NOT_PORTED:
        raise SystemExit(f"mdvt-torch {args.command}: not ported yet "
                         "(see ROADMAP.md, queue A)")
    importlib.import_module(SUBCOMMANDS[args.command]).main(rest)


if __name__ == "__main__":
    main()
