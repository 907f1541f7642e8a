"""CLI: fetch and convert published checkpoints (``mdvt-torch
download-weights``), with the flags of the JAX package's
``cli/download_weights.py``.

``--model`` names a family of ``models.convert.WEIGHT_REGISTRY``. Files
already in ``--dest_dir`` are used as they are; missing ones are fetched
from their URLs or Hugging Face repositories where the network allows, and
otherwise the command raises ``FileNotFoundError`` naming them and their
sources. ``--dry_run`` prints the plan and fetches nothing. ``--convert``
runs the family's converter on each file and writes ``<file>.mdvt.msgpack``
in Flax's format (``io.checkpoint``), which ``--checkpoint`` of the depth
and infill commands reads, as does the JAX package.
"""

from __future__ import annotations

import argparse

from metric_depth_video_toolbox_tpu_torch.models import convert


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True,
                   choices=sorted(convert.WEIGHT_REGISTRY),
                   help="model family (the registry of models.convert)")
    p.add_argument("--dest_dir", default="weights")
    p.add_argument("--dry_run", action="store_true",
                   help="print the download plan and exit")
    p.add_argument("--convert", action="store_true",
                   help="run the checkpoint converter on the downloaded "
                        "file(s) and save the converted params next to "
                        "them")
    return p


def run(args):
    paths = convert.download_weights(args.model, args.dest_dir,
                                     dry_run=args.dry_run)
    if args.dry_run:
        return paths
    for p in paths:
        print(f"ready: {p}")
    if args.convert:
        kind = convert.WEIGHT_REGISTRY[args.model]["kind"]
        for p in paths:
            out = p + ".mdvt.msgpack"
            convert.save_checkpoint(out, convert.convert_torch_file(p, kind))
            print(f"converted: {out}")
    return paths


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
