"""CLI: optical flow video (the port of ``cli/optical_flow.py``, the same
flags and defaults): RAFT (RAFT_LARGE) over streamed frame pairs, each
flow frame colour coded (``models.raft.flow_to_rgb``) ->
``<color_video>_flow.mkv``. Frames are cropped to multiples of 8; a batch
that runs out of device memory is retried in halves. ``--checkpoint``
reads a converted raft checkpoint (``models.convert.convert_raft``);
without one the weights are seeded. Runs on the CUDA device unless
``--cpu`` or ``MDVT_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Dense optical flow video (RAFT-class).")
    p.add_argument("--color_video", type=str, required=True)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--batch_size", "--batch", dest="batch_size",
                   default=4, type=int,
                   help="pairs per forward pass (streamed)")
    p.add_argument("--last_mode", choices=["prev", "self", "none"],
                   default="prev",
                   help="how to emit a flow frame for the final input "
                        "frame: duplicate the previous flow, compute "
                        "flow(last,last), or write one fewer frame")
    p.add_argument("--cpu", action="store_true", help="force CPU")
    p.add_argument("--amp", action="store_true",
                   help="accepted for reference-flag parity; RAFT_LARGE "
                        "already computes in bfloat16")
    p.add_argument("--channels_last", action="store_true",
                   help="accepted for parity")
    p.add_argument("--checkpoint", type=str)
    return p


def flow_model(checkpoint=None, device=None):
    """RAFT_LARGE on ``device``, its weights from a converted checkpoint
    file or seeded."""
    import torch

    from metric_depth_video_toolbox_tpu_torch.models import convert
    from metric_depth_video_toolbox_tpu_torch.models import from_jax
    from metric_depth_video_toolbox_tpu_torch.models import raft

    model = raft.RAFT(raft.RAFT_LARGE)
    if checkpoint:
        from_jax.load_params(model, convert.load_checkpoint(checkpoint))
    else:
        from_jax.flax_like_init(model, torch.Generator().manual_seed(0))
    return model.to(device).eval()


def run(args, device=None):
    import torch

    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import raft
    from metric_depth_video_toolbox_tpu_torch.utils.device import \
        resolve_device

    device = resolve_device("cpu" if args.cpu else device)
    model = flow_model(args.checkpoint, device)

    @torch.no_grad()
    def step(a, b):
        return raft.flow_to_rgb(model(a, b)).cpu().numpy()

    out_path = args.color_video + "_flow.mkv"
    with vio.VideoReader(args.color_video,
                         max_frames=args.max_frames) as reader, \
            vio.VideoWriter(out_path, reader.fps, reader.width,
                            reader.height) as writer:
        h8 = (reader.height // 8) * 8
        w8 = (reader.width // 8) * 8
        batch_a, batch_b = [], []
        last_rgb = None  # the last flow frame written (for last_mode prev)

        def flush():
            nonlocal last_rgb
            if not batch_a:
                return
            a_all = torch.from_numpy(np.stack(batch_a)[:, :h8, :w8]).to(
                device)
            b_all = torch.from_numpy(np.stack(batch_b)[:, :h8, :w8]).to(
                device)
            start = 0
            chunk = a_all.shape[0]
            while start < a_all.shape[0]:
                try:
                    rgb = step(a_all[start:start + chunk],
                               b_all[start:start + chunk])
                except torch.cuda.OutOfMemoryError:
                    if chunk == 1:
                        raise
                    chunk = max(1, chunk // 2)
                    torch.cuda.empty_cache()
                    print(f"OOM: halving flow batch to {chunk}")
                    continue
                for f in rgb:
                    writer.write(f)
                    last_rgb = f
                start += chunk
            batch_a.clear()
            batch_b.clear()

        prev = None
        for frame in reader:
            if prev is not None:
                batch_a.append(prev)
                batch_b.append(frame)
                if len(batch_a) == args.batch_size:
                    flush()
            prev = frame
        # one flow frame for the final input frame
        if args.last_mode == "self" and prev is not None:
            batch_a.append(prev)
            batch_b.append(prev)
        flush()
        if args.last_mode == "prev" and last_rgb is not None:
            writer.write(last_rgb)
    print(f"flow video saved: {out_path}")
    return out_path


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
