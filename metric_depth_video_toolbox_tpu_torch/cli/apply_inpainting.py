"""CLI: remove a static overlay (a logo, burnt-in subtitles) from every
frame before depth estimation (the port of the JAX package's
``cli/apply_inpainting.py``): colour video + overlay mask image ->
inpainted lossless video. The masked region is filled by the diffusion
inpaint of ``ops/image.py``, batches of frames at a time on the device.
"""

from __future__ import annotations

import argparse


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Inpaint a static overlay region in every frame.")
    p.add_argument("--color_video", type=str, required=True)
    p.add_argument("--overlay_mask", type=str, required=True,
                   help="image; non-black pixels are inpainted")
    p.add_argument("--output", type=str)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--iterations", default=96, type=int)
    return p


def run(args, device=None):
    import cv2
    import torch

    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.ops import image as im
    from metric_depth_video_toolbox_tpu_torch.utils.device import \
        resolve_device

    dev = resolve_device(device)
    mask_img = cv2.imread(args.overlay_mask, cv2.IMREAD_GRAYSCALE)
    if mask_img is None:
        raise SystemExit(f"cannot read overlay mask {args.overlay_mask}")
    output = args.output or (args.color_video + "_inpainted.mkv")
    with vio.VideoReader(args.color_video,
                         max_frames=args.max_frames) as reader:
        if mask_img.shape != (reader.height, reader.width):
            mask_img = cv2.resize(mask_img, (reader.width, reader.height),
                                  interpolation=cv2.INTER_NEAREST)
        hole = torch.from_numpy(mask_img > 16).to(dev)
        writer = vio.VideoWriter(output, reader.fps, reader.width,
                                 reader.height)
        n = 0
        while True:
            batch = reader.read_batch(args.batch_size)
            if batch is None:
                break
            frames = torch.from_numpy(batch).to(dev)
            out = im.inpaint_diffusion(frames.to(torch.float32), hole,
                                       iterations=args.iterations)
            out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
            for f in out.cpu().numpy():
                writer.write(f)
            n += batch.shape[0]
    writer.commit(n)
    print(f"inpainted video saved: {output}")
    return output


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
