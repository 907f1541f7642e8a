"""CLI: upscale a low-resolution metric depth video with the full-resolution
colour video as guidance (PromptDA-class; the port of ``cli/upscale_depth.py``,
the same flags and defaults).

The colour frames are resized to the largest multiples of 14 within their
size, PromptDA (``models.promptda``, ViT-L) takes them with the depth video's
frames as its prompt, in batches of ``--batch_size``, and the result, resized
back to the colour video's size, is written to
``<depth_video>_upscaled.mkv``. ``--checkpoint`` reads a converted
``promptda_hf`` checkpoint (``models.convert.convert_promptda_hf``, its
position embedding at the working grid); without one the weights are seeded.
Runs on the CUDA device unless ``MDVT_PLATFORM=cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Prompt-guided metric depth upscaling.")
    p.add_argument("--color_video", type=str, required=True)
    p.add_argument("--depth_video", type=str, required=True,
                   help="low-res metric depth video (the prompt)")
    p.add_argument("--max_depth", default=100, type=float)
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--checkpoint", type=str)
    return p


def run(args, device=None, rng_seed=0):
    import torch

    from metric_depth_video_toolbox_tpu_torch.io import video as vio
    from metric_depth_video_toolbox_tpu_torch.models import from_jax
    from metric_depth_video_toolbox_tpu_torch.models import promptda
    from metric_depth_video_toolbox_tpu_torch.models import vit as vit_mod
    from metric_depth_video_toolbox_tpu_torch.ops import image as im
    from metric_depth_video_toolbox_tpu_torch.utils.device import \
        resolve_device

    dev = resolve_device(device)
    out_path = args.depth_video + "_upscaled.mkv"
    frames_out = []
    with vio.VideoReader(args.color_video, max_frames=args.max_frames) as cv, \
            vio.DepthVideoReader(args.depth_video, args.max_depth) as dv:
        h14, w14 = (cv.height // 14) * 14, (cv.width // 14) * 14
        # the output follows each prompt's own metric range: no max_depth
        # in the configuration
        cfg = promptda.PromptDAConfig()
        model = promptda.PromptDA(cfg, (h14, w14))
        if args.checkpoint:
            from metric_depth_video_toolbox_tpu_torch.models import convert
            from_jax.load_params(model, convert.load_checkpoint(
                args.checkpoint), ignore_unused=True)
        else:
            vit_mod.seeded_init(model, torch.Generator().manual_seed(
                rng_seed), cfg.vit.layerscale_init)
        model = model.to(dev).eval()
        with torch.no_grad():
            while True:
                imgs = cv.read_batch(args.batch_size)
                if imgs is None:
                    break
                prompts = dv.read_depth_batch(imgs.shape[0])
                if prompts is None:
                    break
                x = im.resize(torch.from_numpy(imgs).to(dev).to(
                    torch.float32) / 255.0, (h14, w14))
                d = model(x, torch.from_numpy(prompts).to(dev))
                d = im.resize_nchw(d[:, None], (cv.height, cv.width))[:, 0]
                frames_out.append(d.cpu().numpy())
        fps = cv.fps
    vio.save_depth_video(np.concatenate(frames_out), out_path, fps,
                         args.max_depth)
    print(f"upscaled depth saved: {out_path}")
    return out_path


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
