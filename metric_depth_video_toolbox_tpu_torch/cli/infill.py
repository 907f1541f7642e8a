"""CLI: disocclusion infill over SBS renders.

The same flags and defaults as the JAX package's ``cli/infill.py``. The
port runs ``--infill_engine basic`` (the normal-march infill, the
default) and ``inspatio_world`` (the Wan-class causal DiT); the other
engines, and for inspatio_world ``--model_scale svd``, ``--checkpoint``
and ``--apply_edge_blending``, raise, naming what they wait for.
"""

from __future__ import annotations

import argparse
import dataclasses


def build_parser(parser=None):
    p = parser or argparse.ArgumentParser(
        description="Fill disocclusion holes in a rendered SBS video.")
    p.add_argument("--sbs_color_video", type=str, required=True,
                   help="SBS video or .txt list")
    p.add_argument("--sbs_mask_video", type=str,
                   help="infill mask video (default: "
                        "<sbs>_infillmask.mkv)")
    p.add_argument("--color_video", type=str,
                   help="original mono video (extra conditioning for "
                        "diffusion engines)")
    p.add_argument("--infill_engine", type=str, default="basic",
                   choices=["basic", "diffusion", "stereocrafter",
                            "m2svid", "inspatio_world", "external"],
                   help="'diffusion' = stereocrafter preset; named "
                        "presets set the reference engines' chunking/"
                        "working shapes; 'external' runs "
                        "--external_command")
    p.add_argument("--external_command", type=str, nargs="+",
                   help="external infill engine command (the "
                        "stereo_dissoclusion_net hook)")
    p.add_argument("--model_scale",
                   choices=["tiny", "production", "svd"],
                   default="production",
                   help="model scale: for inspatio_world 'production' = "
                        "Wan 1.3B, 'tiny' = smoke model; 'svd' = the "
                        "weight-exact StereoCrafter/SVD graph (not ported "
                        "yet)")
    p.add_argument("--checkpoint", type=str,
                   help="converted denoiser checkpoint")
    p.add_argument("--clip_checkpoint", type=str,
                   help="converted CLIP vision tower for SVD "
                        "cross-attention conditioning")
    p.add_argument("--max_frames", default=-1, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--num_inference_steps", type=int,
                   help="denoise steps for the diffusion engines (more "
                        "looks better but is slower)")
    p.add_argument("--apply_edge_blending", action="store_true",
                   help="blend the downward-facing side of disocclusion "
                        "edges to reduce halos (not ported yet)")
    return p


def _check_ported(args):
    if args.infill_engine == "basic":
        return
    if args.infill_engine != "inspatio_world":
        raise NotImplementedError(
            f"not ported yet: --infill_engine {args.infill_engine} "
            f"(ROADMAP A11: SVD-class diffusion infill and the external "
            f"hook)")
    if args.model_scale == "svd" or args.clip_checkpoint:
        raise NotImplementedError("not ported yet: --model_scale svd / "
                                  "--clip_checkpoint (ROADMAP A11)")
    if args.apply_edge_blending:
        raise NotImplementedError("not ported yet: --apply_edge_blending "
                                  "(ROADMAP A11: mark_lower_side and the "
                                  "halo blend)")
    if args.checkpoint:
        raise NotImplementedError("--checkpoint waits for a converted "
                                  "checkpoint in the repository "
                                  "(convert.convert_wan)")


def make_inspatio_engine(model_scale="production", num_inference_steps=None,
                         device=None, **overrides):
    """-> (engine, chunk-loop kwargs) of the inspatio_world preset at a model
    scale ('production' = Wan 1.3B, 'tiny')."""
    from metric_depth_video_toolbox_tpu_torch.models import wan as wan_mod
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion

    cfg = wan_mod.WAN_TINY if model_scale == "tiny" else wan_mod.WAN_1_3B
    if num_inference_steps:
        n = num_inference_steps
        cfg = dataclasses.replace(cfg, denoise_steps=tuple(
            1.0 - i / n for i in range(n)))
    return infill_diffusion.make_engine("inspatio_world", cfg=cfg,
                                        device=device, **overrides)


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion
    from metric_depth_video_toolbox_tpu_torch.pipeline import infill_video

    _check_ported(args)
    if args.infill_engine == "basic":
        def infill(v, mask):
            return infill_video.infill_sbs_video(
                v, mask, max_frames=args.max_frames,
                batch_size=args.batch_size, device=device)
    else:
        eng, drv = make_inspatio_engine(args.model_scale,
                                        args.num_inference_steps, device)
        drv_kw = {k: w for k, w in drv.items()
                  if k in ("mirror_left", "drift_correct",
                           "apply_edge_blending")}

        def infill(v, mask):
            return infill_diffusion.infill_sbs_video_diffusion(
                v, mask, engine=eng, color_video=args.color_video,
                max_frames=args.max_frames, **drv_kw)
    clips = dstage.expand_batch(args.sbs_color_video)
    outs = []
    for v in clips:
        mask = args.sbs_mask_video or (v + "_infillmask.mkv")
        try:
            out = infill(v, mask)
            outs.append(out)
            print(f"infilled video saved: {out}")
        except Exception as e:  # noqa: BLE001 - batch mode keeps going
            if len(clips) == 1:
                raise
            print(f"infill FAILED for {v}: {e}; continuing")
    return outs


def main(argv=None):
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
