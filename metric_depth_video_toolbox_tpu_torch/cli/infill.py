"""CLI: disocclusion infill over SBS renders.

The same flags and defaults as the JAX package's ``cli/infill.py``: the
``basic`` normal-march infill (the default), the SVD-class engines
(``diffusion`` = the stereocrafter preset, ``stereocrafter``, ``m2svid``)
at ``--model_scale`` tiny, production (``DIFFUSION_SVD``) or svd (the
weight-exact StereoCrafter graph), ``inspatio_world`` (the Wan-class causal
DiT) and ``external`` (``--external_command``). ``--checkpoint`` and
``--clip_checkpoint`` raise: reading a converted checkpoint is ROADMAP A5.
"""

from __future__ import annotations

import argparse
import dataclasses

_A5 = ("reading a converted checkpoint is not ported yet (ROADMAP A5: the "
       "checkpoint converters)")


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
                   help="diffusion UNet scale: 'production' = SVD-class "
                        "widths (320/640/1280/1280, 5 steps) at the "
                        "reference working points; 'svd' = the "
                        "weight-exact StereoCrafter/SVD graph (models."
                        "svd); 'tiny' = smoke model; for inspatio_world "
                        "'tiny' = WAN_TINY, else Wan 1.3B")
    p.add_argument("--checkpoint", type=str,
                   help="converted denoiser checkpoint (not ported yet: "
                        "ROADMAP A5)")
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
                        "edges to reduce halos (always on for the "
                        "stereocrafter engine; opt-in for m2svid/"
                        "inspatio_world)")
    return p


def _check_ported(args):
    if args.checkpoint or args.clip_checkpoint:
        raise NotImplementedError(f"--checkpoint / --clip_checkpoint: {_A5}")


def make_inspatio_engine(model_scale="production", num_inference_steps=None,
                         device=None, **overrides):
    """-> (engine, chunk-loop kwargs) of the inspatio_world preset at a model
    scale ('tiny' = WAN_TINY; 'production' and 'svd' = Wan 1.3B, as in the
    JAX CLI)."""
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


def diffusion_config(model_scale="production", num_inference_steps=None):
    """The SVD-class engines' denoiser config at a model scale: 'tiny' =
    DIFFUSION_TINY, 'production' = DIFFUSION_SVD, 'svd' = SVDConfig() (the
    engine then builds SVDVAEConfig())."""
    from metric_depth_video_toolbox_tpu_torch.models import diffusion as dif

    if model_scale == "svd":
        from metric_depth_video_toolbox_tpu_torch.models import svd as svdm
        cfg = svdm.SVDConfig()
    elif model_scale == "production":
        cfg = dif.DIFFUSION_SVD
    else:
        cfg = dif.DIFFUSION_TINY
    if num_inference_steps:
        cfg = dataclasses.replace(cfg, num_steps=num_inference_steps)
    return cfg


def run(args, device=None):
    from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion
    from metric_depth_video_toolbox_tpu_torch.pipeline import infill_video

    _check_ported(args)
    shared = []   # the model is built once per batch of clips

    def infill(v, mask):
        engine = args.infill_engine
        if engine == "external":
            if not args.external_command:
                raise SystemExit("--external_command required with "
                                 "--infill_engine external")
            return infill_diffusion.infill_sbs_video_external(
                v, mask, args.external_command, color_video=args.color_video)
        if engine == "basic":
            return infill_video.infill_sbs_video(
                v, mask, color_video=args.color_video,
                max_frames=args.max_frames, batch_size=args.batch_size,
                device=device)
        if not shared:
            if engine == "inspatio_world":
                shared.append(make_inspatio_engine(
                    args.model_scale, args.num_inference_steps, device))
            else:
                shared.append(infill_diffusion.make_engine(
                    "stereocrafter" if engine == "diffusion" else engine,
                    cfg=diffusion_config(args.model_scale,
                                         args.num_inference_steps),
                    device=device))
        eng, drv = shared[0]
        drv_kw = {k: w for k, w in drv.items()
                  if k in ("mirror_left", "drift_correct",
                           "apply_edge_blending")}
        if args.apply_edge_blending:
            drv_kw["apply_edge_blending"] = True
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
