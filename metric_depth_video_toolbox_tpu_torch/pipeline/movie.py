"""Movie orchestrator: full 2D movie -> SBS 3D (PyTorch port of
``pipeline/movie.py``).

Seven steps with the JAX package's file contract and resume by existence
(a step skips every scene whose output is there already):

  1. split the source into per-scene lossless clips
  2. estimate depth per scene (one engine instance per engine type)
  3. generate subject masks
  4. find convergence depths
  5. render SBS stereo per scene (movie configuration, infill mask on)
  6. fill the disocclusions (basic normal-march infill, or the diffusion
     engine: the JAX package's default ``DiffusionInfillEngine``,
     ``DIFFUSION_TINY`` at 256 x 256)
  7. concatenate into ``<movie>_SBS.mkv`` and tag StereoMode

Per-scene ``Engine``, ``Infill`` and ``Convergence`` overrides come from
extra columns of the scene CSV. Depth engines: ``vda``, ``da3``, the
single-frame engines (``unidepth``, ``unik3d``, ``moge``, ``depthpro``,
``single_frame``; two passes per scene, the second locked to the first's
median FOV), ``depthcrafter`` (made metric against a single-frame pass
written to ``<scene>_ref_depth.mkv`` first) and ``geometrycrafter`` (on a
MoGe prior); ``mvsa`` needs a camera track, so the single-frame engine runs
in its place, with the JAX package's message, and an unknown name falls
back with its warning. ``parallel`` > 1 (scene renders on worker threads)
raises naming A16.

Every device step runs on ``device`` (CUDA unless the caller asks for the
CPU). ``STEP_SECONDS`` holds the wall time of each step of the last run.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time

import numpy as np

from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.io import video as vio
from metric_depth_video_toolbox_tpu_torch.pipeline import \
    convergence as conv_stage
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as depth_stage
from metric_depth_video_toolbox_tpu_torch.pipeline import masks as mask_stage
from metric_depth_video_toolbox_tpu_torch.pipeline import scenes as scene_mod
from metric_depth_video_toolbox_tpu_torch.pipeline import \
    stereo as stereo_stage

# the JAX package's depth engines (its pipeline/depth.py ENGINES) and the
# override names that map onto its single-frame engine
REFERENCE_ENGINES = ("vda", "single_frame", "da3", "geometrycrafter",
                     "depthcrafter", "mvsa")
_SINGLE_FRAME_NAMES = ("unidepth", "unik3d", "moge", "depthpro",
                       "single_frame")

STEP_SECONDS = {}


def plan_scene_files(scenes, output_dir, end_scene=-1):
    """Attach per-scene paths and the 'finished' flag (an SBS output of
    the scene exists)."""
    out = []
    for scene in scenes:
        num = str(scene["Scene Number"])
        base = os.path.join(output_dir, f"scene_{num}.mkv")
        scene["scene_video_file"] = base
        scene["depth_video_file"] = base + "_depth.mkv"
        scene["mask_video_file"] = base + "_mask.mkv"
        scene["xfovs_file"] = scene["depth_video_file"] + "_xfovs.json"
        scene["convergence_file"] = (scene["depth_video_file"]
                                     + "_convergence_depths.json")
        scene["sbs"] = scene["depth_video_file"] + "_stereo.mkv"
        scene["sbs_infill"] = scene["sbs"] + "_infillmask.mkv"
        scene["infilled"] = scene["sbs"] + "_infilled.mkv"
        scene["infill"] = not scene.get("Infill", "") == "No"
        scene["convergence"] = not scene.get("Convergence", "") == "No"
        scene["finished"] = (os.path.exists(scene["sbs"])
                             or os.path.exists(scene["infilled"]))
        out.append(scene)
        if end_scene != -1 and int(num) == end_scene:
            break
    return out


def step1_create_scene_videos(color_video, scenes):
    todo = [s for s in scenes if not s["finished"]
            and not os.path.exists(s["scene_video_file"])]
    if not todo:
        return
    with vio.VideoReader(color_video) as reader:
        it = iter(reader)
        for scene in scenes:
            need = (not scene["finished"]
                    and not os.path.exists(scene["scene_video_file"]))
            writer = (vio.VideoWriter(scene["scene_video_file"], reader.fps,
                                      reader.width, reader.height)
                      if need else None)
            for _ in range(int(scene["Length (frames)"])):
                frame = next(it, None)
                if frame is None:
                    break
                if writer is not None:
                    writer.write(frame)
            if writer is not None:
                writer.commit()


def _depth_engine(scene, engine):
    """(engine, variant) of a scene (its CSV override, else ``engine``), as
    the JAX package resolves the name: the single-frame names map onto
    ``single_frame`` with their variant, and ``mvsa``, which needs a camera
    track the movie has not, onto ``single_frame``."""
    eng = scene.get("Engine", "") or engine
    if eng == "mvsa":
        print(f"scene {scene['Scene Number']}: mvsa needs "
              "--transformation_file; using single_frame instead")
        return "single_frame", "da"
    if eng == "videoanythingmetric":
        return "vda", "da"
    if eng in _SINGLE_FRAME_NAMES:
        return "single_frame", eng if eng != "single_frame" else "da"
    if eng in depth_stage.ENGINES:
        return eng, "da"
    known = sorted(set(REFERENCE_ENGINES) | set(_SINGLE_FRAME_NAMES))
    print(f"WARNING: scene {scene['Scene Number']}: unknown Engine "
          f"override '{eng}' (known: {', '.join(known)}); falling back to "
          f"'{engine}'")
    return (engine if engine in depth_stage.ENGINES else "vda"), "da"


def _two_pass_single_frame(videos, variant, max_depth, engine_kwargs):
    """The single-frame engines run twice per scene: a FOV pass (the
    ``unik3d`` variant), then the scene's variant locked to the median of
    its per-frame FOVs, with the ``_xfovs.json`` sidecar. The second
    engine shares the first's weights where names and shapes agree."""
    from metric_depth_video_toolbox_tpu_torch.models import \
        depth_anything as da

    kw = dict(engine_kwargs or {})
    kw.pop("xfov", None)
    for v in videos:
        out = v + "_depth.mkv"
        if vio.is_valid_video(out):
            continue
        frames, _fps = vio.read_video_frames(v)
        est = depth_stage.SingleFrameEngine(max_depth=max_depth,
                                            variant="unik3d", **kw)
        _, fovs = est.infer_video(frames, return_fov=True)
        xfov = float(np.median(fovs)) if fovs is not None else 60.0
        print(f"{v}: two-pass FOV lock at xfov={xfov:.1f} deg")
        eng = depth_stage.SingleFrameEngine(
            max_depth=max_depth, variant="unik3d" if variant == "da"
            else variant, xfov=xfov, **kw)
        eng.share_weights(est, da.working_resolution(
            frames.shape[1], frames.shape[2], eng.input_size,
            eng.cfg.vit.patch_size))
        del est
        depth_stage.run_single_frame(v, max_depth=max_depth, engine=eng,
                                     xfov=xfov, save_xfovs=True)
        print(f"depth video saved: {out}")


def step2_estimate_depth(scenes, engine="vda", max_depth=100.0,
                         engine_kwargs=None, device=None):
    """Depth for every scene without a depth video; one engine instance
    per engine type for the whole movie, two per scene for the
    single-frame engines (:func:`_two_pass_single_frame`); depthcrafter
    first writes a single-frame reference pass per scene."""
    by_engine = {}
    for scene in scenes:
        if scene["finished"] or vio.is_valid_video(scene["depth_video_file"]):
            continue
        by_engine.setdefault(_depth_engine(scene, engine), []).append(
            scene["scene_video_file"])
    kw = dict(engine_kwargs or {})
    kw.setdefault("device", device)
    for (eng, variant), videos in by_engine.items():
        if eng == "depthcrafter":
            # made metric against a reference: a single-frame metric pass
            # per scene first
            for v in videos:
                ref = v + "_ref_depth.mkv"
                if not vio.is_valid_video(ref):
                    tmp = depth_stage.run_batch("single_frame", v,
                                                max_depth=max_depth, **kw)[0]
                    os.replace(tmp, ref)
                depth_stage.run_batch(eng, v, max_depth=max_depth,
                                      reference_depth_video=ref, **kw)
            continue
        if eng == "single_frame":
            _two_pass_single_frame(videos, variant, max_depth, kw)
            continue
        depth_stage.run_batch(eng, videos, max_depth=max_depth, **kw)


def step3_generate_masks(scenes, mask_engine=None, device=None):
    eng = mask_engine
    for scene in scenes:
        if scene["finished"] or os.path.exists(scene["mask_video_file"]):
            continue
        if eng is None:
            eng = mask_stage.MaskEngine(device=device)
        mask_stage.generate_video_mask(scene["scene_video_file"],
                                       output=scene["mask_video_file"],
                                       engine=eng)


def step4_find_convergence(scenes, max_depth=100.0, device=None):
    for scene in scenes:
        if (scene["finished"] or not scene["convergence"]
                or os.path.exists(scene["convergence_file"])
                or not os.path.exists(scene["depth_video_file"])):
            continue
        mask = (scene["mask_video_file"]
                if os.path.exists(scene["mask_video_file"]) else None)
        conv_stage.find_convergence_depths(
            scene["depth_video_file"], mask_video=mask, max_depth=max_depth,
            output=scene["convergence_file"], device=device)


def _check_parallel(parallel):
    if parallel and parallel > 1:
        raise NotImplementedError("not ported yet: --parallel > 1, scene "
                                  "renders on worker threads (ROADMAP A16)")


def step5_render_sbs(scenes, xfov=None, max_depth=100.0, infill_mask=True,
                     batch_size=8, parallel=0, device=None, **stereo_kwargs):
    """Render each scene's SBS output (and its infill mask)."""
    _check_parallel(parallel)
    for scene in scenes:
        if scene["finished"] or os.path.exists(scene["sbs"]):
            continue
        conv = None
        if scene["convergence"] and os.path.exists(scene["convergence_file"]):
            conv = sidecar.load_convergence_depths(scene["convergence_file"])
        xfovs = None
        if os.path.exists(scene["xfovs_file"]):
            xfovs = sidecar.load_xfovs(scene["xfovs_file"])
        stereo_stage.render_stereo_video(
            scene["depth_video_file"], color_video=scene["scene_video_file"],
            output=scene["sbs"], xfov=xfov if xfovs is None else None,
            xfovs=xfovs, convergence_depths=conv, max_depth=max_depth,
            infill_mask=infill_mask and scene["infill"],
            batch_size=batch_size, device=device, **stereo_kwargs)


def step6_infill(scenes, infill_engine="basic", device=None):
    """Per-scene infill: 'none' skips, 'basic' is the normal-march
    infill, 'diffusion' the default SVD-class engine (a fresh one per
    scene, as in the JAX package)."""
    if infill_engine == "none":
        return
    from metric_depth_video_toolbox_tpu_torch.pipeline import infill_video
    for scene in scenes:
        if (not scene["infill"] or os.path.exists(scene["infilled"])
                or not os.path.exists(scene["sbs"])
                or not os.path.exists(scene["sbs_infill"])):
            continue
        infill_video.infill_sbs_video(
            scene["sbs"], scene["sbs_infill"], output=scene["infilled"],
            engine=infill_engine, color_video=scene["scene_video_file"],
            device=device)


def _scene_output(scene):
    return (scene["infilled"] if os.path.exists(scene["infilled"])
            else scene["sbs"])


def validate_video_lengths(scenes):
    """[(scene number, what is wrong)] for every scene output that is
    missing or whose frame count is not the CSV's length."""
    bad = []
    for scene in scenes:
        target = _scene_output(scene)
        if not os.path.exists(target):
            bad.append((scene["Scene Number"], "missing"))
            continue
        n, _, _, _ = vio.video_info(target)
        if n != int(scene["Length (frames)"]):
            bad.append((scene["Scene Number"], f"{n} != "
                        f"{scene['Length (frames)']}"))
    return bad


def _finished_movie(output, scenes):
    """The final movie of an earlier run: newer than every scene output
    (a scene redone since is concatenated again), every scene's frames,
    and the StereoMode tag on a Matroska file."""
    from metric_depth_video_toolbox_tpu_torch.io import mkv as mkv_mod

    if not vio.is_valid_video(output):
        return False
    targets = [_scene_output(s) for s in scenes
               if os.path.exists(_scene_output(s))]
    made = os.stat(output).st_mtime_ns
    if any(os.stat(t).st_mtime_ns > made for t in targets):
        return False
    total = sum(int(s["Length (frames)"]) for s in scenes
                if os.path.exists(_scene_output(s)))
    if vio.video_info(output)[0] != total:
        return False
    return (not output.endswith(".mkv") or mkv_mod.get_stereo_mode(output)
            == mkv_mod.STEREO_SBS_LEFT_FIRST)


def step7_concat(scenes, color_video, output=None, compressed=False):
    """Concatenate the scene outputs into the final SBS movie (lossless
    FFV1, or mp4 when ``compressed``), mux the source's audio (through
    ffmpeg where there is one, else natively for a Matroska source) and
    tag StereoMode on a Matroska output. A complete movie of an earlier
    run is kept as it is."""
    from metric_depth_video_toolbox_tpu_torch.io import mkv as mkv_mod

    first = next((_scene_output(s) for s in scenes
                  if os.path.exists(_scene_output(s))), None)
    if first is None:
        raise RuntimeError("no rendered scenes to concatenate")
    output = output or (os.path.splitext(color_video)[0]
                        + ("_SBS.mp4" if compressed else "_SBS.mkv"))
    if _finished_movie(output, scenes):
        print(f"{output} exists with every scene's frames; kept")
        return output
    _, w, h, fps = vio.video_info(first)
    writer = vio.VideoWriter(output, fps, w, h,
                             codec_fourcc="avc1" if compressed else "FFV1")
    total = 0
    for scene in scenes:
        target = _scene_output(scene)
        if not os.path.exists(target):
            continue
        with vio.VideoReader(target) as r:
            for frame in r:
                writer.write(frame)
                total += 1
    writer.commit(total)

    if shutil.which("ffmpeg"):
        # mux the source's audio and tag the stream; an AAC re-encode when
        # the stream copy fails
        muxed = output + ".audio.mkv"
        base = ["ffmpeg", "-y", "-i", output, "-i", color_video,
                "-map", "0:v", "-map", "1:a?",
                "-metadata:s:v", "stereo_mode=left_right"]
        r = subprocess.run(base + ["-c", "copy", muxed], capture_output=True)
        if not (r.returncode == 0 and os.path.exists(muxed)
                and os.path.getsize(muxed) > 0):
            r = subprocess.run(base + ["-c:v", "copy", "-c:a", "aac", muxed],
                               capture_output=True)
        if (r.returncode == 0 and os.path.exists(muxed)
                and os.path.getsize(muxed) > 0):
            os.replace(muxed, output)
    elif output.endswith(".mkv"):
        # native audio passthrough (a remux of the source's audio blocks);
        # Matroska sources only
        try:
            if mkv_mod.has_audio_track(color_video):
                mkv_mod.mux_audio(output, color_video)
                print(f"muxed source audio into {output} (native remux)")
            else:
                print("source has no (Matroska) audio track — final "
                      "movie is silent")
        except Exception as e:  # noqa: BLE001 - the movie stays, silent
            print(f"WARNING: native audio mux failed ({e}) — the final "
                  "movie has NO AUDIO. Mux manually: ffmpeg -i "
                  f"{output} -i {color_video} -map 0:v -map 1:a? "
                  "-c copy out.mkv")
    if output.endswith(".mkv"):
        # the Matroska StereoMode element on the video track, which players
        # read to switch to side-by-side
        try:
            mkv_mod.set_stereo_mode(output, mkv_mod.STEREO_SBS_LEFT_FIRST)
        except Exception as e:  # noqa: BLE001 - the tag is metadata
            print(f"WARNING: could not tag StereoMode on {output}: {e}")
    return output


def movie_to_3d(color_video, output_dir=None, engine="vda",
                infill_engine="basic", xfov=None, max_depth=100.0,
                max_scene_frames=1500, scene_file=None, end_scene=-1,
                batch_size=16, engine_kwargs=None, stereo_kwargs=None,
                mask_engine=None, generate_masks=True, csv_delimiter=",",
                no_render=False, parallel=0, device=None):
    """The full pipeline; returns the final movie's path (None with
    ``no_render``). Resumable: a second run redoes nothing that exists."""
    _check_parallel(parallel)
    STEP_SECONDS.clear()
    clock = [time.perf_counter()]

    def done(step):
        now = time.perf_counter()
        STEP_SECONDS[step] = now - clock[0]
        clock[0] = now

    output_dir = output_dir or (os.path.splitext(color_video)[0] + "_3d")
    os.makedirs(output_dir, exist_ok=True)
    scene_file = scene_mod.ensure_scene_file(color_video, output_dir,
                                             scene_file)
    scenes = scene_mod.split_scenes(
        scene_mod.read_scene_csv(scene_file, delimiter=csv_delimiter),
        max_scene_frames=max_scene_frames)
    scenes = plan_scene_files(scenes, output_dir, end_scene)
    step1_create_scene_videos(color_video, scenes)
    done("1 scenes")
    step2_estimate_depth(scenes, engine=engine, max_depth=max_depth,
                         engine_kwargs=engine_kwargs, device=device)
    done("2 depth")
    if generate_masks:
        step3_generate_masks(scenes, mask_engine=mask_engine, device=device)
    done("3 masks")
    step4_find_convergence(scenes, max_depth=max_depth, device=device)
    done("4 convergence")
    if no_render:
        return None
    step5_render_sbs(scenes, xfov=xfov, max_depth=max_depth,
                     batch_size=batch_size, device=device,
                     **(stereo_kwargs or {}))
    done("5 stereo")
    step6_infill(scenes, infill_engine=infill_engine, device=device)
    done("6 infill")
    bad = validate_video_lengths(scenes)
    if bad:
        raise RuntimeError(f"scene length validation failed: {bad}")
    out = step7_concat(scenes, color_video)
    done("7 concat")
    return out
