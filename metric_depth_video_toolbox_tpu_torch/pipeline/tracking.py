"""Point-tracking stage: colour video -> ``*_tracking.json`` (PyTorch port
of ``pipeline/tracking.py``).

Grid queries over each clip's first frame, tracked through clips of
``clip_len`` frames by the pyramidal LK tracker (default) or CoTracker3;
clips start every ``steps_between_init`` frames, and a new clip's grid
point near a track still alive at that frame inherits its global id.
Track rows are [global_id, x, y] per frame.
"""

from __future__ import annotations

import numpy as np
import torch

from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.io import video as vio
from metric_depth_video_toolbox_tpu_torch.models import tracker as trk
from metric_depth_video_toolbox_tpu_torch.ops import image as im
from metric_depth_video_toolbox_tpu_torch.utils.device import resolve_device


def load_cotracker3(weights):
    """-> (params, cfg) for ``CoTracker3Engine``: a torch checkpoint
    (``.pth``, ``.pt``, ``.bin``) in the upstream layout, converted here
    with its configuration read from its shapes, or a converted file
    (cfg None: the engine's default, COTRACKER3)."""
    from metric_depth_video_toolbox_tpu_torch.models import convert
    if weights.endswith((".pth", ".pt", ".bin")):
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k: v.numpy() for k, v in sd.items()}
        return (convert.convert_cotracker3(sd),
                convert.cotracker3_config_from_state_dict(sd))
    return convert.load_checkpoint(weights), None


def _make_clip_tracker(engine, weights, device):
    """-> clip_track(frames_u8 (T, H, W, 3) numpy, pts (N, 2), valid (N,))
    -> (traj (T, N, 2), vis (T, N)) numpy, by the pyramidal LK tracker or
    CoTracker3 (``weights``: see :func:`load_cotracker3`; None draws
    seeded weights)."""
    if engine != "cotracker3":
        def lk(clip, pts, ok):
            traj, vis = trk.lk_track_clip(
                torch.from_numpy(np.ascontiguousarray(clip)).to(device),
                torch.from_numpy(pts).to(device),
                torch.from_numpy(ok).to(device))
            return traj.cpu().numpy(), vis.cpu().numpy()
        return lk
    from metric_depth_video_toolbox_tpu_torch.models import cotracker as ct
    params, cfg = load_cotracker3(weights) if weights else (None, None)
    return ct.CoTracker3Engine(cfg, params=params, device=device).track_clip


def track_video(color_video, output=None, clip_len=120, grid=36,
                max_frames=-1, engine="lk", reseed_radius=12.0,
                save_viz=False, rng_seed=0, downscale=1,
                nr_iterations=1, steps_between_init=None, weights=None,
                device=None):
    """Track grid points through the whole video in overlapping clips.

    ``downscale`` tracks at a reduced resolution and scales coordinates
    back; ``nr_iterations`` repeats the pass with new grid jitter;
    ``steps_between_init`` is the clip stride (default clip_len - 1).
    Returns the tracking-json path (``color_video + "_tracking.json"``
    unless ``output``); ``save_viz`` also writes ``<output>_tracked.mkv``.
    """
    device = resolve_device(device)
    frames, fps = vio.read_video_frames(color_video, max_frames=max_frames)
    t_total, h, w = frames.shape[:3]
    rng = np.random.default_rng(rng_seed)
    clip_track = _make_clip_tracker(engine, weights, device)

    track_frames = frames
    if downscale > 1:
        th, tw = h // downscale, w // downscale
        track_frames = im.resize(torch.from_numpy(frames).to(
            device, torch.float32), (th, tw)).cpu().numpy().astype(np.uint8)

    stride = steps_between_init or (clip_len - 1)
    stride = max(1, min(stride, clip_len - 1)) if clip_len > 1 else 1

    out_frames = [[] for _ in range(t_total)]
    next_gid = 0

    for _ in range(max(1, nr_iterations)):
        prev_traj = prev_vis = prev_gids = None
        prev_start = 0
        written_until = 0
        start = 0
        while start < t_total:
            end = min(start + clip_len, t_total)
            clip = track_frames[start:end]
            pts, ok = trk.generate_grid_queries(
                torch.from_numpy(clip[0]).to(device), grid=grid, rng=rng)

            # a grid point near a track of the previous clip alive at this
            # clip's first frame inherits its global id
            gids = -np.ones(pts.shape[0], np.int64)
            if prev_traj is not None:
                oi = start - prev_start
                if 0 <= oi < prev_traj.shape[0]:
                    alive = prev_vis[oi] > 0
                    ppts = prev_traj[oi, alive]
                    pids = prev_gids[alive]
                    if ppts.shape[0]:
                        d2 = ((pts[:, None, :] - ppts[None]) ** 2).sum(-1)
                        nearest = d2.argmin(1)
                        near_ok = d2[np.arange(pts.shape[0]),
                                     nearest] < reseed_radius ** 2
                        taken = set()
                        for i in np.argsort(
                                d2[np.arange(pts.shape[0]), nearest]):
                            j = nearest[i]
                            if near_ok[i] and ok[i] > 0 and j not in taken:
                                gids[i] = pids[j]
                                taken.add(j)
            fresh = (gids < 0) & (ok > 0)
            gids[fresh] = np.arange(next_gid, next_gid + fresh.sum())
            next_gid += int(fresh.sum())

            traj, vis = clip_track(clip, pts, ok)

            for fi in range(end - start):
                if start + fi < written_until:
                    continue  # covered by the previous stream
                alive = (vis[fi] > 0) & (gids >= 0)
                rows = np.stack([gids[alive].astype(np.float32),
                                 traj[fi, alive, 0] * downscale,
                                 traj[fi, alive, 1] * downscale], axis=-1)
                if len(out_frames[start + fi]):
                    rows = np.concatenate(
                        [np.asarray(out_frames[start + fi]).reshape(-1, 3),
                         rows])
                out_frames[start + fi] = rows
            written_until = end

            prev_traj, prev_vis, prev_gids = traj, vis, gids
            prev_start = start
            if end == t_total:
                break
            start = min(start + stride, t_total - 1)

    output = output or (color_video + "_tracking.json")
    sidecar.save_tracking(output, [np.asarray(f, np.float32).reshape(-1, 3)
                                   for f in out_frames])

    if save_viz:
        viz = frames.copy()
        colors = rng.integers(64, 255, (next_gid + 1, 3))
        for fi, rows in enumerate(out_frames):
            for gid, x, y in np.asarray(rows).reshape(-1, 3):
                xi, yi = int(x), int(y)
                if 0 <= xi < w and 0 <= yi < h:
                    viz[fi, max(0, yi - 1):yi + 2,
                        max(0, xi - 1):xi + 2] = colors[int(gid) % len(colors)]
        vio.save_rgb_video(viz, output + "_tracked.mkv", fps)
    return output
