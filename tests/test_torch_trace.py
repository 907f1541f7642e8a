"""The port's spans (``utils/timer.py``: ``span``, ``add``, ``spans``,
``take``) on the CPU: they record only under a profiler, nest, share the
profiler's clock, and carry the counts the engines' own arithmetic gives
(the VDA and DA3 windows, the stereo step's copies), while the outputs stay
bit for bit what they are without a profiler. The test marked ``gpu``
checks on a card that the card's activities sit on the spans' clock and
that no span reaches the device timeline of a CUDA-only session. This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py -q
"""

import dataclasses
import importlib
import statistics
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metric_depth_video_toolbox_tpu_torch.models import da3 as tda3
from metric_depth_video_toolbox_tpu_torch.ops import codec
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as tdepth
from metric_depth_video_toolbox_tpu_torch.pipeline import infill_diffusion
from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

timer = importlib.import_module(
    "metric_depth_video_toolbox_tpu_torch.utils.timer")

CPU = [ProfilerActivity.CPU]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _empty_log():
    timer.take()
    yield
    timer.take()


def clip(t, h=28, w=28, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (t, h, w, 3),
                                                np.uint8)


def traced(fn, activities=CPU):
    """-> (fn(), the span records, the profiler)"""
    with profile(activities=activities) as prof:
        out = fn()
    return out, timer.take(), prof


def named(recs, name):
    return [r for r in recs if r["name"] == name]


def test_no_profiler_no_records():
    with timer.span("a.b", frames=3):
        timer.add("bytes", 5)
        with timer.span("a.c", device=torch.device("cpu")):
            pass
    assert timer.spans() == [] and timer.dropped() == 0


def test_spans_nest_and_count_under_a_profiler():
    def run():
        with timer.span("a.outer", frames=2):
            with timer.span("a.inner"):
                timer.add("bytes", 5)
                timer.add("bytes", 6)
            with timer.span("a.inner"):
                pass
        with timer.span("a.next"):
            pass
    _, recs, _ = traced(run)
    assert [(r["name"], r["index"], r["parent"]) for r in recs] == [
        ("a.outer", 0, None), ("a.inner", 1, 0), ("a.inner", 2, 0),
        ("a.next", 3, None)]
    assert recs[0]["attrs"] == {"frames": 2}
    assert recs[1]["attrs"] == {"bytes": 11} and recs[2]["attrs"] == {}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None
    outer, inner = recs[0], recs[1]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"] <= recs[3]["start_ns"]
    assert timer.spans() == []


def test_record_function_events_lie_inside_the_spans():
    """The profiler's event of each span starts and ends inside the span's
    host interval: the spans read the profiler's clock."""
    def run():
        for i in range(5):
            with timer.span(f"c.span{i}"):
                torch.ones(64, 64).sum()
    _, recs, prof = traced(run)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("c.span")}
    assert len(recs) == len(events) == 5
    for r in recs:
        e = events[r["name"]]
        assert r["start_ns"] <= e.start_ns() <= e.start_ns() \
            + e.duration_ns() <= r["end_ns"], (r, e.start_ns())


def test_records_are_capped(monkeypatch):
    monkeypatch.setattr(timer, "MAX_RECORDS", 3)
    with profile(activities=CPU):
        for _ in range(5):
            with timer.span("d.x"):
                pass
    assert timer.dropped() == 2 and len(timer.take()) == 3
    assert timer.dropped() == 0


def vda_windows(t, window, overlap):
    """(views, new, padded) of each window, as the engine cuts them."""
    step = window - overlap
    starts = [0]
    while starts[-1] + window < t:
        starts.append(starts[-1] + step)
    out = []
    for s0 in starts:
        end = min(s0 + window, t)
        out.append((window, end - (s0 + overlap if s0 else 0),
                    s0 + window - end))
    return out


def test_vda_engine_spans_and_counts():
    t, hw = 11, (28, 28)
    frames = clip(t, *hw)

    def engine():
        return tdepth.VDAEngine(size="vitt", input_size=28, window=4,
                                overlap=1, fp32=True, data_parallel=False,
                                device="cpu")
    plain = engine().infer_video(frames)
    got, recs, _ = traced(lambda: engine().infer_video(frames))
    np.testing.assert_array_equal(got, plain)

    (video,) = named(recs, "depth.video")
    assert video["attrs"] == {"frames": t} and video["parent"] is None
    wins = named(recs, "depth.window")
    assert [(w["attrs"]["views"], w["attrs"]["new"], w["attrs"]["padded"])
            for w in wins] == vda_windows(t, 4, 1)
    assert sum(w["attrs"]["new"] for w in wins) == t
    frame_bytes = hw[0] * hw[1] * 3
    to_dev = named(recs, "depth.to_device")
    win_ids = {w["index"] for w in wins}
    (anchor,) = named(recs, "depth.anchor")
    assert anchor["attrs"] == {"frames": t}
    assert [d["attrs"]["bytes"] for d in to_dev
            if d["parent"] in win_ids] == [4 * frame_bytes] * len(wins)
    assert [d["attrs"]["bytes"] for d in to_dev
            if d["parent"] == anchor["index"]] == [t * frame_bytes]
    enc = named(recs, "depth.encoder")
    head = named(recs, "depth.head")
    assert [e["attrs"]["frames"] for e in enc] == [4] * len(wins) + [t]
    assert [e["attrs"]["frames"] for e in head] == [4] * len(wins) + [t]
    assert [e["parent"] for e in enc[:len(wins)]] == [w["index"]
                                                      for w in wins]
    assert len(named(recs, "depth.align")) == 2   # the stitch and the fit
    (host,) = named(recs, "depth.to_host")
    assert host["attrs"] == {"bytes": got.nbytes}
    assert all(r["device_ms"] is None for r in recs)   # no CUDA device


def test_da3_engine_spans_and_counts():
    t, hw = 9, (28, 28)
    frames = clip(t, *hw, seed=1)
    cfg = dataclasses.replace(tda3.DA3_TINY, vit=dataclasses.replace(
        tda3.DA3_TINY.vit, dtype="float32"))

    def engine():
        return tda3.DA3Engine(cfg=cfg, images_per_batch=4, overlap=1,
                              num_ref_frames=2, resolution=28, device="cpu")
    plain = engine().infer_video(frames)
    got, recs, _ = traced(lambda: engine().infer_video(frames))
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)

    assert named(recs, "depth.video")[0]["attrs"] == {"frames": t}
    # windows of 4 new frames + 2 reference + 1 overlap views (7): the
    # first has no overlap yet, the last 3 frames of the clip
    wins = named(recs, "depth.window")
    assert [(w["attrs"]["views"], w["attrs"]["new"], w["attrs"]["padded"])
            for w in wins] == [(7, 4, 1), (7, 3, 0), (7, 2, 1)]
    frame_bytes = hw[0] * hw[1] * 3
    assert [d["attrs"]["bytes"] for d in named(recs, "depth.to_device")] \
        == [7 * frame_bytes] * 3
    assert [e["attrs"]["frames"] for e in named(recs, "depth.encoder")] \
        == [7] * 3
    assert [e["attrs"]["frames"] for e in named(recs, "depth.head")] \
        == [7] * 3
    assert len(named(recs, "depth.align")) == 3
    host = [h["attrs"]["bytes"] for h in named(recs, "depth.to_host")]
    # each window's cameras, then its frames' depth (the frame it shares
    # with the window before written again)
    cams = 7 * 16 * 4 + 7 * 4
    depth_bytes = [4 * hw[0] * hw[1] * 4, 4 * hw[0] * hw[1] * 4,
                   3 * hw[0] * hw[1] * 4]
    assert host == [x for d in depth_bytes for x in (cams, d)]


def test_stereo_step_spans():
    d = torch.full((2, 32, 64), 5.0)
    d[:, 8:24, 16:40] = 2.0
    rgb = codec.encode_depth_frame(d, 100.0)
    col = torch.from_numpy(clip(2, 32, 64, seed=2))
    k = geo.camera_matrix_from_fov(64, 32, xfov_deg=60.0)[None].repeat(
        2, 1, 1)
    cfg = stereo.StereoConfig(width=64, height=32, make_infill_mask=True)
    args = (cfg, rgb, col, k, torch.eye(4)[None].repeat(2, 1, 1),
            torch.full((2,), 2.0), torch.ones(2))
    plain = stereo.stereo_step(*args)
    got, recs, _ = traced(lambda: stereo.stereo_step(*args))
    for key in plain:
        np.testing.assert_array_equal(got[key], plain[key])
    assert [r["name"] for r in recs] == [
        "stereo.batch", "stereo.decode", "stereo.edges", "stereo.sweep",
        "stereo.sweep", "stereo.mask", "stereo.to_host"]
    assert recs[0]["attrs"] == {"frames": 2}
    assert all(r["parent"] == 0 for r in recs[1:])
    assert [r["attrs"] for r in named(recs, "stereo.sweep")] == [
        {"pass": "main"}, {"pass": "anchor"}]
    assert recs[-1]["attrs"] == {
        "bytes": got["image"].nbytes + got["infill_mask"].nbytes}


def test_infill_stage_names_reach_the_profiler():
    sbs = clip(5, 32, 128, seed=3)
    hole = np.zeros(sbs.shape[:3], bool)
    hole[:, 10:20, 20:30] = hole[:, 10:20, 84:94] = True
    masks = np.where(hole[..., None], 255, 0).astype(np.uint8) \
        .repeat(3, -1)
    eng = infill_diffusion.DiffusionInfillEngine(
        work_hw=(32, 48), chunk=5, data_parallel=False, device="cpu")
    _, recs, prof = traced(lambda: infill_diffusion.infill_sbs_frames(
        sbs, hole, eng, apply_edge_blending=True, masks_rgb=masks))
    names = ("infill.encode", "infill.sample", "infill.decode_composite",
             "infill.halo_blend")
    seen = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(names) <= seen
    assert {r["name"] for r in recs} >= set(names)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: checks the card's trace clock")
    return torch.device("cuda")


def _device_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


@pytest.mark.gpu
def test_card_clock_and_no_span_on_the_device_timeline(cuda):
    """Under a CUDA-only session: the profiler reports itself enabled, a
    kernel launched right after a synchronise starts on the card within
    1 ms after the host's ``time.time_ns()`` before the launch, and the
    spans add no activity to the card's timeline (the same activities,
    none named after a span)."""
    x = torch.randn(1024, 1024, device=cuda)
    (x @ x).sum().item()

    def work(with_spans):
        for _ in range(4):
            if with_spans:
                with timer.span("g.outer", device=cuda, frames=1):
                    with timer.span("g.inner", device=cuda):
                        y = x @ x
                    with timer.span("g.copy"):
                        y[:64].cpu()
            else:
                y = x @ x
                y[:64].cpu()
        torch.cuda.synchronize()

    host = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert torch.autograd._profiler_enabled()
        for _ in range(20):
            torch.cuda.synchronize()
            host.append(time.time_ns())
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    starts = [e.start_ns() for e in _device_events(prof)]
    assert len(starts) == 20
    lags = [s - h for s, h in zip(sorted(starts), host)]
    assert min(lags) >= 0 and statistics.median(lags) < 1e6, lags

    runs = {}
    for with_spans in (True, False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            work(with_spans)
        runs[with_spans] = sorted(e.name() for e in _device_events(prof))
    recs = timer.take()
    assert {r["name"] for r in recs} == {"g.outer", "g.inner", "g.copy"}
    assert runs[True] == runs[False]
    assert not {r["name"] for r in recs} & set(runs[True])
    inner = named(recs, "g.inner")
    assert all(r["device_ms"] > 0 for r in inner)
