"""The readers of the program's spans (``progtrace.py`` and the metrics
that use it) on a synthetic device timeline and synthetic span records:
idle time goes to the innermost span open, the time between profiler
sessions counts for nothing, the rates are the plain arithmetic, and with
no records every reader gives None."""

import importlib

import pytest

import devtrace
import progtrace
import run

READERS = ("encoder_ms_per_frame", "head_ms_per_frame", "anchor_ms_per_frame",
           "align_ms_per_frame", "sweep_ms_per_frame",
           "encoder_frames_per_frame", "d2h_gb_per_s",
           "program_idle_ms_per_frame")
D2H = "Memcpy DtoH (Device -> Pageable)"
MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def timeline():
    """Two sessions of a depth and a stereo span each (a marker kernel
    between them), idle 100 + 100 + 200 ns in the first and 100 ns in the
    second; 4,000 ns between the sessions."""
    first = [(100, 200, "k1", "kernel"), (300, 400, D2H, "copy"),
             (450, 460, MARK, "kernel"), (500, 700, "k2", "kernel"),
             (900, 1000, D2H, "copy")]
    second = [(5000, 5100, "k1", "kernel"), (5150, 5160, MARK, "kernel"),
              (5200, 5300, "k2", "kernel")]
    return devtrace.Timeline([(first, ["depth", "stereo"]),
                              (second, ["depth", "stereo"])])


def rec(index, name, start, end, parent=None, device_ms=None, **attrs):
    return {"name": name, "index": index, "parent": parent,
            "start_ns": start, "end_ns": end, "attrs": attrs,
            "device_ms": device_ms}


RECS = [
    rec(0, "depth.video", 50, 420, frames=3),
    rec(1, "depth.to_device", 60, 250, parent=0, bytes=900),
    rec(2, "depth.encoder", 70, 190, parent=0, device_ms=2.0, frames=4),
    rec(3, "depth.anchor", 251, 300, parent=0, device_ms=1.5, frames=2),
    rec(4, "depth.encoder", 252, 280, parent=3, device_ms=0.5, frames=2),
    rec(5, "depth.head", 281, 299, parent=3, device_ms=0.25, frames=2),
    rec(6, "depth.head", 301, 310, parent=0, device_ms=1.0, frames=4),
    rec(7, "depth.align", 311, 315, parent=0),
    rec(8, "stereo.batch", 480, 1100, frames=3),
    rec(9, "stereo.sweep", 600, 650, parent=8, device_ms=0.75,
        **{"pass": "main"}),
    rec(10, "stereo.sweep", 660, 690, parent=8, device_ms=0.25,
        **{"pass": "anchor"}),
    rec(11, "stereo.to_host", 850, 1050, parent=8, bytes=3000),
    rec(12, "depth.video", 2000, 4000),       # between the sessions
    rec(13, "depth.video", 4990, 5120, frames=2),
    rec(14, "depth.align", 5010, 5016, parent=13),
    rec(15, "stereo.batch", 5140, 5400, frames=2),
]


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(progtrace, "records", lambda: [dict(r) for r in RECS])


def view(frames=2):
    return run.RunView(spans=[], timeline=timeline(), frames=frames)


def read(name, v):
    return importlib.import_module(f"metrics.{name}").read(v)


def test_the_timeline_is_the_one_devtrace_reads():
    tl = timeline()
    assert tl.window_ns == 900 + 300
    assert tl.busy_s() * 1e9 == pytest.approx(700)
    assert progtrace.idle_intervals(tl) == [(200, 300), (400, 500),
                                            (700, 900), (5100, 5200)]


def test_idle_goes_to_the_innermost_span(spans):
    idle = progtrace.idle_by_span(view())
    # 200-250 in to_device, 250-251 in video, 251-300 in the anchor (its
    # encoder and head leave 251-252, 280-281 and 299-300 to it); 400-420
    # video, 420-480 none, 480-500 batch; 700-850 batch, 850-900 to_host;
    # 5100-5120 video, 5120-5140 none, 5140-5200 batch
    assert idle == {"depth.to_device": 50, "depth.video": 1 + 20 + 20,
                    "depth.anchor": 3, "depth.encoder": 28,
                    "depth.head": 18, "stereo.batch": 20 + 150 + 60,
                    "stereo.to_host": 50, None: 60 + 20}
    assert sum(idle.values()) == 500      # the window's idle, no more
    assert read("program_idle_ms_per_frame", view(frames=2)) == \
        pytest.approx((500 - 80) / 1e6 / 2)


def test_the_gap_between_sessions_counts_for_nothing(spans):
    idle = progtrace.idle_by_span(view())
    between = rec(0, "x.between", 1001, 4999)
    alone = progtrace.idle_by_span(view(), [between])
    assert alone == {None: 500}
    assert "x.between" not in idle


def test_sessions_must_make_up_the_window():
    tl = timeline()
    tl.window_ns += 1
    assert progtrace.sessions(tl) is None
    assert progtrace.idle_by_span(run.RunView(timeline=tl, frames=1),
                                  RECS) is None


def test_the_rates_and_ratios(spans):
    v = view(frames=5)
    # device ms of the encoder and heads outside the anchor, of the anchor,
    # of both sweeps; host ms of the aligns; frames of every encoder span
    assert read("encoder_ms_per_frame", v) == pytest.approx(2.0 / 5)
    assert read("head_ms_per_frame", v) == pytest.approx(1.0 / 5)
    assert read("anchor_ms_per_frame", v) == pytest.approx(1.5 / 5)
    assert read("sweep_ms_per_frame", v) == pytest.approx(1.0 / 5)
    assert read("align_ms_per_frame", v) == pytest.approx(10 / 1e6 / 5)
    assert read("encoder_frames_per_frame", v) == pytest.approx(6 / 5)
    # 3,000 bytes over 200 ns of device-to-host copies
    assert read("d2h_gb_per_s", v) == pytest.approx(3000 / 1e9 / 200e-9)


def test_spans_without_device_time_read_none(monkeypatch):
    monkeypatch.setattr(progtrace, "records", lambda: [
        rec(0, "depth.encoder", 0, 10, frames=4),
        rec(1, "stereo.sweep", 20, 30)])
    assert read("encoder_ms_per_frame", view()) is None
    assert read("sweep_ms_per_frame", view()) is None
    assert read("encoder_frames_per_frame", view()) == 2.0


@pytest.mark.parametrize("name", READERS)
def test_no_records_read_none(monkeypatch, name):
    monkeypatch.setattr(progtrace, "records", lambda: [])
    assert read(name, view()) is None
    assert read(name, run.RunView(timeline=None, frames=2)) is None


def test_a_program_without_spans_has_no_records(monkeypatch):
    monkeypatch.setattr(progtrace, "TIMER", "json")    # no spans()
    assert progtrace.records() == []
    monkeypatch.setattr(progtrace, "TIMER", "no_such_module_here")
    assert progtrace.records() == []
