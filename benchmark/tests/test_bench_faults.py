"""A run with the timed path broken underneath reads ``correct`` false.

Each test drives the rest of a run on the CPU at the small configuration
of ``rehearse_<config>.json``, against the cells' own limits, with one
fault planted in the program: a depth altered where it is produced, half
of each stereo batch left out, and a stereo step that hands its input back
unchanged. The sound run beside them reads ``correct`` true."""

import numpy as np
import pytest
import torch

import run
from metric_depth_video_toolbox_tpu_torch.models import da3
from metric_depth_video_toolbox_tpu_torch.pipeline import depth
from metric_depth_video_toolbox_tpu_torch.pipeline import stereo

CELLS = {"vda": "vda_vitl.film_1080p", "da3": "da3_vitl.film_1080p"}


def rehearse(kind, seed=5):
    torch.set_num_threads(4)
    out = run.main(["--workload", CELLS[kind], "--seed", str(seed),
                    "--seconds", "0.5", "--trace", "0", "--rehearse",
                    f"benchmark/tests/rehearse_{kind}.json"])
    return out["rehearsal"]


@pytest.fixture(autouse=True)
def at_root(monkeypatch):
    monkeypatch.chdir(run.ROOT)


@pytest.mark.parametrize("kind", ["vda", "da3"])
def test_bench_sound_run_is_correct(kind):
    r = rehearse(kind)
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["correct_at_these_limits"], r["checks"]


def _scaled_second_half(d):
    d = np.array(d, copy=True)
    d[len(d) // 2:] *= 1.25
    return d


@pytest.mark.parametrize("kind", ["vda", "da3"])
def test_bench_altered_depth_is_not_correct(kind, monkeypatch):
    if kind == "vda":
        infer = depth.VDAEngine.infer_video
        monkeypatch.setattr(depth.VDAEngine, "infer_video",
                            lambda self, f, **kw: _scaled_second_half(
                                infer(self, f, **kw)))
    else:
        infer = da3.DA3Engine.infer_video

        def faulty(self, f):
            d, c2w, xfov = infer(self, f)
            return _scaled_second_half(d), c2w, xfov
        monkeypatch.setattr(da3.DA3Engine, "infer_video", faulty)
    r = rehearse(kind)
    assert not r["correct_at_these_limits"], r["checks"]


def test_bench_half_the_stereo_batch_left_out(monkeypatch):
    step = stereo.stereo_step

    def faulty(cfg, depth_rgb, *args, **kw):
        half = depth_rgb.shape[0] // 2 or 1
        out = step(cfg, depth_rgb[:half], *[a[:half] for a in args], **kw)
        return {k: np.concatenate([v, np.zeros_like(
            v[:1]).repeat(depth_rgb.shape[0] - half, 0)])
            for k, v in out.items()}
    monkeypatch.setattr(stereo, "stereo_step", faulty)
    r = rehearse("vda")
    assert not r["correct_at_these_limits"], r["checks"]


def test_bench_stereo_step_that_returns_its_input(monkeypatch):
    def unchanged(cfg, depth_rgb, color, *args, **kw):
        c = color.cpu().numpy()
        return {"image": np.concatenate([c, c], 2),
                "infill_mask": np.zeros_like(np.concatenate([c, c], 2))}
    monkeypatch.setattr(stereo, "stereo_step", unchanged)
    r = rehearse("vda")
    assert not r["correct_at_these_limits"], r["checks"]
