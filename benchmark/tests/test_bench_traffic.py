"""The film-shot traffic: every seed does the same work."""

import json
from pathlib import Path

import numpy as np
import torch

from traffic import generator

HERE = Path(__file__).resolve().parent


def small_mix():
    return json.loads((HERE / "rehearse_vda.json").read_text())["traffic"]


def test_bench_film_lengths_are_the_quantiles():
    mix = generator.load("film_1080p")
    lengths = generator.shot_lengths(mix)
    assert sorted(lengths) == [18, 32, 46, 62, 83, 112, 160, 240]
    assert lengths == [62, 160, 18, 112, 46, 240, 32, 83]


def test_bench_same_shots_for_every_seed():
    """The multiset of shot lengths (and their order) is the seed's to
    keep; only the content changes with the seed."""
    mix = small_mix()
    runs = {}
    for seed in (1, 2, 2 ** 31 + 11):
        shots = generator.FilmShots(mix, seed, torch.device("cpu"))
        got = [shots.shot(k) for k in range(2 * len(shots.lengths))]
        runs[seed] = got
    lengths = {seed: [f.shape[0] for f, _ in got]
               for seed, got in runs.items()}
    assert len({tuple(v) for v in lengths.values()}) == 1
    assert not np.array_equal(runs[1][0][0], runs[2][0][0])
    again = generator.FilmShots(mix, 2, torch.device("cpu")).shot(0)[0]
    assert np.array_equal(again, runs[2][0][0])


def test_bench_shots_wrap_round_the_pool():
    mix = small_mix()
    shots = generator.FilmShots(mix, 5, torch.device("cpu"))
    n = shots.pool_frames
    seen = 0
    for k in range(3 * len(shots.lengths)):
        frames, conv = shots.shot(k)
        start = seen % n
        assert np.array_equal(frames, shots.pool[start:start + len(frames)])
        assert np.array_equal(frames[0], shots.pool[start % n])
        lo, hi = mix["convergence_depth_m"]
        assert lo <= conv <= hi
        seen += len(frames)
