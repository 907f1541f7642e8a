"""The control reads ``correct`` false at the small configuration of
``rehearse_<config>.json``, on the CPU, against the cells' own limits: the
reference put in the program's place one precision below bfloat16 (float8
operands for every linear and convolution of the depth models, the stereo
step's depth rounded to bfloat16). The program's readings on other seeds
pass every limit. The card's readings at the cells' own sizes, from which
the limits were set, are in PERF.md (``benchmark/calibrate.py``)."""

import json

import pytest
import torch

import calibrate
import run

CELLS = {"vda": "vda_vitl.film_1080p", "da3": "da3_vitl.film_1080p"}


@pytest.mark.parametrize("kind", ["vda", "da3"])
def test_bench_control_is_not_correct(kind, monkeypatch):
    monkeypatch.chdir(run.ROOT)
    torch.set_num_threads(4)
    reh = (run.HERE / "tests" / f"rehearse_{kind}.json").read_text()
    limits = run.load_json(run.HERE / "workloads" / f"{CELLS[kind]}.json"
                           )["check"]["limits"]

    def read(mode, seed):
        return calibrate.reading(CELLS[kind], seed, mode, None,
                                 torch.device("cpu"),
                                 json.loads(reh))["numbers"]
    for seed in (1, 2, 3):
        numbers = read("program", seed)
        assert all(numbers[k] <= v for k, v in limits.items()), numbers
    for seed in (4, 5, 6):
        numbers = read("control", seed)
        assert any(numbers[k] > v for k, v in limits.items()), numbers
