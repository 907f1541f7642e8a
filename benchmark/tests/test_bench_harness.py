"""The harness: its last line, its refusals and its import checks."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import devtrace
import run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "metric_depth_video_toolbox_tpu"}


def test_bench_result_line_keys():
    line = run.result_line(True, 3, 0, {"fps": {"value": 1.5,
                                                "unit": "frames/s"}},
                           {"platform": "gpu"}, None,
                           {"depth_err": {"value": 0.1, "limit": 0.2}})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    traced = run.result_line(False, 3, 1, {}, {"platform": "gpu"},
                             {"device_ops": [], "idle_gaps": []}, {})
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert json.loads(json.dumps(traced)) == traced


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "vda_vitl.film_1080p", "--seed", "7", "--seconds", "1", "--trace",
         "0", *extra], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_bench_refuses_without_a_card():
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA" in p.stderr


def test_bench_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout == ""


def test_bench_forbidden_names_compare_the_top_level_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "metric_depth_video_toolbox_tpu_torch"
                        ".fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "metric_depth_video_toolbox_tpu.x",
                        object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax", "metric_depth_video_toolbox_tpu"]


def test_bench_refuses_jax_loaded_late(monkeypatch, capsys):
    """The check made again just before the result is printed: a module
    that the check or a metric reader loads after the window still stops
    the run with code 4."""
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(SystemExit) as e:
        run.refuse_jax()
    assert e.value.code == 4
    assert "jax" in capsys.readouterr().err


def test_bench_a_run_loads_no_jax():
    """A whole rehearsal run's module set, with every metric reader that
    BENCHMARK.json names imported after it: nothing of JAX, Flax or the
    JAX package (the run itself exits 4 if it finds one)."""
    code = ("import sys, json, runpy, importlib; sys.argv = ['run.py', "
            "'--workload', 'vda_vitl.film_1080p', '--seed', '3', "
            "'--seconds', '0.1', '--trace', '0', '--rehearse', "
            "'benchmark/tests/rehearse_vda.json'];\n"
            "runpy.run_path('benchmark/run.py', run_name='__main__')\n"
            "b = json.load(open('BENCHMARK.json'))\n"
            "for m in b['end_to_end'] + b['per_layer']:\n"
            "    importlib.import_module('metrics.' + m['name'])\n"
            "print('TOP', sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    tops = json.loads(p.stdout.splitlines()[-1][4:].replace("'", '"'))
    assert not FORBIDDEN & set(tops)
    assert "metric_depth_video_toolbox_tpu_torch" in tops


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_bench_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").glob("*.py"))
    assert files
    for f in files:
        names = _imports(f)
        assert not (FORBIDDEN | {"metric_depth_video_toolbox_tpu_torch"}) \
            & names, (f, names)
    code = ("import sys; sys.path[:0] = ['benchmark']\n"
            "import reference.models, reference.pipelines, "
            "reference.stereo\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.replace("'", '"')))
    assert not (FORBIDDEN | {"metric_depth_video_toolbox_tpu_torch"}) & tops


def test_bench_timeline_union_and_spans():
    """Busy time is the union of intervals; events before the first
    marker belong to the first span, those after a marker to the span it
    opened."""
    ev = [(2, 10, "k1", "kernel"), (5, 12, "Memcpy DtoH", "copy"),
          (20, 21, "spin_kernel(long)", "kernel"),
          (30, 40, "k2", "kernel"), (45, 51, "k3", "kernel")]
    tl = devtrace.Timeline([(ev, ["depth", "stereo"])])
    assert tl.busy_s() == (10 + 16) / 1e9
    assert tl.busy_s("depth", kinds=("kernel",)) == 8 / 1e9
    assert tl.busy_s("stereo", kinds=("kernel",)) == 16 / 1e9
    assert tl.total_s(("copy",)) == 7 / 1e9
    assert tl.window_s == 49 / 1e9
    gaps = dict((k, v) for k, v in tl.idle_gaps())
    assert gaps == {"after depth": 18 / 1e9, "stereo": 5 / 1e9}
    with pytest.raises(RuntimeError):
        devtrace.Timeline([(ev, ["depth", "stereo", "end"])])


def test_bench_timeline_of_two_sessions():
    """Two profiler sessions (two shots): their windows and busy times
    add, and the time between them (the tracer's own) is no gap."""
    one = [(2, 10, "k1", "kernel"), (10, 11, "spin_kernel(long)", "kernel"),
           (12, 20, "k2", "kernel")]
    two = [(t0 + 1000, t1 + 1000, n, k) for t0, t1, n, k in one]
    labels = ["depth", "stereo"]
    tl = devtrace.Timeline([(one, labels), (two, labels)])
    assert tl.window_s == 2 * 18 / 1e9
    assert tl.busy_s() == 2 * (8 + 8) / 1e9       # the markers left out
    assert tl.busy_s("stereo", kinds=("kernel",)) == 2 * 8 / 1e9
    assert dict((k, v) for k, v in tl.idle_gaps()) == {
        "after depth": 2 * 2 / 1e9}
    with pytest.raises(RuntimeError):     # a session that lost its marker
        devtrace.Timeline([(one, labels), (two[::2], labels)])
