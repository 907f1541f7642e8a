"""The port's scene scheduler (``parallel/scheduler.py``): the counterparts
of ``tests/test_multihost_scenes.py`` (the partition, resume by existence
across two hosts, a 2-worker process fan-out), the device gate, the thread
pool that continues past a failed scene, and the process index read from
``torchrun``'s environment. The partition is held equal to the JAX
package's."""

import os
import sys
import threading
import time

import numpy as np
import pytest

from metric_depth_video_toolbox_tpu.parallel import scheduler as jsched
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.parallel import scheduler


@pytest.mark.parametrize("n,hosts", [(11, 3), (4, 2), (1, 4)])
def test_shard_scenes_partitions_completely(n, hosts):
    scenes = [f"s{i}" for i in range(n)]
    shards = [scheduler.shard_scenes(scenes, host_index=i, host_count=hosts)
              for i in range(hosts)]
    flat = [s for sh in shards for s in sh]
    assert sorted(flat) == sorted(scenes) and len(set(flat)) == len(flat)
    sizes = [len(sh) for sh in shards]
    assert max(sizes) - min(sizes) <= 1
    assert shards == [jsched.shard_scenes(scenes, host_index=i,
                                          host_count=hosts)
                      for i in range(hosts)]


def test_two_host_overlap_is_harmless(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    scenes = []
    for i in range(4):
        clip = str(tmp_path / f"scene{i}.mkv")
        tvio.save_rgb_video(rng.integers(0, 255, (2, 16, 16, 3), np.uint8),
                            clip, 24)
        scenes.append(clip)
    writes = []

    def process(host_scenes):
        for clip in host_scenes:
            out = clip + "_out.mkv"
            if tvio.is_valid_video(out):      # resume by existence
                continue
            frames, fps = tvio.read_video_frames(clip)
            tvio.save_rgb_video(frames, out, fps)
            writes.append(out)

    process(scheduler.shard_scenes(scenes, host_index=0, host_count=2))
    process(scenes)         # host 1 fails over and takes every scene
    process(scheduler.shard_scenes(scenes, host_index=1, host_count=2))
    for clip in scenes:
        assert tvio.is_valid_video(clip + "_out.mkv")
    assert len(writes) == len(scenes)


def test_process_fanout_two_workers(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text("import sys\n"
                      "out = sys.argv[1]\n"
                      "if out.endswith('bad'):\n"
                      "    sys.exit(3)\n"
                      "open(out, 'w').write('done')\n")
    scenes = [str(tmp_path / f"o{i}") for i in range(5)] + [
        str(tmp_path / "bad")]
    failed = scheduler.run_scenes_processes(
        lambda s: [sys.executable, str(script), s], scenes, parallel=2)
    for s in scenes[:5]:
        assert os.path.exists(s)
    assert failed == [str(tmp_path / "bad")]


def test_device_gate_serialises():
    """Eight workers on four threads, each holding the gate across a
    switch-prone read-modify-write: no section overlaps another."""
    gate = scheduler.DeviceGate()
    inside, overlaps, total = [0], [0], [0]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def scene(i, g):
            for _ in range(50):
                with g:
                    inside[0] += 1
                    if inside[0] > 1:
                        overlaps[0] += 1
                    time.sleep(0)
                    total[0] += 1
                    inside[0] -= 1
            return i
        results = scheduler.run_scenes_threaded(scene, range(8), workers=4,
                                                gate=gate)
    finally:
        sys.setswitchinterval(old)
    assert overlaps[0] == 0 and total[0] == 400
    assert sorted(r for _, r in results) == list(range(8))


def test_threaded_continues_past_an_exception():
    seen = []
    lock = threading.Lock()

    def scene(s, gate):
        if s == "bad":
            raise ValueError("scene bad failed")
        with gate, lock:
            seen.append(s)
        return s.upper()

    results = dict(scheduler.run_scenes_threaded(
        scene, ["a", "bad", "c", "d"], workers=2))
    assert sorted(seen) == ["a", "c", "d"]
    assert isinstance(results["bad"], ValueError)
    assert [results[k] for k in "acd"] == ["A", "C", "D"]


def test_shard_scenes_reads_torchrun_environment(monkeypatch):
    scenes = list(range(7))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    assert scheduler.shard_scenes(scenes) == [1, 4]
    assert scheduler.shard_scenes(scenes, host_index=2) == [2, 5]
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    assert scheduler.shard_scenes(scenes) == scenes
