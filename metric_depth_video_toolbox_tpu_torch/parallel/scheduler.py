"""Scene-level fan-out (PyTorch port of ``parallel/scheduler.py``).

The unit of work is a scene, as in the reference's ``--parallel``
subprocess pool:

  - ``run_scenes_threaded``: a host thread pool, so that the video decode
    and encode of one scene overlap the device work of another; a
    :class:`DeviceGate` serialises the device sections a scene function
    marks with ``with gate:``. The movie's step 5 renders its scenes so.
  - ``shard_scenes``: the deterministic scene -> process assignment of a
    run over several processes or hosts (each takes the scenes whose index
    % count == its index; outputs land on a shared filesystem, and resume
    by existence makes an overlap harmless).
  - ``run_scenes_processes``: the reference's Popen pool, for host-bound
    work.

Failures follow the reference: a scene's exception is caught and reported,
and the other scenes go on.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import subprocess
import threading
import traceback


class DeviceGate:
    """Serialises device sections across worker threads (a lock usable as
    ``with gate:``)."""

    def __init__(self):
        self._lock = threading.Lock()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()


def run_scenes_threaded(scene_fn, scenes, workers=2, gate=None):
    """Run ``scene_fn(scene, gate)`` over ``scenes`` on ``workers``
    threads. A scene's exception is printed and returned in its place; the
    other scenes go on. Returns ``[(scene, result or exception)]`` in the
    order the scenes finished."""
    gate = gate or DeviceGate()
    results = []
    lock = threading.Lock()

    def work(scene):
        try:
            out = scene_fn(scene, gate)
        except Exception as e:  # noqa: BLE001 - continue past a failed scene
            traceback.print_exc()
            out = e
        with lock:
            results.append((scene, out))

    with cf.ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(work, scenes))
    return results


def _process_group():
    """(index, count) of this process: the initialised
    ``torch.distributed`` group's rank and world size, else the ``RANK`` /
    ``WORLD_SIZE`` that ``torchrun`` sets, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)))


def shard_scenes(scenes, host_index=None, host_count=None):
    """The scenes of this process in a run over ``host_count`` processes:
    every ``host_count``-th scene from ``host_index``. Defaults from
    :func:`_process_group`, so the same movie command run by every
    process divides the work."""
    if host_index is None or host_count is None:
        index, count = _process_group()
        host_index = index if host_index is None else host_index
        host_count = count if host_count is None else host_count
    return [s for i, s in enumerate(scenes) if i % host_count == host_index]


def run_scenes_processes(cmd_for_scene, scenes, parallel=None):
    """Popen fan-out: ``cmd_for_scene(scene)`` returns an argv list; at
    most ``parallel`` (default half the CPUs) run at once. Returns the
    scenes whose command failed."""
    parallel = parallel or max(1, (os.cpu_count() or 2) // 2)
    pending = list(scenes)
    running = []  # (proc, scene)
    failed = []
    while pending or running:
        while pending and len(running) < parallel:
            scene = pending.pop(0)
            running.append((subprocess.Popen(cmd_for_scene(scene)), scene))
        done_i = None
        for i, (proc, scene) in enumerate(running):
            rc = proc.poll()
            if rc is not None:
                if rc != 0:
                    failed.append(scene)
                done_i = i
                break
        if done_i is not None:
            running.pop(done_i)
        elif running:
            running[0][0].wait()
    return failed
