"""The web project GUI (``pipeline/gui.py``, ``mdvt-torch gui``) against the
JAX package's: both packages' ``serve_background`` on the same project,
answering the same requests with the same bytes (``/``, ``/api/status``,
``/api/scene_files``, ``/api/logs``, the JPEG frames and the MJPEG stream
from the same OpenCV), writing the same project files on ``/api/set`` and
``/api/split``, refusing the same paths; ``/api/run`` reaches
``run_project`` with the same arguments (monkeypatched in both)."""

import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from metric_depth_video_toolbox_tpu.cli import gui as jgui_cli
from metric_depth_video_toolbox_tpu.pipeline import gui as jgui
from metric_depth_video_toolbox_tpu.pipeline import project as jproject
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.pipeline import gui as tgui
from metric_depth_video_toolbox_tpu_torch.pipeline import project as tproject
from port_helpers import _one_torch_thread  # noqa: F401

pytest.importorskip("cv2")


def _clip(root):
    """16 frames with a hard cut after 8 (one scene for the detector,
    whose scenes are at least 15 frames long)."""
    a = np.full((8, 24, 32, 3), 30, np.uint8)
    b = np.full((8, 24, 32, 3), 220, np.uint8)
    b[..., 0] = 10
    path = os.path.join(root, "movie.mkv")
    tvio.save_rgb_video(np.concatenate([a, b]), path, 24)
    return path


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A project made by each package from the same clip (the files are
    equal), and a scene clip in the JAX one for the player."""
    root = str(tmp_path_factory.mktemp("gui"))
    clip = _clip(root)
    dirs = {}
    for name, mod in (("jax", jproject), ("torch", tproject)):
        dirs[name] = os.path.join(root, name)
        mod.create_project(dirs[name], clip, depth_engine="vda")
    frames = np.zeros((6, 24, 32, 3), np.uint8)
    for i in range(6):
        frames[i, :, :4 + 4 * i] = (40 * (i + 1)) % 255
    tvio.save_rgb_video(frames, os.path.join(dirs["jax"], "scene_1.mkv"), 24)
    return dirs


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith((".json", ".csv")):
            with open(os.path.join(d, name), "rb") as f:
                out[name] = f.read()
    return out


def _req(port, path, data=None, raw=False):
    body = json.dumps(data).encode() if data is not None else None
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    data=body, timeout=30) as r:
            out = r.read()
            return r.status, (out if raw else json.loads(out))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def servers(project):
    """Both packages' GUIs on the JAX package's project directory."""
    jsrv, jstate, jport = jgui.serve_background(project["jax"])
    tsrv, tstate, tport = tgui.serve_background(project["jax"],
                                                device="cpu")
    yield (jport, jstate), (tport, tstate)
    for srv, state in ((jsrv, jstate), (tsrv, tstate)):
        srv.shutdown()
        srv.server_close()
        state.player.close()


def test_projects_are_the_same_files(project):
    j, t = _files(project["jax"]), _files(project["torch"])
    assert sorted(j) == sorted(t) == ["movie-Scenes.csv",
                                      "project_config.json"]
    assert j == t


def test_page_status_logs_and_scene_files_match(servers):
    (jport, _), (tport, _) = servers
    for path in ("/", "/api/status", "/api/logs?start=0",
                 "/api/scene_files?scene=1", "/api/scene_files?scene=99",
                 "/nothing"):
        got, want = _req(tport, path, raw=path == "/"), _req(
            jport, path, raw=path == "/")
        assert got == want, path
    status = _req(tport, "/api/status")[1]
    assert len(status["scenes"]) == 1 and status["running"] is False
    files = _req(tport, "/api/scene_files?scene=1")[1]
    assert files["files"] == {"clip": "scene_1.mkv"}
    assert files["meta"]["clip"]["frames"] == 6


def test_player_frames_stream_and_path_guard_match(servers, project):
    (jport, jstate), (tport, tstate) = servers
    for i in (3, 0, 1, 9):          # a seek, a rewind, a read, past the end
        path = f"/video/frame?f=scene_1.mkv&i={i}"
        got, want = _req(tport, path, raw=True), _req(jport, path, raw=True)
        assert got == want and got[0] == 200 and got[1][:2] == b"\xff\xd8"
    heads = []
    for port in (jport, tport):
        r = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/video/stream?f=scene_1.mkv&start=2",
            timeout=30)
        assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
        heads.append(r.read(2048))
        r.close()
    assert heads[0] == heads[1] and b"X-Frame-Index: 2" in heads[1]
    for path in ("/video/frame?f=../movie.mkv", "/video/stream?f=../x.mkv",
                 "/video/frame?f=nothing.mkv"):
        got, want = _req(tport, path), _req(jport, path)
        assert got[0] == want[0] == 404 and "error" in got[1]
    assert got == want
    with pytest.raises(PermissionError):
        tstate.safe_path("../movie.mkv")
    assert tstate.safe_path("scene_1.mkv") == jstate.safe_path("scene_1.mkv")


def test_set_and_split_write_the_same_files(project, tmp_path):
    """``/api/set`` and ``/api/split`` (and a bad request) on a copy of the
    project each, through each package's GUI: the same answers and the
    same project files."""
    answers, dirs = {}, {}
    for name, mod in (("jax", jgui), ("torch", tgui)):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(project["jax"], dirs[name])
        kw = {} if name == "jax" else {"device": "cpu"}
        srv, _, port = mod.serve_background(dirs[name], **kw)
        try:
            answers[name] = [
                _req(port, "/api/set", {"scene": 2, "column": "Engine",
                                        "value": "da3"}),
                _req(port, "/api/split", {"scene": 1, "at_frame": 3}),
                _req(port, "/api/set", {"scene": 999, "column": "Engine",
                                        "value": "x"}),
                _req(port, "/api/nothing", {}),
                _req(port, "/api/status")[1]["scenes"]]
        finally:
            srv.shutdown()
            srv.server_close()
    assert answers["torch"] == answers["jax"]
    assert len(answers["torch"][-1]) == 2       # the one scene split
    assert answers["torch"][2][0] == 400
    assert _files(dirs["torch"]) == _files(dirs["jax"])


def test_log_buffer_like_jax():
    bufs = [jgui._LogBuffer(max_lines=4), tgui._LogBuffer(max_lines=4)]
    tails = []
    for buf in bufs:
        out = []
        for s in ("a\nb\nc\n", "d\ne\nf\n", "partial", " done\n", "x"):
            buf.write(s)
            out.append(buf.tail(0))
        out.append(buf.tail(2))
        tails.append(out)
    assert tails[0] == tails[1]
    assert tails[1][-2:] == [(["d", "e", "f", "partial done"], 4),
                             (["f", "partial done"], 4)]


def _wait_idle(port):
    for _ in range(600):
        status = _req(port, "/api/status")[1]
        if not status["running"]:
            return status
        time.sleep(0.05)
    raise AssertionError("the run did not end")


@pytest.mark.parametrize("fails", [False, True])
def test_run_reaches_run_project_like_jax(project, monkeypatch, fails):
    """POST ``/api/run`` runs ``project.run_project`` on the worker thread
    with the project and ``end_scene`` (the port adds the device); its
    output reaches the log; a failure is reported, not lost."""
    calls = {}
    for name, mod in (("jax", jproject), ("torch", tproject)):
        def fake(proj, end_scene=-1, _name=name, **kw):
            calls[_name] = (proj.root, proj.config, end_scene, kw)
            print(f"running {os.path.basename(proj.root)}")
            if fails:
                raise RuntimeError("no card")
        monkeypatch.setattr(mod, "run_project", fake)
    logs, statuses = {}, {}
    for name, mod in (("jax", jgui), ("torch", tgui)):
        kw = {} if name == "jax" else {"device": "cpu"}
        srv, state, port = mod.serve_background(project["jax"], **kw)
        try:
            assert _req(port, "/api/run", {"end_scene": 1}) == (
                200, {"started": True})
            statuses[name] = _wait_idle(port)
            state.worker.join(30)
            assert not state.worker.is_alive()
            logs[name] = _req(port, "/api/logs?start=0")[1]
        finally:
            srv.shutdown()
            srv.server_close()
    assert logs["torch"] == logs["jax"]
    assert statuses["torch"] == statuses["jax"]
    assert calls["torch"][:3] == calls["jax"][:3]
    assert calls["jax"][2] == 1 and calls["jax"][3] == {}
    assert str(calls["torch"][3].pop("device")) == "cpu"
    assert calls["torch"][3] == {}
    want = "[run failed] no card" if fails else "[run finished]"
    assert want in logs["torch"]["lines"]
    assert statuses["torch"]["last_error"] == ("no card" if fails else None)


@pytest.mark.parametrize("with_clip", [True, False])
def test_gui_command_creates_the_project_like_jax(tmp_path, monkeypatch,
                                                  with_clip):
    """``mdvt-torch gui --project_dir DIR --color_video CLIP`` creates the
    project the JAX CLI creates, then serves it; without a clip and a
    project both exit naming ``--color_video``."""
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    clip = _clip(str(tmp_path))
    served = {}
    monkeypatch.setattr(jgui, "serve",
                        lambda d, **kw: served.setdefault("jax", (d, kw)))
    monkeypatch.setattr(tgui, "serve",
                        lambda d, **kw: served.setdefault("torch", (d, kw)))
    dirs = {name: str(tmp_path / name) for name in ("jax", "torch")}
    extra = ["--color_video", clip] if with_clip else []
    if not with_clip:
        with pytest.raises(SystemExit, match="--color_video"):
            jgui_cli.run(jgui_cli.build_parser().parse_args(
                ["--project_dir", dirs["jax"]]))
        with pytest.raises(SystemExit, match="--color_video"):
            tmain.main(["gui", "--project_dir", dirs["torch"]])
        return
    jgui_cli.run(jgui_cli.build_parser().parse_args(
        ["--project_dir", dirs["jax"], "--port", "8300"] + extra))
    tmain.main(["gui", "--project_dir", dirs["torch"], "--port", "8300"]
               + extra)
    assert _files(dirs["torch"]) == _files(dirs["jax"])
    assert served["jax"] == (dirs["jax"], {"port": 8300})
    assert served["torch"] == (dirs["torch"], {"port": 8300,
                                               "device": None})
