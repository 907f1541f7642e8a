"""``mdvt-torch view --render`` (``pipeline/view.py``) against the JAX
package's jitted ``render_novel_view_video``, file to file.

Budget, uint8 bytes of the rendered video: at most 1% differing, at most
0.1% by more than 1 (XLA fuses the colour's divide and scale; measured at
48 x 64: <= 0.61% by 1, none by more). The frustum lines of
``show_camera`` are drawn on the host from float32 corners that may round
1 ulp apart (``tests/test_torch_rasterize.py``), within the same budget.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from metric_depth_video_toolbox_tpu.cli import view_depthfile as jcli
from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.pipeline import view as jview
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.cli import view_depthfile as tcli
from metric_depth_video_toolbox_tpu_torch.io import pointcloud as tpc
from metric_depth_video_toolbox_tpu_torch.io import sidecar as tside
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.pipeline import view as tview
from port_helpers import _one_torch_thread  # noqa: F401

H, W = 48, 64
LINE = np.array([255, 60, 60], np.uint8)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("view")
    rng = np.random.default_rng(9)
    yy = np.linspace(0, 1, H)[:, None]
    depth = np.tile(4 + 30 * yy, (5, 1, W)).astype(np.float32).reshape(
        5, H, W)
    depth[:, 10:30, 10:30] = 2.0
    depth *= 1 + 0.01 * rng.standard_normal((5, H, W)).astype(np.float32)
    mask = np.zeros((5, H, W, 3), np.uint8)
    mask[:, 10:30, 20:40] = 255
    paths = {"depth": str(d / "clip_depth.mkv"), "color": str(d / "clip.mkv"),
             "mask": str(d / "clip_mask.mkv"),
             "tf": str(d / "clip_transformations.json")}
    tvio.save_depth_video(depth, paths["depth"], 24, 100.0)
    tvio.save_rgb_video(rng.integers(0, 255, (5, H, W, 3), np.uint8),
                        paths["color"], 24)
    tvio.save_rgb_video(mask, paths["mask"], 24)
    tside.save_transformations(paths["tf"], [
        np.asarray(jgeo.rotation_y(0.01 * i)
                   @ jgeo.translation_matrix(0.004 * i, 0.0, -0.01 * i))
        for i in range(5)])
    return paths


def read(path):
    with tvio.VideoReader(path) as r:
        return r.read_all()


# case -> render_novel_view_video arguments
CASES = {
    "look_at": {"camera_pos": (0.05, 0.0, 0.0), "look_at_target": (0, 0, 5)},
    "pointcloud": {"camera_pos": (0.05, 0.0, 0.0),
                   "look_at_target": (0, 0, 5), "as_pointcloud": True},
    "mask_camera_path": {"camera_pos": (0.02, 0.01, -0.1),
                         "mask_video": "mask", "invert_mask": True,
                         "transformations": "tf",
                         "transformation_lock_frame": 1},
    "draw_frame_show_camera": {"camera_pos": (0.0, 0.0, -1.0),
                               "show_camera": True, "draw_frame": 3},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_novel_view_video_matches_jax(clip, tmp_path, case):
    kw = dict(CASES[case])
    if "mask_video" in kw:
        kw["mask_video"] = clip["mask"]
    if "transformations" in kw:
        kw["transformations"] = tside.load_transformations(clip["tf"])
    out = {}
    for name, mod in (("jax", jview), ("torch", tview)):
        path = mod.render_novel_view_video(
            clip["depth"], color_video=clip["color"],
            output=str(tmp_path / f"{name}.mkv"), batch_size=2, **kw,
            **({"device": "cpu"} if name == "torch" else {}))
        out[name] = read(path)
    got, want = out["torch"], out["jax"]
    assert got.shape == ((1, H, W, 3) if "draw_frame" in kw
                         else (5, H, W, 3))
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d > 0).mean() <= 0.01 and (d > 1).mean() <= 0.001
    assert got.mean() > 5
    if kw.get("show_camera"):
        assert (got == LINE).all(-1).sum() > 20
    if kw.get("mask_video"):
        # the inverted mask blacks out the subject (13% of the frame)
        assert (got.max(-1) == 0).mean() > 0.08


def test_background_ply_is_read_and_not_drawn(clip, tmp_path):
    """As in the JAX package, ``background_ply`` is read (a missing file
    raises) and the render is the same as without it."""
    ply = str(tmp_path / "bg.ply")
    tpc.write_ply(ply, np.random.default_rng(0).normal(size=(50, 3)))
    base = read(tview.render_novel_view_video(
        clip["depth"], output=str(tmp_path / "a.mkv"), device="cpu",
        max_frames=2))
    with_ply = read(tview.render_novel_view_video(
        clip["depth"], output=str(tmp_path / "b.mkv"), device="cpu",
        background_ply=ply, max_frames=2))
    np.testing.assert_array_equal(with_ply, base)
    with pytest.raises(FileNotFoundError):
        tview.render_novel_view_video(clip["depth"], device="cpu",
                                      background_ply=str(tmp_path / "no.ply"))


def test_remove_edges_is_ignored_like_jax(clip, tmp_path):
    """As in the JAX package, ``remove_edges`` is accepted and not used:
    the surface render always culls edges."""
    out = [read(tview.render_novel_view_video(
        clip["depth"], output=str(tmp_path / f"{flag}.mkv"), device="cpu",
        camera_pos=(0.1, 0.0, 0.0), remove_edges=flag, max_frames=2))
        for flag in (False, True)]
    np.testing.assert_array_equal(out[0], out[1])
    assert (out[0].max(-1) == 0).mean() > 0.001     # the culled edges


def test_view_camera_flips_look_at_like_jax():
    for target in (None, (0.2, -0.1, 4.0)):
        got = tview.view_camera((0.1, 0.2, -0.3), target)
        if target is None:
            want = np.eye(4, dtype=np.float32)
            want[:3, 3] = [-0.1, -0.2, 0.3]
        else:
            want = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32) @ \
                np.asarray(jgeo.look_at(jnp.asarray((0.1, 0.2, -0.3)),
                                        jnp.asarray(target, jnp.float32),
                                        jnp.asarray((0.0, -1.0, 0.0))))
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=2.4e-7)
    # looking at a point straight ahead is the identity rotation
    cam = tview.view_camera((0.0, 0.0, 0.0), (0.0, 0.0, 5.0))
    np.testing.assert_allclose(cam, np.eye(4), atol=1e-7)


def test_view_cli_renders_and_matches_reference_flags(clip, monkeypatch):
    """``mdvt-torch view --render`` writes ``<depth>_render.mkv``; the
    parser has every flag and default of the JAX package's."""
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    tmain.main(["view", "--depth_video", clip["depth"], "--color_video",
                clip["color"], "--x", "0.05", "--tx", "0", "--ty", "0",
                "--tz", "5", "--render", "--max_frames", "2"])
    assert read(clip["depth"] + "_render.mkv").shape == (2, H, W, 3)

    def flags(p):
        return sorted((tuple(a.option_strings), a.dest, a.default, a.type,
                       a.required, a.const) for a in p._actions)
    assert flags(tcli.build_parser()) == flags(jcli.build_parser())


def test_view_without_render_serves_the_viewer(clip, monkeypatch):
    """``mdvt-torch view`` without ``--render`` serves the interactive
    viewer (it raised naming ROADMAP A15 before the viewer was ported):
    the server answers ``/api/meta`` and a frame, then an interrupt ends
    ``serve``, which closes its source."""
    import json
    import threading
    import urllib.request

    from metric_depth_video_toolbox_tpu_torch.pipeline import viewer

    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    got = {}
    real = viewer.ThreadingHTTPServer.serve_forever

    def serve_forever(srv):
        t = threading.Thread(target=real, args=(srv,), daemon=True)
        t.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(url + "/api/meta", timeout=60) as r:
            got["meta"] = json.loads(r.read())
        with urllib.request.urlopen(url + "/frame/1", timeout=60) as r:
            got["frame"] = r.read()
        srv.shutdown()
        t.join(30)
        got["stopped"] = not t.is_alive()
        raise KeyboardInterrupt
    monkeypatch.setattr(viewer.ThreadingHTTPServer, "serve_forever",
                        serve_forever)
    tmain.main(["view", "--depth_video", clip["depth"], "--color_video",
                clip["color"], "--port", "0", "--max_frames", "3"])
    assert got["meta"]["frames"] == 3 and got["meta"]["grid"] == [H, W]
    assert got["frame"][:4] == (0x4D445654).to_bytes(4, "little")
    assert len(got["frame"]) == 32 + H * W * 9 + 96
    assert got["stopped"]
