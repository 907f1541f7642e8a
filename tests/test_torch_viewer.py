"""The interactive viewer (``pipeline/viewer.py``, ``view`` without
``--render``) against the JAX package's: both packages' ``serve_background``
on the same clip, answering the same requests.

``/api/meta`` and ``/`` equal; ``/background`` equal; out-of-range frames
404 and malformed ones 400 in both; each ``/frame/n`` by this rule: the
header's magic and grid, the validity marks and the colors exact; the
positions, float32 points quantized to u16 against the frame's bbox, within
one code (a 1-ulp difference of a point or of the bbox can move a code by
one); the bbox and the frustum's corners within 1e-5 relative.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from metric_depth_video_toolbox_tpu.cli import view_depthfile as jcli
from metric_depth_video_toolbox_tpu.pipeline import viewer as jviewer
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.io import pointcloud as tpc
from metric_depth_video_toolbox_tpu_torch.io import sidecar as tside
from metric_depth_video_toolbox_tpu_torch.pipeline import viewer as tviewer
from port_helpers import _one_torch_thread, tracked_scene  # noqa: F401

pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    s = tracked_scene(str(tmp_path_factory.mktemp("viewer")))
    s["background.ply"] = os.path.join(os.path.dirname(s["depth.mkv"]),
                                       "background.ply")
    rng = np.random.default_rng(3)
    tpc.write_ply(s["background.ply"], s["world"],
                  rng.integers(0, 256, s["world"].shape).astype(np.uint8))
    return s


def _configs(s):
    tf = tside.load_transformations(s["transforms.json"])
    return {
        "color": (dict(color_video=s["color.mkv"]),
                  dict(xfov=60.0, remove_edges=True, max_points=1000)),
        "mask": (dict(background_ply=s["background.ply"]),
                 dict(mask_video=s["mask.mkv"], yfov=45.0,
                      transformations=tf, transformation_lock_frame=3)),
        "mask_inverted": (dict(color_video=s["color.mkv"]),
                          dict(mask_video=s["mask.mkv"], invert_mask=True,
                               transformations=tf, remove_edges=False,
                               max_points=700, max_frames=6)),
    }


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, None


@pytest.fixture(scope="module", params=["color", "mask", "mask_inverted"])
def servers(request, scene):
    """Both packages' viewers on one configuration -> (JAX's port, the
    port's port, the frame count); shut down after the module."""
    serve_kw, source_kw = _configs(scene)[request.param]
    jsrv, jsrc, jport = jviewer.serve_background(scene["depth.mkv"],
                                                 **serve_kw, **source_kw)
    tsrv, tsrc, tport = tviewer.serve_background(scene["depth.mkv"],
                                                 device="cpu", **serve_kw,
                                                 **source_kw)
    yield jport, tport, request.param
    for srv, src in ((jsrv, jsrc), (tsrv, tsrc)):
        srv.shutdown()
        srv.server_close()
        src.close()


def test_meta_page_and_errors_match(servers):
    jport, tport, _ = servers
    for path in ("/", "/api/meta"):
        assert _get(tport, path) == _get(jport, path)
    meta = json.loads(_get(tport, "/api/meta")[1])
    for path in (f"/frame/{meta['frames']}", "/frame/-1", "/frame/x",
                 "/nothing"):
        code = _get(tport, path)[0]
        assert code == _get(jport, path)[0] and code in (400, 404)
    assert _get(tport, "/background") == _get(jport, "/background")


def test_frames_match(servers):
    jport, tport, name = servers
    meta = json.loads(_get(tport, "/api/meta")[1])
    valid_share = []
    for n in list(range(meta["frames"])) + [1]:     # 1 again: the cache
        (th, tbox, tq, tcol, tfr), (jh, jbox, jq, jcol, jfr) = (
            tviewer.unpack_frame(_get(tport, f"/frame/{n}")[1]),
            tviewer.unpack_frame(_get(jport, f"/frame/{n}")[1]))
        assert th == jh and th[0] == tviewer.MAGIC
        assert list(th[1:]) == meta["grid"]
        tv, jv = tq[..., 2] != tviewer.INVALID, jq[..., 2] != tviewer.INVALID
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tq[~tv], jq[~jv])
        np.testing.assert_array_equal(tcol, jcol)
        if tv.any():
            assert np.abs(tq[tv].astype(int) - jq[jv].astype(int)).max() <= 1
        np.testing.assert_allclose(tbox, jbox, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tfr, jfr, rtol=1e-5, atol=1e-6)
        valid_share.append(tv.mean())
    # the mask removes points in frames 3 and 4, or keeps only those (the
    # other frames then have no valid point and a bbox of the origin)
    assert min(valid_share) < max(valid_share) <= 1
    if name == "mask_inverted":
        assert valid_share[0] == 0 and valid_share[3] > 0
    else:
        assert min(valid_share) > 0


def test_view_without_render_reaches_serve_like_jax(scene, monkeypatch):
    """``mdvt-torch view`` without ``--render`` calls the port's
    ``viewer.serve`` with the arguments the JAX CLI gives the JAX
    package's (and the device)."""
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    calls = {}
    monkeypatch.setattr(jviewer, "serve",
                        lambda *a, **kw: calls.setdefault("jax", (a, kw)))
    monkeypatch.setattr(tviewer, "serve",
                        lambda *a, **kw: calls.setdefault("torch", (a, kw)))
    argv = ["--depth_video", scene["depth.mkv"], "--color_video",
            scene["color.mkv"], "--mask_video", scene["mask.mkv"],
            "--invert_mask", "--transformation_file", scene["transforms.json"],
            "--transformation_lock_frame", "2", "--background_ply",
            scene["background.ply"], "--remove_edges", "--port", "8200",
            "--viewer_max_points", "5000", "--max_frames", "4", "--xfov",
            "70", "--max_depth", "50"]
    jcli.run(jcli.build_parser().parse_args(argv))
    tmain.main(["view"] + argv)
    (ja, jkw), (ta, tkw) = calls["jax"], calls["torch"]
    assert ta == ja
    assert tkw.pop("device") is None      # resolved by the FrameSource
    np.testing.assert_array_equal(tkw.pop("transformations"),
                                  jkw.pop("transformations"))
    assert tkw == jkw
