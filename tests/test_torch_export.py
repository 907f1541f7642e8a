"""``export``, ``analyse-depth`` and ``analyse-tracking`` against the JAX
package, file to file, on ``port_helpers.tracked_scene`` (10 frames at 48 x
64, a camera moving along x and turning, 60 tracked points).

Tolerances: grayscale frames, OBJ faces, PLY colors, point counts, cut
events and moving ids exact; per-frame PLY points and OBJ vertices within
1e-5 (float32 unprojection and transforms, rounded differently); the
triangulated and averaged clouds within 1e-4 of the largest coordinate
(a 3x3 solve per track; at this scene's 2.25 m baseline both packages
are ~5e-4 m from a float64 solve); normals on the same cloud equal within
1e-5 with the view directions the export uses, and end to end within 1e-3
(a 16-point neighbourhood's plane turns with the clouds' difference); the
rescaled depth video within one code of the codec; the
camera track within 1e-6; the turntable video within the stereo paths'
file-to-file budget (at most 1% of bytes differing, 0.1% by more than 1).
"""

import json
import os

import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.cli import analyse_tracking as jat_cli
from metric_depth_video_toolbox_tpu.cli import convert_depth_format as jcli
from metric_depth_video_toolbox_tpu.io import video as jvio
from metric_depth_video_toolbox_tpu.pipeline import analyse as jan
from metric_depth_video_toolbox_tpu.pipeline import export as jex
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.io import pointcloud as tpc
from metric_depth_video_toolbox_tpu_torch.io import sidecar as tside
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.ops import knn as tknn
from metric_depth_video_toolbox_tpu_torch.pipeline import analyse as tan
from metric_depth_video_toolbox_tpu_torch.pipeline import export as tex
from port_helpers import _one_torch_thread, tracked_scene  # noqa: F401

pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return tracked_scene(str(tmp_path_factory.mktemp("export")))


def _configs(s):
    tracks, tf = s["tracking.json"], s["transforms.json"]
    return {
        # color, per-frame PLY and OBJ (edges culled), 8-bit gray,
        # per-frame rescale, normals
        "color": dict(tracking_file=tracks, transformation_file=tf,
                      color_video=s["color.mkv"], xfov=60.0,
                      triangulate=True, min_observations=4,
                      save_rescaled_depth=True, grayscale=True,
                      save_ply_every=4, save_obj_every=5, remove_edges=True,
                      save_normals=True),
        # 16-bit gray, the global rescale, merged points, the strict mask
        # filter, lock frame 3, frames 0 and 1 skipped, yfov only, OBJ
        # without the edge cull
        "global": dict(tracking_file=tracks, transformation_file=tf,
                       yfov=40.0, triangulate=True, min_observations=4,
                       save_rescaled_depth=True, global_align=True,
                       grayscale=True, bit16_grayscale=True,
                       merge_close_points=True, mask_video=s["mask.mkv"],
                       strict_mask=True, lock_frame=3, min_frames=1,
                       save_ply_every=3, save_obj_every=4,
                       remove_edges=False),
        # the default 50 degree FOV, the mask filter not strict, 8
        # frames, normals
        "default_fov": dict(tracking_file=tracks, transformation_file=tf,
                            mask_video=s["mask.mkv"], triangulate=True,
                            min_observations=3, max_frames=8,
                            save_normals=True),
    }


@pytest.fixture(scope="module")
def exports(scene, tmp_path_factory):
    """Each configuration through both packages' ``export_video``."""
    root = str(tmp_path_factory.mktemp("exports"))
    out = {}
    for name, kw in _configs(scene).items():
        j = jex.export_video(scene["depth.mkv"],
                             output_prefix=os.path.join(root, "jax_" + name),
                             **kw)
        t = tex.export_video(scene["depth.mkv"],
                             output_prefix=os.path.join(root,
                                                        "torch_" + name),
                             device="cpu", **kw)
        out[name] = (j, t)
    return out


def _frames(path):
    with tvio.VideoReader(path) as r:
        return r.read_all()


def _code(rgb):
    return rgb[..., 0].astype(np.int64) * 256 + rgb[..., 2]


def test_outputs_are_the_same_kinds(exports):
    for name, (j, t) in exports.items():
        assert sorted(j) == sorted(t), name
        for key in ("ply_frames", "obj_frames"):
            assert [os.path.basename(p)[-16:] for p in j.get(key, [])] == [
                os.path.basename(p)[-16:] for p in t.get(key, [])]


@pytest.mark.parametrize("name", ["color", "global"])
def test_grayscale_frames_exact(exports, name):
    j, t = exports[name]
    assert t["grayscale"].endswith("_grayscale16.mkv" if name == "global"
                                   else "_grayscale.mkv")
    got, want = _frames(t["grayscale"]), _frames(j["grayscale"])
    assert got.shape == want.shape and got.shape[0] in (8, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["color", "global"])
def test_ply_frames_match(exports, name):
    j, t = exports[name]
    assert len(t["ply_frames"]) >= 3
    for jp, tp in zip(j["ply_frames"], t["ply_frames"]):
        (jpts, jcol), (tpts, tcol) = tpc.read_ply(jp), tpc.read_ply(tp)
        assert tpts.shape == jpts.shape == (48 * 64, 3)
        np.testing.assert_allclose(tpts, jpts, rtol=1e-5, atol=1e-5)
        if name == "color":
            np.testing.assert_array_equal(tcol, jcol)
        else:
            assert tcol is None and jcol is None


def _read_obj(path):
    verts, faces = [], []
    with open(path, encoding="ascii") as f:
        for line in f:
            tag, *vals = line.split()
            (verts if tag == "v" else faces).append(vals)
    return (np.asarray(verts, np.float64),
            np.asarray(faces, np.int64))


@pytest.mark.parametrize("name", ["color", "global"])
def test_obj_frames_match(exports, name):
    j, t = exports[name]
    assert len(t["obj_frames"]) >= 2
    for jp, tp in zip(j["obj_frames"], t["obj_frames"]):
        (jv, jf), (tv, tf) = _read_obj(jp), _read_obj(tp)
        np.testing.assert_array_equal(tf, jf)
        assert tv.shape == jv.shape == (48 * 64, 6 if name == "color" else 3)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=2e-6)
    if name == "color":   # the edge cull drops faces
        assert len(tf) < 2 * 47 * 63


@pytest.mark.parametrize("name", ["color", "global", "default_fov"])
@pytest.mark.parametrize("cloud", ["triangulated", "avgmonodepth"])
def test_clouds_match(exports, scene, name, cloud):
    j, t = exports[name]
    (jp, jc, jn), (tp, tc, tn) = (tpc.read_ply(j[cloud], return_normals=True),
                                  tpc.read_ply(t[cloud], return_normals=True))
    assert tp.shape == jp.shape and tp.shape[0] >= 20
    assert tc is None and jc is None
    np.testing.assert_allclose(tp, jp, atol=1e-4 * np.abs(jp).max())
    if name == "global":
        assert tn is None and jn is None
    else:
        assert tn is not None and jn is not None
        np.testing.assert_allclose(np.linalg.norm(tn, axis=1), 1.0,
                                   atol=1e-5)
        # on the JAX package's own cloud, the port's normals are its normals
        vd = jp - scene["transforms"][0][:3, 3]
        vd = vd / np.maximum(np.linalg.norm(vd, axis=1, keepdims=True), 1e-9)
        same_cloud = tknn.knn_normals(
            torch.from_numpy(jp), k=min(16, len(jp) - 1),
            view_dirs=torch.from_numpy(vd.astype(np.float32))).numpy()
        np.testing.assert_allclose(same_cloud, jn, atol=1e-5)
        # end to end the clouds differ (above), and a 16-point
        # neighbourhood's plane turns by about that over its spread
        np.testing.assert_allclose(tn, jn, atol=1e-3)


def test_triangulation_recovers_the_scene(exports, scene):
    """The triangulated points land on the scene's points (the mono depth
    is 10% off, the rays are not)."""
    _, t = exports["color"]
    pts, _ = tpc.read_ply(t["triangulated"])
    d = np.linalg.norm(pts[:, None] - scene["world"][None], axis=-1).min(1)
    assert np.median(d) < 0.05


@pytest.mark.parametrize("name", ["color", "global"])
def test_rescaled_depth_within_one_code(exports, name):
    j, t = exports[name]
    got, want = _frames(t["rescaled"]), _frames(j["rescaled"])
    assert got.shape == want.shape
    assert np.abs(_code(got) - _code(want)).max() <= 1
    np.testing.assert_array_equal(got[..., 0], got[..., 1])


def test_min_frames_and_lock_frame(exports, scene, tmp_path):
    """``min_frames`` 1 skips frames 0 and 1; ``lock_frame`` 0 leaves the
    poses as they are, 3 re-bases them on frame 3 (each pose times the
    inverse of frame 3's, as in the JAX package)."""
    _, t = exports["global"]
    assert [p[-10:] for p in t["ply_frames"]] == [
        "000003.ply", "000006.ply", "000009.ply"]
    assert _frames(t["grayscale"]).shape[0] == 8
    kw = dict(tracking_file=scene["tracking.json"],
              transformation_file=scene["transforms.json"], xfov=60.0,
              triangulate=True, min_observations=4, device="cpu")
    plain = tex.export_video(scene["depth.mkv"],
                             output_prefix=str(tmp_path / "a"), **kw)
    zero = tex.export_video(scene["depth.mkv"], lock_frame=0,
                            output_prefix=str(tmp_path / "b"), **kw)
    three = tex.export_video(scene["depth.mkv"], lock_frame=3,
                             output_prefix=str(tmp_path / "c"), **kw)
    p0 = tpc.read_ply(plain["triangulated"])[0]
    np.testing.assert_array_equal(tpc.read_ply(zero["triangulated"])[0], p0)
    p3 = tpc.read_ply(three["triangulated"])[0]
    assert np.abs(p3 - p0).max() > 0.1     # (held against JAX above)


def test_default_fov_is_50_degrees(exports, scene, tmp_path):
    _, t = exports["default_fov"]
    kw = _configs(scene)["default_fov"]
    fifty = tex.export_video(scene["depth.mkv"], xfov=50.0, device="cpu",
                             output_prefix=str(tmp_path / "fifty"), **kw)
    np.testing.assert_array_equal(tpc.read_ply(fifty["triangulated"])[0],
                                  tpc.read_ply(t["triangulated"])[0])


@pytest.mark.parametrize("strict", [False, True])
def test_mask_filter_tracks_exact(scene, strict):
    """Observations on the mask (and the track off the right edge, which
    counts as masked) dropped as the JAX package drops them."""
    dense, _ = tside.tracking_to_dense(tside.load_tracking(
        scene["tracking.json"]))
    got = tex._mask_filter_tracks(dense, scene["mask.mkv"], strict)
    np.testing.assert_array_equal(
        got, jex._mask_filter_tracks(dense, scene["mask.mkv"], strict))
    assert got[2, 0, 2] == 0.0 and dense[2, 0, 2] == 1.0   # off the edge
    assert (got[..., 2] < dense[..., 2]).sum() > (2 if strict else 1)


def test_merge_near_points_exact():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 0.02, (300, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    for colors in (None, cols):
        got = tex.merge_near_points(pts, colors, radius=0.004)
        want = jex.merge_near_points(pts, colors, radius=0.004)
        np.testing.assert_array_equal(got[0], want[0])
        if colors is None:
            assert got[1] is None and want[1] is None
        else:
            np.testing.assert_array_equal(got[1], want[1])
    assert got[0].shape[0] < 300


def test_camera_track_matches_jax(scene, tmp_path):
    pts = scene["world"]
    cols = np.full_like(pts, 200, dtype=np.uint8)
    out = {}
    for name, mod in (("jax", jex), ("torch", tex)):
        out[name] = mod.export_camera_track(
            scene["transforms"], 60.0, 64, 48, 24.0,
            str(tmp_path / name), points=pts, colors=cols)
    assert sorted(out["torch"]) == sorted(out["jax"]) == ["camera_track",
                                                          "cloud"]
    with open(out["torch"]["camera_track"]) as a, \
            open(out["jax"]["camera_track"]) as b:
        got, want = json.load(a), json.load(b)
    frames = np.asarray(got.pop("frames"))
    np.testing.assert_allclose(frames, np.asarray(want.pop("frames")),
                               atol=1e-6)
    assert frames.shape == (10, 4, 4) and got == want
    with open(out["torch"]["cloud"], "rb") as a, \
            open(out["jax"]["cloud"], "rb") as b:
        assert a.read() == b.read()


def test_turntable_within_budget(scene, tmp_path):
    rng = np.random.default_rng(5)
    sets = [(scene["world"], None),
            (scene["world"] + 0.05, rng.integers(0, 256, (60, 3)))]
    kw = dict(out_hw=(40, 56), n_frames=6, fps=24)
    jex.render_point_cloud_video(sets, str(tmp_path / "j.mkv"), **kw)
    tex.render_point_cloud_video(sets, str(tmp_path / "t.mkv"),
                                 device="cpu", **kw)
    got, want = _frames(str(tmp_path / "t.mkv")), _frames(
        str(tmp_path / "j.mkv"))
    assert got.shape == want.shape == (6, 40, 56, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d > 0).mean() <= 0.01 and (d > 1).mean() <= 0.001
    assert (got != 16).any()


def test_export_command_matches_jax(scene, tmp_path, monkeypatch, capsys):
    """``mdvt-torch export`` with the verify drive's flags, plus a PLY
    folder, the turntable and the camera track, against the JAX CLI's
    ``run`` on a copy of the same files."""
    import shutil

    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    files = {}
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        for name in ("depth.mkv", "tracking.json", "transforms.json"):
            shutil.copy(scene[name], d / name)
        files[side] = d
    argv = ["--track_file", "tracking.json", "--xfov", "60",
            "--triangulate", "--min_observations", "3", "--save_grayscale",
            "--transformation_file", "transforms.json",
            "--show_scene_point_clouds", "--save_alembic", "--save_ply",
            "plys", "--max_frames", "6"]

    def argv_in(side):
        d = files[side]
        return ["--depth_video", str(d / "depth.mkv")] + [
            str(d / a) if a in ("tracking.json", "transforms.json", "plys")
            else a for a in argv]
    jcli.run(jcli.build_parser().parse_args(argv_in("jax")))
    tmain.main(["export"] + argv_in("torch"))
    assert "triangulated:" in capsys.readouterr().out
    jd, td = files["jax"], files["torch"]
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    assert sorted(os.listdir(td / "plys")) == sorted(os.listdir(jd / "plys"))
    assert len(os.listdir(td / "plys")) == 6
    np.testing.assert_array_equal(
        _frames(str(td / "depth.mkv_grayscale.mkv")),
        _frames(str(jd / "depth.mkv_grayscale.mkv")))
    got = _frames(str(td / "depth.mkv_clouds.mkv"))
    want = _frames(str(jd / "depth.mkv_clouds.mkv"))
    assert got.shape == want.shape == (72, 480, 640, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d > 0).mean() <= 0.01 and (d > 1).mean() <= 0.001
    for name in ("depth.mkv_triangulated.ply", "depth.mkv_cloud.ply"):
        np.testing.assert_allclose(
            tpc.read_ply(str(td / name))[0], tpc.read_ply(str(jd / name))[0],
            atol=1e-4 * np.abs(tpc.read_ply(str(jd / name))[0]).max())


def _moving_tracks(scene, root):
    """The scene's tracks plus three that slide across the image (the
    camera does not explain them)."""
    frames = tside.load_tracking(scene["tracking.json"])
    out = []
    for fi, rows in enumerate(frames):
        extra = [[900 + i, 5 + 4 * fi + 10 * i, 10 + 12 * i]
                 for i in range(3)]
        out.append(np.concatenate([rows, np.asarray(extra, np.float32)]))
    path = os.path.join(root, "moving_tracking.json")
    tside.save_tracking(path, out)
    return path


@pytest.mark.parametrize("with_mask", [False, True])
def test_analyse_depth_matches_jax(scene, tmp_path, with_mask):
    tracks = _moving_tracks(scene, str(tmp_path))
    kw = dict(transformation_file=scene["transforms.json"], xfov=60.0,
              mask_video=scene["mask.mkv"] if with_mask else None)
    jp, jm = jan.analyse_depth_movement(scene["depth.mkv"], tracks,
                                        output=str(tmp_path / "j.ply"), **kw)
    tp, tm = tan.analyse_depth_movement(scene["depth.mkv"], tracks,
                                        output=str(tmp_path / "t.ply"),
                                        device="cpu", **kw)
    assert tm == jm and {900, 901, 902} <= set(tm)
    (jpts, jcol), (tpts, tcol) = tpc.read_ply(jp), tpc.read_ply(tp)
    np.testing.assert_array_equal(tcol, jcol)
    np.testing.assert_allclose(tpts, jpts, rtol=1e-5, atol=1e-5)


def test_analyse_depth_command(scene, tmp_path, monkeypatch, capsys):
    """``mdvt-torch analyse-depth`` without a pose file or a FOV: identity
    poses and 50 degrees, as in the JAX package."""
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    tracks = _moving_tracks(scene, str(tmp_path))
    jp, jm = jan.analyse_depth_movement(scene["depth.mkv"], tracks,
                                        output=str(tmp_path / "j.ply"))
    tmain.main(["analyse-depth", "--depth_video", scene["depth.mkv"],
                "--track_file", tracks])
    out = capsys.readouterr().out
    assert f"moving tracks: {jm}" in out
    tp = scene["depth.mkv"] + "_movement.ply"
    np.testing.assert_allclose(tpc.read_ply(tp)[0], tpc.read_ply(jp)[0],
                               rtol=1e-5, atol=1e-5)
    os.remove(tp)


def _cut_tracks(path):
    """Frames 0-5 share 600 ids, frames 6-11 another 600: one cut."""
    frames = []
    for fi in range(12):
        base = 0 if fi < 6 else 1000
        ids = np.arange(base, base + 600)
        frames.append(np.stack([ids, ids % 40 + fi, ids // 40 + 0.5],
                               -1).astype(np.float32))
    tside.save_tracking(path, frames)


@pytest.mark.parametrize("fps", ["0.1", "video"])
def test_analyse_tracking_cuts_exact(tmp_path, capsys, fps):
    """``mdvt-torch analyse-tracking``: at 0.1 fps the cut is past the 27 s
    start, so it starts at frame 5 and ends at frame 6; at the colour
    video's 24 fps it is too early to count."""
    path = str(tmp_path / "cuts.json")
    _cut_tracks(path)
    argv = ["--track_file", path]
    if fps == "video":
        clip = str(tmp_path / "c.mkv")
        jvio.save_rgb_video(np.zeros((2, 8, 8, 3), np.uint8), clip, 24)
        argv += ["--color_video", clip]
    else:
        argv += ["--fps", fps]
    want = jat_cli.run(jat_cli.build_parser().parse_args(argv))
    capsys.readouterr()
    tmain.main(["analyse-tracking"] + argv)
    out = capsys.readouterr().out
    got = tan.detect_cuts_from_tracking(path, fps=0.1 if fps == "0.1"
                                        else 24.0)
    assert got == want
    assert got == ([(5, "cut_start"), (6, "cut_end")] if fps == "0.1"
                   else [])
    assert out.count("--- frame") == len(want)
