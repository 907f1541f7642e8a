"""The general stereo renderer against the JAX package: ``stereo_frame``
under the forward warp, the plane sweep, Touchly0 and Touchly1 (op by op),
and ``render_stereo_video`` file to file under a camera path with a lock
frame, ``render_as_pointcloud``, Touchly0, Touchly1, VR180 and the
background mode (the JAX step jitted).

Budgets, uint8 bytes of the image and infill-mask outputs:
- op by op, the forward warp is bit-exact (``tests/test_torch_rasterize.py``)
  and so are these steps but for the infill-mask normals' filters and
  ``x * 255`` truncation: at most 1 LSB on at most 0.5% of bytes, as the
  sweep path's budget (``tests/test_torch_stereo.py``); the plane sweep's
  JAX loop is compiled (``lax.scan``), so its image may differ by more
  where a fused rounding moves a bilinear tap: bytes off by more than 1 on
  at most 0.5%, the hit mask equal;
- file to file against the jitted JAX step, where XLA's fused rounding may
  move a landing pixel of the forward warp: at most 1% of bytes differing,
  at most 0.1% by more than 1, and the hole masks (any nonzero infill-mask
  byte) disagreeing on at most 0.2% of pixels. Measured at 48 x 64: a
  camera path with a lock frame 0.46% / 0.003% / 0; every other mode
  <= 0.04% / 0 / 0.
"""

import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.ops import codec as jcodec
from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.pipeline import stereo as jst
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.cli import stereo_rerender as tcli
from metric_depth_video_toolbox_tpu_torch.io import sidecar as tside
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.ops import codec as tcodec
from metric_depth_video_toolbox_tpu_torch.pipeline import stereo as tst
from port_helpers import _one_torch_thread  # noqa: F401

H, W = 48, 64


def scene(seed, b=2, h=H, w=W):
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h)[:, None]
    depth = np.tile(4 + 30 * yy, (b, 1, w)).astype(np.float32).reshape(
        b, h, w)
    depth[:, 10:30, 10:30] = 2.0
    depth[:, 25:45, 35:55] = 6.5
    depth *= 1 + 0.01 * rng.standard_normal((b, h, w)).astype(np.float32)
    return depth, rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)


def camera_path(n, seed=0):
    """Per frame a yaw of a few tenths of a degree and a few mm of
    translation."""
    rng = np.random.default_rng(seed)
    out = [np.asarray(jgeo.rotation_y(np.radians(0.3) * rng.normal()))
           @ np.asarray(jgeo.translation_matrix(
               *(0.003 * rng.standard_normal(3)))) for _ in range(n)]
    return np.asarray(out, np.float32)


def diff(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return (d > 0).mean(), (d > 1).mean()


# mode -> (StereoConfig fields, render camera size or None for the source)
FRAME_MODES = {
    "forward": ({"warp_method": "forward"}, None),
    "forward_render_camera": ({"warp_method": "forward", "subsample": 1},
                              (40, 56)),
    "plane_sweep": ({"warp_method": "plane_sweep", "num_planes": 32}, None),
    "touchly0": ({"warp_method": "forward", "touchly0": True}, (40, 40)),
    "touchly1": ({"touchly1": True, "num_planes": 32}, None),
}


@pytest.mark.parametrize("mode", sorted(FRAME_MODES))
def test_stereo_frame_matches_jax(mode):
    fields, render = FRAME_MODES[mode]
    b = 2
    depth, color = scene(3, b)
    rgb = np.asarray(jcodec.encode_depth_frame(jnp.asarray(depth), 100.0))
    k = np.asarray(jgeo.camera_matrix_from_fov(W, H, xfov_deg=60.0),
                   np.float32)
    oh, ow = render or (H, W)
    rk = np.asarray(jgeo.camera_matrix_from_fov(ow, oh, xfov_deg=75.0,
                                                yfov_deg=75.0), np.float32)
    tf = camera_path(1, seed=4)[0]
    common = dict(width=W, height=H, out_width=ow, out_height=oh,
                  make_infill_mask=True, **fields)
    step = jax.vmap(partial(jst.stereo_frame,
                            cfg=jst.StereoConfig(**common)),
                    in_axes=(0, 0, None, None, None, None, None))
    want = step(jnp.asarray(rgb), jnp.asarray(color), jnp.asarray(k),
                jnp.asarray(rk), jnp.asarray(tf), jnp.asarray(2.0),
                jnp.asarray(1.0))

    def rep(a):
        return torch.from_numpy(a.copy()).expand(b, *a.shape)
    got = tst.stereo_frame(torch.from_numpy(rgb), torch.from_numpy(color),
                           rep(k), rep(rk), rep(tf), torch.full((b,), 2.0),
                           torch.ones(b), tst.StereoConfig(**common))
    for key in ("image", "infill_mask"):
        share, big = diff(got[key].numpy(), np.asarray(want[key]))
        if mode == "plane_sweep":
            assert big <= 0.005, (key, big)
        else:
            assert share <= 0.005 and big == 0, (key, share, big)
    hole = got["infill_mask"].numpy().max(-1) > 0
    assert 0 < hole.mean() < 0.3
    for key in ("depth_left", "depth_right"):
        w_, g_ = np.asarray(want[key]), got[key].numpy()
        np.testing.assert_array_equal(g_ < 1e38, w_ < 1e38)
        fin = w_ < 1e38
        np.testing.assert_allclose(g_[fin], w_[fin], rtol=5e-5)


# JAX fields the port's StereoConfig leaves out on purpose, with the reason
LEFT_OUT_FIELDS = {
    # the normal-march infill's step limit: no caller sets it, so the port
    # keeps the march's own default (400, the JAX field's default)
    "infill_march_steps",
}


def test_stereo_config_takes_every_jax_field():
    """A JAX caller's ``StereoConfig(...)`` constructs in the port: every
    field of the JAX dataclass at its default but those left out on
    purpose, ``vr180=True`` too; each left-out field is really missing."""
    fields = {f.name: f.default for f in dataclasses.fields(jst.StereoConfig)}
    ported = {f.name for f in dataclasses.fields(tst.StereoConfig)}
    assert LEFT_OUT_FIELDS <= set(fields) - ported
    assert set(fields) - LEFT_OUT_FIELDS <= ported
    kw = {k: v for k, v in fields.items()
          if v is not dataclasses.MISSING and k not in LEFT_OUT_FIELDS}
    cfg = tst.StereoConfig(**{**kw, "width": W, "height": H, "out_width": W,
                              "out_height": H, "vr180": True})
    assert cfg.vr180


def test_touchly_depth_panel_matches_jax():
    rng = np.random.default_rng(2)
    depth = (rng.random((2, 9, 11)) * 8).astype(np.float32)
    depth[0, :2] = 3.0e38
    mask = rng.random((2, 9, 11)) > 0.2
    cfg = dict(width=11, height=9, touchly_max_depth=5.0,
               touchly_min_depth=0.5)
    want = jax.vmap(lambda d, m: jst._touchly_depth8(
        d, m, jst.StereoConfig(out_width=11, out_height=9, **cfg)))(
            jnp.asarray(depth), jnp.asarray(mask))
    got = tst._touchly_depth8(torch.from_numpy(depth),
                              torch.from_numpy(mask), tst.StereoConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_equirect_resample_matches_jax():
    """The map bit for bit; the resample of u8 panels bit for bit."""
    xy = tst.equirect_maps(40, 40, 80.0)
    np.testing.assert_array_equal(xy, jst.equirect_maps(40, 40, 80.0))
    imgs = np.random.default_rng(1).integers(0, 256, (2, 40, 120, 3),
                                             np.uint8)
    want = jst._equirect_batch(imgs, jnp.asarray(xy), True)
    got = tst._equirect_batch(torch.from_numpy(imgs), torch.from_numpy(xy),
                              True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 5-frame depth and color clip, a foreground mask and a camera
    path, as files."""
    pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("clip")
    depth, color = scene(5, b=5)
    paths = {"depth": str(d / "clip_depth.mkv"), "color": str(d / "clip.mkv"),
             "mask": str(d / "clip_mask.mkv"),
             "tf": str(d / "clip_transformations.json")}
    tvio.save_depth_video(depth, paths["depth"], 24, 100.0)
    tvio.save_rgb_video(color, paths["color"], 24)
    mask = np.zeros((5, H, W, 3), np.uint8)
    mask[:, 10:30, 20:40] = 255
    tvio.save_rgb_video(mask, paths["mask"], 24)
    tside.save_transformations(paths["tf"], camera_path(5))
    return paths


def read(path):
    with tvio.VideoReader(path) as r:
        return r.read_all()


# mode -> render_stereo_video arguments (file-to-file cases)
FILE_MODES = {
    "camera_path_lock_frame": {"transformations": "tf",
                               "transformation_lock_frame": 2,
                               "infill_mask": True},
    "pointcloud": {"transformations": "tf", "render_as_pointcloud": True,
                   "infill_mask": True},
    "touchly1": {"touchly1": True, "infill_mask": True},
    "touchly0": {"touchly0": True, "vr180_eye_size": 64},
    "vr180": {"vr180": True, "infill_mask": True, "vr180_eye_size": 80},
}


@pytest.mark.parametrize("mode", sorted(FILE_MODES))
def test_render_stereo_video_file_to_file_matches_jax(clip, tmp_path, mode):
    kw = dict(FILE_MODES[mode])
    if "transformations" in kw:
        kw["transformations"] = tside.load_transformations(clip["tf"])
    outs = {}
    for name, mod in (("jax", jst), ("torch", tst)):
        depth = str(tmp_path / f"{name}_depth.mkv")
        os.link(clip["depth"], depth)
        out = mod.render_stereo_video(
            depth, color_video=clip["color"], xfov=60.0,
            convergence_depths=[2.0] * 5, batch_size=2, **kw,
            **({"device": "cpu"} if name == "torch" else {}))
        masks = read(out + "_infillmask.mkv") if kw.get("infill_mask") \
            else None
        outs[name] = (os.path.basename(out).split("_depth.mkv")[1],
                      read(out), masks)
    (suffix, img, masks), (want_suffix, want_img, want_masks) = \
        outs["torch"], outs["jax"]
    assert suffix == want_suffix
    size = {"touchly1": (5, 2 * H, W, 3), "touchly0": (5, 64, 192, 3),
            "vr180": (5, 80, 160, 3)}.get(mode, (5, H, 2 * W, 3))
    assert img.shape == size
    share, big = diff(img, want_img)
    assert share <= 0.01 and big <= 0.001, (share, big)
    if masks is not None:
        assert diff(masks, want_masks)[1] <= 0.001
        hole, want_hole = masks.max(-1) > 0, want_masks.max(-1) > 0
        assert 0 < want_hole.mean() < 0.3
        assert (hole != want_hole).mean() <= 0.002


# convergence depths that a smoothing would change
CONVERGENCE = [1.5, 3.0, 2.0, 5.0, 2.5]


def test_background_mode_files_cross_read(clip, tmp_path):
    """``--save_background`` then ``--load_background --infill_mask``: each
    package's ``.npy`` is read by the other, and the renders from it agree
    within the file-to-file budget, under convergence depths used as given
    (the background mode does not smooth them, in either package)."""
    tf = tside.load_transformations(clip["tf"])
    clouds = {}
    for name, mod in (("jax", jst), ("torch", tst)):
        depth = str(tmp_path / f"{name}_depth.mkv")
        os.link(clip["depth"], depth)
        clouds[name] = mod.render_stereo_video(
            depth, color_video=clip["color"], mask_video=clip["mask"],
            xfov=60.0, transformations=tf, save_background=True,
            **({"device": "cpu"} if name == "torch" else {}))
        assert clouds[name] == depth + "_background.npy"
    (pj, cj), (pt, ct) = (np.load(clouds[n], allow_pickle=True)
                          for n in ("jax", "torch"))
    assert pj.shape == pt.shape and len(pt) > 1000
    # points and colors through the jitted JAX step: float32 rounding
    # apart (XLA divides by 255 as a multiply by its reciprocal: 1 ulp)
    np.testing.assert_allclose(np.asarray(pt, np.float32),
                               np.asarray(pj, np.float32), atol=2e-5)
    np.testing.assert_allclose(np.asarray(ct, np.float32),
                               np.asarray(cj, np.float32), atol=6e-8,
                               rtol=0)
    renders = {}
    for name, mod in (("jax", jst), ("torch", tst)):
        out = mod.render_stereo_video(
            clip["depth"], color_video=clip["color"],
            output=str(tmp_path / f"{name}_bg.mkv"), xfov=60.0,
            load_background=clouds["torch" if name == "jax" else "jax"],
            infill_mask=True, convergence_depths=CONVERGENCE,
            **({"device": "cpu"} if name == "torch" else {}))
        renders[name] = (read(out), read(out + "_infillmask.mkv"))
    for got, want in zip(renders["torch"], renders["jax"]):
        assert got.shape == (5, H, 2 * W, 3)
        share, big = diff(got, want)
        assert share <= 0.01 and big <= 0.001
    assert renders["torch"][0].mean() > 5


def test_background_mode_does_not_smooth_convergence(clip, tmp_path,
                                                    monkeypatch):
    """The reference caveat the port copies: the sweep and forward paths
    smooth the convergence depths (``smooth_convergence``), the background
    mode uses them as given."""
    calls = []
    smooth = tst.smooth_convergence
    monkeypatch.setattr(tst, "smooth_convergence",
                        lambda v: calls.append(list(v)) or smooth(v))
    tst.render_stereo_video(
        clip["depth"], output=str(tmp_path / "bg.mkv"), xfov=60.0,
        mask_video=clip["mask"], convergence_depths=CONVERGENCE,
        max_frames=2, device="cpu")
    assert calls == []
    tst.render_stereo_video(
        clip["depth"], output=str(tmp_path / "fw.mkv"), xfov=60.0,
        transformations=tside.load_transformations(clip["tf"]),
        convergence_depths=CONVERGENCE, max_frames=2, device="cpu")
    assert calls == [CONVERGENCE]


def test_vr180_map_is_built_once_from_the_first_batch(clip, tmp_path,
                                                      monkeypatch):
    """The reference caveat the port copies: the VR180 equirect map comes
    from the first batch's render FOV (its last frame's), also when
    ``--xfov_file`` widens the FOV later; file to file against the JAX
    package under the same varying FOVs."""
    xfovs = np.asarray([60.0, 70.0, 100.0, 110.0, 110.0], np.float32)
    maps = []
    build = tst.equirect_maps
    monkeypatch.setattr(tst, "equirect_maps",
                        lambda *a: maps.append(a) or build(*a))
    outs = {}
    for name, mod in (("jax", jst), ("torch", tst)):
        out = mod.render_stereo_video(
            clip["depth"], color_video=clip["color"],
            output=str(tmp_path / f"{name}.mkv"), xfovs=xfovs, vr180=True,
            vr180_eye_size=64, batch_size=2,
            **({"device": "cpu"} if name == "torch" else {}))
        outs[name] = read(out)
    assert maps == [(64, 64, 75.0)]
    share, big = diff(outs["torch"], outs["jax"])
    assert outs["torch"].shape == (5, 64, 128, 3)
    assert share <= 0.01 and big <= 0.001, (share, big)


def test_stereo_profile_writes_a_trace(clip, tmp_path, monkeypatch):
    """``mdvt-torch stereo --profile DIR`` writes one Chrome trace of the
    run, which holds the forward warp's z-buffer scatter."""
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    trace = tmp_path / "trace"
    tmain.main(["stereo", "--depth_video", clip["depth"], "--color_video",
                clip["color"], "--xfov", "60", "--transformation_file",
                clip["tf"], "--infill_mask", "--max_frames", "2",
                "--batch_size", "2", "--profile", str(trace)])
    files = list(trace.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("scatter_reduce" in e.get("name", "") for e in events)


# flags that raised NotImplementedError before the general renderer was
# ported -> what render_stereo_video receives
REACHED = {
    "--vr180": {"vr180": True},
    "--touchly0": {"touchly0": True},
    "--touchly1": {"touchly1": True},
    "--render_as_pointcloud": {"render_as_pointcloud": True},
    "--transformation_file": {"transformation_lock_frame": 3},
    "--mask_video": {"mask_video": "m.mkv"},
    "--save_background": {"save_background": True},
    "--load_background": {"load_background": "bg.npy"},
    "--profile": {},
}


@pytest.mark.parametrize("flag", sorted(REACHED))
def test_stereo_flags_reach_the_pipeline(tmp_path, monkeypatch, flag):
    calls = []
    monkeypatch.setattr(tst, "render_stereo_video",
                        lambda *a, **kw: calls.append(kw) or "out.mkv")
    argv = ["--depth_video", "d.mkv", "--xfov", "60", flag]
    if flag == "--transformation_file":
        tf = str(tmp_path / "t.json")
        tside.save_transformations(tf, camera_path(4))
        argv[-1:] = [flag, tf, "--transformation_lock_frame", "3"]
    elif flag == "--profile":
        argv.append(str(tmp_path / "prof"))
    elif flag in ("--mask_video", "--load_background"):
        argv.append(REACHED[flag][flag[2:]])
    tcli.run(tcli.build_parser().parse_args(argv), device="cpu")
    (kw,) = calls
    for key, value in REACHED[flag].items():
        assert kw[key] == value
    if flag == "--transformation_file":
        np.testing.assert_array_equal(kw["transformations"], camera_path(4))
    if flag == "--profile":
        assert list((tmp_path / "prof").glob("*.json"))
