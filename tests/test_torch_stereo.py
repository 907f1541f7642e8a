"""The port's movie-configuration stereo step against the JAX package's.

Budget for the uint8 SBS image and infill mask: at most 1 LSB on at most
0.5% of bytes. The JAX code truncates ``x * 255`` floats to uint8, so a
one-ulp difference in x can flip a byte by one.

The JAX step runs op by op (vmap, no jit), where XLA rounds each op as
written (the sweep's lerp as one fused multiply-add, which the port
reproduces). Under ``jax.jit`` XLA fuses, and so rounds, differently from
one program to the next; the file-to-file test holds the port against
the JAX package's ``render_stereo_video``, whose jitted step stays within
the budget there.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.cli import stereo_rerender as jcli
from metric_depth_video_toolbox_tpu.ops import codec as jcodec
from metric_depth_video_toolbox_tpu.ops import geometry as jgeo
from metric_depth_video_toolbox_tpu.pipeline import stereo as jst
from metric_depth_video_toolbox_tpu_torch.cli import stereo_rerender as tcli
from metric_depth_video_toolbox_tpu_torch.pipeline import stereo as tst
from port_helpers import _one_torch_thread  # noqa: F401

LSB_SHARE = 0.005


def assert_u8_budget(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= LSB_SHARE, (d > 0).mean()


def scene(seed, b=2, h=48, w=64):
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 1, h)[:, None]
    depth = np.tile(4 + 30 * yy, (b, 1, w)).astype(np.float32).reshape(
        b, h, w)
    depth[:, 10:30, 10:30] = 2.0
    depth[:, 25:45, 35:55] = 6.5
    depth *= 1 + 0.01 * rng.standard_normal((b, h, w)).astype(np.float32)
    color = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    return depth, color


def movie_cfg(mod, h, w, **kw):
    if mod is jst:
        kw.update(out_width=w, out_height=h, warp_method="sweep")
    return mod.StereoConfig(width=w, height=h, max_depth=100.0,
                            remove_edges=True, place_edge_points=True,
                            make_infill_mask=True, has_convergence=True,
                            **kw)


@pytest.mark.parametrize("mode", ["shift", "rotate"])
def test_stereo_frame_movie_config_matches_jax(mode):
    b, h, w = 2, 48, 64
    depth, color = scene(3, b, h, w)
    rgb = np.asarray(jcodec.encode_depth_frame(jnp.asarray(depth), 100.0))
    k = np.asarray(jgeo.camera_matrix_from_fov(w, h, xfov_deg=60.0),
                   np.float32)
    step = jax.vmap(partial(jst.stereo_frame,
                            cfg=movie_cfg(jst, h, w, convergence_mode=mode)),
                    in_axes=(0, 0, None, None, None, None, None))
    want = step(jnp.asarray(rgb), jnp.asarray(color), jnp.asarray(k),
                jnp.asarray(k), jnp.eye(4), jnp.asarray(2.0),
                jnp.asarray(1.0))
    kt = torch.from_numpy(k).expand(b, 3, 3)
    got = tst.stereo_frame(torch.from_numpy(rgb), torch.from_numpy(color),
                           kt, kt, torch.eye(4).expand(b, 4, 4),
                           torch.full((b,), 2.0), torch.ones(b),
                           movie_cfg(tst, h, w, convergence_mode=mode))
    for key in ("image", "infill_mask"):
        assert_u8_budget(got[key].numpy(), np.asarray(want[key]))
    holes = (got["infill_mask"].numpy().max(-1) > 0).mean()
    assert 0 < holes < 0.2
    for key in ("depth_left", "depth_right"):
        w_, g_ = np.asarray(want[key]), got[key].numpy()
        fin = (w_ < 1e38) & (g_ < 1e38)
        assert fin.mean() > 0.8
        np.testing.assert_allclose(g_[fin], w_[fin], rtol=1e-5)


@pytest.mark.parametrize("mode", ["shift", "rotate"])
def test_stereo_frame_fused_anchor_sweep_matches_jax(mode):
    """The movie configuration with ``fused_anchor_sweep`` (32 planes):
    the fused step against the JAX step run op by op, under the same uint8
    budget; outside the holes the fused image is the two-call one."""
    b, h, w = 2, 48, 64
    depth, color = scene(7, b, h, w)
    rgb = np.asarray(jcodec.encode_depth_frame(jnp.asarray(depth), 100.0))
    k = np.asarray(jgeo.camera_matrix_from_fov(w, h, xfov_deg=60.0),
                   np.float32)
    kw = {"convergence_mode": mode, "num_planes": 32}
    fused = dict(kw, fused_anchor_sweep=True)
    step = jax.vmap(partial(jst.stereo_frame,
                            cfg=movie_cfg(jst, h, w, **fused)),
                    in_axes=(0, 0, None, None, None, None, None))
    want = step(jnp.asarray(rgb), jnp.asarray(color), jnp.asarray(k),
                jnp.asarray(k), jnp.eye(4), jnp.asarray(2.0),
                jnp.asarray(1.0))
    kt = torch.from_numpy(k.copy()).expand(b, 3, 3)
    args = (torch.from_numpy(rgb.copy()), torch.from_numpy(color), kt, kt,
            torch.eye(4).expand(b, 4, 4), torch.full((b,), 2.0),
            torch.ones(b))
    got = tst.stereo_frame(*args, movie_cfg(tst, h, w, **fused))
    for key in ("image", "infill_mask"):
        assert_u8_budget(got[key].numpy(), np.asarray(want[key]))
    two_call = tst.stereo_frame(*args, movie_cfg(tst, h, w, **kw))
    hole = two_call["infill_mask"].numpy().max(-1) > 0
    assert 0 < hole.mean() < 0.2
    # the fused sweep's activity bitmaps have 32-row tiles and the single
    # sweep's 64-row ones; a blend of a valid and an invalid depth can hit
    # a plane that only the coarser tile keeps active, so a few main-surface
    # pixels may differ between the two routes (as in the JAX package)
    for key in ("depth_left", "depth_right"):
        assert (got[key] == two_call[key]).float().mean() > 0.97
    same = (got["image"] == two_call["image"]).all(-1).numpy()
    assert same[~hole].mean() > 0.97


def test_fused_anchor_sweep_file_to_file_matches_jax(tmp_path):
    """``mdvt-torch stereo --fused_anchor_sweep`` file to file against the
    JAX package's ``render_stereo_video`` with the same flag."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.io import video as jvio
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    depth, color = scene(8, b=3)
    dpath = str(tmp_path / "clip_depth.mkv")
    cpath = str(tmp_path / "clip.mkv")
    jvio.save_depth_video(depth, dpath, 24, 100.0)
    jvio.save_rgb_video(color, cpath, 24)
    want = jst.render_stereo_video(
        dpath, color_video=cpath, output=str(tmp_path / "jax.mkv"),
        xfov=60.0, infill_mask=True, batch_size=2, fused_anchor_sweep=True,
        num_planes=32)
    args = tcli.build_parser().parse_args(
        ["--depth_video", dpath, "--color_video", cpath, "--xfov", "60",
         "--infill_mask", "--batch_size", "2", "--fused_anchor_sweep",
         "--num_planes", "32"])
    got = tcli.run(args, device="cpu")
    for suffix in ("", "_infillmask.mkv"):
        with tvio.VideoReader(got + suffix) as r:
            g = r.read_all()
        with tvio.VideoReader(want + suffix) as r:
            assert_u8_budget(g, r.read_all())


def test_border_default_normals_match():
    rng = np.random.default_rng(4)
    img = rng.random((20, 30, 3)).astype(np.float32)
    hole = rng.random((20, 30)) > 0.5
    want = np.asarray(jst._border_default_normals(jnp.asarray(img),
                                                  jnp.asarray(hole)))
    got = tst._border_default_normals(torch.from_numpy(img)[None],
                                      torch.from_numpy(hole)[None])[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_smooth_convergence_matches():
    vals = [2.0, np.nan, 3.0, 2.5] * 30
    np.testing.assert_allclose(tst.smooth_convergence(vals),
                               jst.smooth_convergence(vals), rtol=1e-12)


@pytest.mark.parametrize("kind", ["actions", "values"])
def test_cli_flags_and_defaults_match(kind):
    jp, tp = jcli.build_parser(), tcli.build_parser()
    key = (lambda a: (tuple(a.option_strings), a.dest, a.default, a.type,
                      a.required, a.nargs)) if kind == "actions" else \
        (lambda a: (a.dest, a.const))
    assert sorted(map(key, jp._actions), key=str) == \
        sorted(map(key, tp._actions), key=str)


def test_render_stereo_video_file_to_file_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.io import video as jvio
    from metric_depth_video_toolbox_tpu_torch.io import video as tvio

    depth, color = scene(5, b=5)
    dpath = str(tmp_path / "clip_depth.mkv")
    cpath = str(tmp_path / "clip.mkv")
    jvio.save_depth_video(depth, dpath, 24, 100.0)
    jvio.save_rgb_video(color, cpath, 24)
    outs = {}
    for name, mod in (("jax", jst), ("torch", tst)):
        kw = {"device": "cpu"} if name == "torch" else {}
        out = mod.render_stereo_video(
            dpath, color_video=cpath, output=str(tmp_path / f"{name}.mkv"),
            xfov=60.0, convergence_depths=[2.0] * 5, infill_mask=True,
            batch_size=2, **kw)
        with tvio.VideoReader(out) as r:
            img = r.read_all()
        with tvio.VideoReader(out + "_infillmask.mkv") as r:
            mask = r.read_all()
        outs[name] = (img, mask)
    assert outs["torch"][0].shape == (5, 48, 128, 3)
    for got, want in zip(outs["torch"], outs["jax"]):
        assert_u8_budget(got, want)


def _image_case(name, rng):
    from metric_depth_video_toolbox_tpu.ops import image as jim
    from metric_depth_video_toolbox_tpu_torch.ops import image as tim

    img = rng.random((40, 56, 3)).astype(np.float32)
    hole = rng.random((40, 56)) > 0.6
    t_img, t_hole = torch.from_numpy(img), torch.from_numpy(hole)
    if name == "box_blur":
        return (jim.box_blur(jnp.asarray(img), 5),
                tim.box_blur(t_img, 5))
    if name == "masked_blur":
        return (jim.masked_blur(jnp.asarray(img), ksize=5,
                                valid_mask=jnp.asarray(hole)),
                tim.masked_blur(t_img, ksize=5, valid_mask=t_hole))
    if name == "gaussian_blur":
        return (jim.gaussian_blur(jnp.asarray(img), 7),
                tim.gaussian_blur(t_img, 7))
    if name == "gaussian_blur_plane":
        return (jim.gaussian_blur(jnp.asarray(img[..., 0]), 4, 1.3),
                tim.gaussian_blur(t_img[..., 0], 4, 1.3))
    if name == "filter2d":
        k = rng.random((4, 3)).astype(np.float32)
        return (jim.filter2d(jnp.asarray(img), jnp.asarray(k)),
                tim.filter2d(t_img, torch.from_numpy(k)))
    if name == "dilate":     # an even window is asymmetric
        return (jim.dilate(jnp.asarray(img[..., 0]), ksize=4, iterations=2),
                tim.dilate(t_img[..., 0], ksize=4, iterations=2))
    if name == "erode":      # a boolean mask stays boolean
        return (jim.erode(jnp.asarray(hole), ksize=3).astype(jnp.float32),
                tim.erode(t_hole, ksize=3).float())
    return (jim.inpaint_diffusion_multiscale(
                jnp.asarray(img), jnp.asarray(hole), coarse_iters=16,
                fine_iters=2, factor=8),
            tim.inpaint_diffusion_multiscale(t_img, t_hole, 16, 2, 8))


@pytest.mark.parametrize("name", ["box_blur", "masked_blur",
                                  "inpaint_diffusion_multiscale",
                                  "gaussian_blur", "gaussian_blur_plane",
                                  "filter2d", "dilate", "erode"])
def test_image_ops_match(name):
    """The image filters of the infill mask and the basic infill: within
    1e-6 absolute on [0, 1] data (float32 sums in another order; measured
    <= 2.4e-7)."""
    want, got = _image_case(name, np.random.default_rng(6))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
