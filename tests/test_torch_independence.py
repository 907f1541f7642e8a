"""The port stands alone: no module of it (nor chip_smoke.py) imports JAX,
Flax, ``msgpack`` or the JAX package; it imports every module and runs its
in-memory path (the single-frame engines too, on their stand-ins and on
real-graph trees), and writes and reads a converted checkpoint, with those
(and OpenCV) blocked; and it runs on the CPU only when asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from metric_depth_video_toolbox_tpu_torch.utils import device as devmod

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "metric_depth_video_toolbox_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack",
             "metric_depth_video_toolbox_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


BLOCKED = """
import sys
for name in ("jax", "jaxlib", "flax", "msgpack",
             "metric_depth_video_toolbox_tpu", "cv2"):
    sys.modules[name] = None
import pkgutil, importlib, numpy as np, torch
import metric_depth_video_toolbox_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from metric_depth_video_toolbox_tpu_torch.ops import codec
from metric_depth_video_toolbox_tpu_torch.pipeline import stereo
d = torch.full((1, 32, 64), 5.0); d[:, 8:24, 16:40] = 2.0
rgb = codec.encode_depth_frame(d, 100.0)
col = torch.full((1, 32, 64, 3), 128, dtype=torch.uint8)
from metric_depth_video_toolbox_tpu_torch.ops import geometry as geo
k = geo.camera_matrix_from_fov(64, 32, xfov_deg=60.0)[None]
cfg = stereo.StereoConfig(width=64, height=32, make_infill_mask=True)
out = stereo.stereo_step(cfg, rgb, col, k, torch.eye(4)[None],
                         torch.full((1,), 2.0), torch.ones(1))
assert out["image"].shape == (1, 32, 128, 3)
from metric_depth_video_toolbox_tpu_torch.models import segmentation
from metric_depth_video_toolbox_tpu_torch.pipeline import infill_video, masks
filled = infill_video.basic_infill_frame(torch.from_numpy(out["image"]),
                                         torch.from_numpy(out["infill_mask"]))
assert filled.shape == (1, 32, 128, 3)
seg = masks.MaskEngine(cfg=segmentation.SEG_TINY, work=32, device="cpu")
assert seg.masks_for(out["image"][:, :, :64]).shape == (1, 32, 64)
from metric_depth_video_toolbox_tpu_torch.models import wan
from metric_depth_video_toolbox_tpu_torch.pipeline import infill_diffusion
sbs = np.repeat(out["image"], 5, axis=0)
hole = np.repeat(out["infill_mask"], 5, axis=0).max(-1) > 0
eng = infill_diffusion.CausalInfillEngine(cfg=wan.WAN_TINY, work_hw=(32, 64),
                                          chunk=5, device="cpu")
res = infill_diffusion.infill_sbs_frames(sbs, hole, eng, mono=sbs[:, :, :64],
                                         mirror_left=False, drift_correct=True)
assert res.shape == sbs.shape and (res[~hole] == sbs[~hole]).all()
from metric_depth_video_toolbox_tpu_torch.models import clip, svd
for cfg_, kw in ((None, {}), (svd.SVD_TINY, dict(
        vae_cfg=svd.SVD_VAE_TINY, clip_params=clip.CLIPVisionTower(
            clip.CLIP_TINY).state_dict(), clip_cfg=clip.CLIP_TINY))):
    deng = infill_diffusion.DiffusionInfillEngine(
        cfg=cfg_, work_hw=(32, 48), chunk=5, mono_conditioning=True,
        device="cpu", **kw)
    got = deng.infill_chunk(sbs[:, :, 64:], hole[:, :, 64:], sbs[:, :, :64])
    assert got.shape == (5, 32, 64, 3)
    assert (got[~hole[:, :, 64:]] == sbs[:, :, 64:][~hole[:, :, 64:]]).all()
import dataclasses
fused = stereo.stereo_step(dataclasses.replace(cfg, fused_anchor_sweep=True),
                           rgb, col, k, torch.eye(4)[None],
                           torch.full((1,), 2.0), torch.ones(1))
assert fused["image"].shape == (1, 32, 128, 3)
touchly0 = stereo.stereo_step(
    dataclasses.replace(cfg, warp_method="forward", touchly0=True), rgb, col,
    k, torch.eye(4)[None], torch.full((1,), 2.0), torch.ones(1),
    eq_map=torch.from_numpy(stereo.equirect_maps(32, 64, 75.0)))
assert touchly0["image"].shape == (1, 32, 192, 3)
from metric_depth_video_toolbox_tpu_torch.models import da3
from metric_depth_video_toolbox_tpu_torch.ops import attention_packed
tiny = dataclasses.replace(da3.DA3_TINY, vit=dataclasses.replace(
    da3.DA3_TINY.vit, attention_impl="flash_packed"))
deng = da3.DA3Engine(cfg=tiny, images_per_batch=3, overlap=1,
                     num_ref_frames=1, resolution=28, device="cpu")
depth, c2w, fov = deng.infer_video(np.repeat(out["image"][:, :, :64], 5, 0))
assert depth.shape == (5, 32, 64) and c2w.shape == (5, 4, 4)
assert np.isfinite(depth).all() and np.isfinite(c2w).all()
assert attention_packed.LAUNCHES == {"packed_flash_attention": 0}
from metric_depth_video_toolbox_tpu_torch.cli import depth_engines
assert depth_engines.build_da3_parser().parse_args(
    ["--color_video", "x"]).model_size == "vitl"
import os, tempfile
from metric_depth_video_toolbox_tpu_torch.models import convert, from_jax
with tempfile.TemporaryDirectory() as tmp:
    ckpt = os.path.join(tmp, "wan.msgpack")
    dit = wan.WanDiT(wan.WAN_TINY)
    convert.save_checkpoint(ckpt, {"params": from_jax.to_flax_params(dit)})
    back = wan.WanDiT(wan.WAN_TINY)
    from_jax.load_flax_params(back, convert.load_checkpoint(ckpt))
    assert all(torch.equal(a, b) for a, b in zip(
        dit.state_dict().values(), back.state_dict().values()))
with tempfile.TemporaryDirectory() as tmp:
    # a seeded torchvision-layout RAFT state dict through the converter
    from chip_smoke import raft_shapes, upstream_state_dict
    from metric_depth_video_toolbox_tpu_torch.models import raft
    pth = os.path.join(tmp, "raft.pth")
    torch.save(upstream_state_dict(raft_shapes(raft.RAFT_TINY),
                                   torch.Generator().manual_seed(0), "cpu"),
               pth)
    flow_net = from_jax.load_flax_params(
        raft.RAFT(raft.RAFT_TINY), convert.convert_torch_file(pth, "raft"))
    frame = torch.zeros((1, 16, 24, 3), dtype=torch.uint8)
    assert torch.isfinite(flow_net(frame, frame)).all()
from metric_depth_video_toolbox_tpu_torch.models import moge, unidepth
from metric_depth_video_toolbox_tpu_torch.pipeline import depth as dstage
clip = np.zeros((2, 32, 48, 3), np.uint8)
clip[:, :, 24:] = 200
for variant, xfov, tree in (
        ("moge", None, None), ("unidepth", 60.0, None),
        ("depthpro", None, None), ("unik3d", None, None),
        ("moge", 60.0, from_jax.to_flax_params(
            moge.MoGeNet(moge.MOGE_TINY, (28, 42)))),
        ("unik3d", None, from_jax.to_flax_params(
            unidepth.UniK3DNet(unidepth.UNIDEPTH_TINY, (28, 42))))):
    sf = dstage.SingleFrameEngine(size="vitt", input_size=28, params=tree,
                                  variant=variant, xfov=xfov, device="cpu")
    d, f = sf.infer_video(clip, return_fov=True)
    assert d.shape == (2, 32, 48) and np.isfinite(d).all(), variant
    assert (sf.graph is not None) == (tree is not None)
from metric_depth_video_toolbox_tpu_torch.cli import main as cli_main
for name in ("split-sbs", "inpaint", "project"):
    importlib.import_module(cli_main.SUBCOMMANDS[name][0])
assert "jax" not in sys.modules or sys.modules["jax"] is None
assert sys.modules["msgpack"] is None
print("OK")
"""


def test_imports_and_runs_with_jax_and_cv2_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", BLOCKED], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


TRACKING = """
import sys
for name in ("jax", "jaxlib", "flax", "msgpack",
             "metric_depth_video_toolbox_tpu"):
    sys.modules[name] = None
import json, os, tempfile
import numpy as np, torch
from metric_depth_video_toolbox_tpu_torch.cli import main
from metric_depth_video_toolbox_tpu_torch.io import video as vio
rng = np.random.default_rng(0)
tex = np.kron(rng.integers(0, 200, (16, 30, 3), dtype=np.uint8),
              np.ones((4, 4, 1), np.uint8))
frames = np.stack([tex[:64, 2 * i:2 * i + 64] for i in range(6)])
depth = np.broadcast_to(np.linspace(2, 6, 64, dtype=np.float32),
                        (6, 64, 64))
with tempfile.TemporaryDirectory() as tmp:
    clip = os.path.join(tmp, "clip.mkv")
    vio.save_rgb_video(frames, clip, 24)
    dv = clip + "_depth.mkv"
    vio.save_depth_video(depth, dv, 24, 100.0)
    main.main(["track", "--color_video", clip, "--grid", "6",
               "--clip_len", "6"])
    main.main(["align", "--depth_video", dv, "--track_file",
               clip + "_tracking.json", "--xfov", "60", "--use_madpose"])
    main.main(["flow", "--color_video", clip])
    main.main(["slam", "--color_video", clip, "--depth_video", dv,
               "--xfov", "60", "--ba_iters", "2"])
    assert len(json.load(open(clip + "_tracking.json"))) == 6
    tr = np.asarray(json.load(open(dv + "_transformations.json")))
    assert tr.shape == (6, 4, 4) and np.isfinite(tr).all()
    assert vio.read_video_frames(clip + "_flow.mkv")[0].shape == (6, 64, 64,
                                                                    3)
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("OK")
"""


def test_tracking_commands_run_with_jax_blocked():
    """``track``, ``align --use_madpose``, ``flow`` (RAFT_LARGE, seeded)
    and ``slam`` file to file through ``mdvt-torch`` on a tiny clip, on the
    CPU, with the JAX package, JAX, Flax and msgpack unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO), MDVT_PLATFORM="cpu")
    res = subprocess.run([sys.executable, "-c", TRACKING], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


A15 = """
import sys
for name in ("jax", "jaxlib", "flax", "msgpack",
             "metric_depth_video_toolbox_tpu"):
    sys.modules[name] = None
import json, os, tempfile, urllib.request
import numpy as np
from metric_depth_video_toolbox_tpu_torch.cli import main
from metric_depth_video_toolbox_tpu_torch.io import native, sidecar
from metric_depth_video_toolbox_tpu_torch.io import video as vio
from metric_depth_video_toolbox_tpu_torch.pipeline import gui, project, viewer
rng = np.random.default_rng(0)
depth = np.tile(np.linspace(3, 9, 32, dtype=np.float32)[:, None], (6, 1, 48))
world = np.stack([rng.uniform(-1, 1, 20), rng.uniform(-0.5, 0.5, 20),
                  rng.uniform(4, 8, 20)], -1)
tracks, poses = [], []
for fi in range(6):
    c2w = np.eye(4)
    c2w[0, 3] = 0.3 * fi
    pc = world - c2w[:3, 3]
    uv = pc[:, :2] / pc[:, 2:] * 41.6 + [24, 16]
    tracks.append([[i, u, v] for i, (u, v) in enumerate(uv)])
    poses.append(c2w)
with tempfile.TemporaryDirectory() as tmp:
    dv = os.path.join(tmp, "d.mkv")
    vio.save_depth_video(depth, dv, 24, 100.0)
    clip = os.path.join(tmp, "c.mkv")
    vio.save_rgb_video(rng.integers(0, 256, (16, 32, 48, 3), np.uint8),
                       clip, 24)
    tr, tf = os.path.join(tmp, "t.json"), os.path.join(tmp, "p.json")
    sidecar.save_tracking(tr, tracks)
    sidecar.save_transformations(tf, poses)
    main.main(["export", "--depth_video", dv, "--track_file", tr,
               "--transformation_file", tf, "--xfov", "60", "--triangulate",
               "--min_observations", "3", "--save_grayscale", "--save_obj",
               "3", "--save_normals"])
    assert os.path.exists(dv + "_triangulated.ply")
    main.main(["analyse-depth", "--depth_video", dv, "--track_file", tr])
    main.main(["analyse-tracking", "--track_file", tr])
    srv, src, port = viewer.serve_background(dv, clip, max_points=500)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/frame/2") as r:
        assert r.read()[:4] == b"TVDM"
    srv.shutdown(); srv.server_close(); src.close()
    project.create_project(os.path.join(tmp, "proj"), clip)
    srv, state, port = gui.serve_background(os.path.join(tmp, "proj"))
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/status") as r:
        assert len(json.loads(r.read())["scenes"]) >= 1
    srv.shutdown(); srv.server_close()
rgb = native.encode_depth_rgb(depth[0], 100.0)
assert np.abs(native.decode_rgb_depth(rgb, 100.0) - depth[0]).max() < 2e-3
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("OK")
"""


def test_export_analysis_viewer_and_gui_run_with_jax_blocked():
    """``export``, ``analyse-depth`` and ``analyse-tracking`` through
    ``mdvt-torch``, the viewer's and the GUI's servers, and ``io/native``
    on a tiny clip, on the CPU, with the JAX package, JAX, Flax and msgpack
    unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO), MDVT_PLATFORM="cpu")
    res = subprocess.run([sys.executable, "-c", A15], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


A16 = """
import sys
for name in ("jax", "jaxlib", "flax", "msgpack",
             "metric_depth_video_toolbox_tpu"):
    sys.modules[name] = None
import os, tempfile
import numpy as np, torch
from metric_depth_video_toolbox_tpu_torch import parallel
from metric_depth_video_toolbox_tpu_torch.io import sidecar
from metric_depth_video_toolbox_tpu_torch.io import video as vio
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as da
from metric_depth_video_toolbox_tpu_torch.models import vit
from metric_depth_video_toolbox_tpu_torch.parallel import (mesh, scheduler,
                                                           sharding, train)
from metric_depth_video_toolbox_tpu_torch.pipeline import depth, movie
assert scheduler.shard_scenes(list(range(5)), 1, 2) == [1, 3]
model = da.DepthAnything(da.preset("vitt", metric=False), (28, 28))
vit.seeded_init(model, torch.Generator().manual_seed(0), 1.0)
step = train.sharded_train_step(mesh.make_mesh(device="cpu"), model,
                                train.make_optimizer())
loss = step(torch.rand(2, 28, 28, 3), 1.0 + torch.rand(2, 28, 28))
assert torch.isfinite(loss)
mesh.replicas = lambda device: mesh.frame_mesh(2, device)
eng = depth.VDAEngine(size="vitt", input_size=28, window=4, overlap=1,
                      metric_anchor_frames=2, device="cpu")
assert len(eng._mesh) == 2
rng = np.random.default_rng(0)
assert np.isfinite(eng.infer_video(rng.integers(0, 255, (6, 28, 28, 3),
                                                dtype=np.uint8))).all()
with tempfile.TemporaryDirectory() as tmp:
    scenes = movie.plan_scene_files(
        [{"Scene Number": str(i), "Length (frames)": "4"} for i in (1, 2)],
        tmp)
    for s in scenes:
        vio.save_rgb_video(rng.integers(0, 255, (4, 24, 32, 3), np.uint8),
                           s["scene_video_file"], 24)
        vio.save_depth_video(np.full((4, 24, 32), 3.0, np.float32),
                             s["depth_video_file"], 24, 100.0)
    movie.step5_render_sbs(scenes, xfov=60.0, batch_size=2, parallel=2,
                           device="cpu")
    assert all(vio.video_info(s["sbs"])[0] == 4 for s in scenes)
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("OK")
"""


def test_parallel_and_threaded_movie_run_with_jax_blocked():
    """``parallel/``: the scheduler, a train step on a mesh of one gloo
    rank, the VDA engine over a frame mesh of two CPU replicas, and the
    movie's step 5 on two worker threads, with the JAX package, JAX, Flax
    and msgpack unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO), MDVT_PLATFORM="cpu")
    res = subprocess.run([sys.executable, "-c", A16], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("OK")


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MDVT_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        devmod.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        devmod.resolve_device("cuda")
    assert devmod.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    assert devmod.resolve_device() == torch.device("cpu")


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """chip_smoke.py in a directory without the package (or without a
    CUDA card) exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text(encoding="utf-8"),
                      encoding="utf-8")
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
