"""The port stands alone: no module of it (nor chip_smoke.py) imports JAX,
Flax, ``msgpack`` or the JAX package; it imports and runs its in-memory
path, and writes and reads a converted checkpoint, with those (and
OpenCV) blocked; and it runs on the CPU only when asked to."""

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
try:
    convert.convert_torch_file("raft.pth", "raft")
except NotImplementedError as e:
    assert "A14" in str(e)
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
