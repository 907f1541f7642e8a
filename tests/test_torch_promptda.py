"""The port's PromptDA (``models/promptda.py``, the prompt branch of
``models/dpt.py``), its ``upscale`` command (``cli/upscale_depth.py``) and
the ``promptda_hf`` and ``pmap_vae`` converters against the JAX package.

Tolerances: PromptDA at PROMPT_TINY in float32 within 1e-5 of the largest
depth (float32 sums in other orders); converted trees equal leaf for leaf
(same paths, dtypes and bytes); the upscaled depth video within one 16-bit
code on at most 1% of the pixels.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu.models import promptda as jpda
from metric_depth_video_toolbox_tpu.models import svd as jsvd
from metric_depth_video_toolbox_tpu.models import vit as jvit
from metric_depth_video_toolbox_tpu_torch.io import checkpoint as tckpt
from metric_depth_video_toolbox_tpu_torch.io import video as tvio
from metric_depth_video_toolbox_tpu_torch.models import convert as tconvert
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import promptda as tpda
from metric_depth_video_toolbox_tpu_torch.models import svd as tsvd
from port_helpers import _one_torch_thread  # noqa: F401
from test_torch_convert import assert_trees_equal, numpy_sd
from test_torch_diffusion import assert_rel, flax_like

WORK = (28, 42)             # a 2 x 3 patch grid


def f32(pkg):
    c = pkg.PROMPT_TINY
    return dataclasses.replace(c, vit=dataclasses.replace(c.vit,
                                                          dtype="float32"),
                               dpt=dataclasses.replace(c.dpt,
                                                       dtype="float32"))


def tiny_tree(seed):
    x = jnp.zeros((1,) + WORK + (3,))
    return flax_like(jax.eval_shape(lambda: jpda.PromptDA(f32(jpda)).init(
        jax.random.PRNGKey(0), x, jnp.ones((1, 12, 16)))), seed)


@torch.no_grad()
def test_promptda_matches_flax():
    """Two items with their own prompt ranges; the prompt (12 x 16) is
    resized to every fusion level's size, both smaller and larger."""
    tree = tiny_tree(1)
    rng = np.random.default_rng(2)
    img = rng.random((2,) + WORK + (3,)).astype(np.float32)
    prompt = np.stack([rng.uniform(0.5, 8.0, (12, 16)),
                       rng.uniform(20.0, 30.0, (12, 16))]).astype(np.float32)
    want = np.asarray(jax.jit(jpda.PromptDA(f32(jpda)).apply)(
        tree, img, prompt))
    model = from_jax.load_flax_params(tpda.PromptDA(f32(tpda), WORK),
                                      tree).eval()
    got = model(torch.from_numpy(img), torch.from_numpy(prompt)).numpy()
    assert got.shape == want.shape == (2,) + WORK
    assert_rel(got, want, 1e-5)
    for i, (lo, hi) in enumerate(((0.5, 8.0), (20.0, 30.0))):
        assert lo <= got[i].min() and got[i].max() <= hi


def test_pad_to_multiple_of_matches_jax():
    x = np.random.default_rng(3).random((2, 15, 29, 3)).astype(np.float32)
    want = np.asarray(jpda.pad_to_multiple_of(jnp.asarray(x), 14))
    got = tpda.pad_to_multiple_of(torch.from_numpy(x), 14).numpy()
    assert got.shape == (2, 28, 42, 3)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- converters ----

def hf_promptda():
    """A seeded HF PromptDepthAnythingForDepthEstimation state dict and its
    ViT config (the layout of depth-anything/prompt-depth-anything-*-hf)."""
    transformers = pytest.importorskip("transformers")
    from test_weight_exact import _randomize

    backbone = transformers.Dinov2Config(
        image_size=56, patch_size=14, num_hidden_layers=4, hidden_size=32,
        num_attention_heads=2, intermediate_size=128,
        out_indices=[1, 2, 3, 4], apply_layernorm=True,
        reshape_hidden_states=False)
    cfg = transformers.PromptDepthAnythingConfig(
        backbone_config=backbone, reassemble_hidden_size=32,
        fusion_hidden_size=16, neck_hidden_sizes=[8, 16, 24, 32],
        reassemble_factors=[4, 2, 1, 0.5], patch_size=14,
        head_hidden_size=32, depth_estimation_type="metric", max_depth=1)
    model = transformers.PromptDepthAnythingForDepthEstimation(cfg)
    sd = _randomize(model, seed=21)
    vit = dataclasses.replace(jvit.VIT_TINY, embed_dim=32, depth=4,
                              num_heads=2, out_indices=(0, 1, 2, 3))
    return sd, vit


def pmap_vae_sd():
    from test_weight_exact_svd import TVAE
    return numpy_sd(TVAE(jsvd.PMAP_VAE_TINY), 8)


@pytest.mark.parametrize("grid", [None, (3, 5)], ids=["native", "resampled"])
def test_promptda_hf_tree_equals_jax(grid):
    sd, vit = hf_promptda()
    want = jconvert.convert_promptda_hf(sd, vit, grid)
    got = tconvert.convert_promptda_hf(sd, vit, grid)
    assert_trees_equal(got, want)
    assert sorted(got["params"]["head"]["fusion2"]["prompt"]) == [
        "conv1", "conv2", "conv3"]


@pytest.mark.parametrize("kind", ["promptda_hf", "pmap_vae"])
def test_convert_torch_file_matches_jax(tmp_path, kind):
    """The two kinds that waited for the diffusion and MVS engines: a
    ``torch.save`` file through both packages' ``convert_torch_file``
    (pmap_vae at PMAP_VAE_TINY), equal trees that load into the port's
    modules."""
    if kind == "promptda_hf":
        sd, cfg = hf_promptda()
        cfgs = (cfg, cfg)
    else:
        sd = pmap_vae_sd()
        cfgs = (jsvd.PMAP_VAE_TINY, tsvd.PMAP_VAE_TINY)
    path = str(tmp_path / "upstream.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    got = tconvert.convert_torch_file(path, kind, cfgs[1])
    assert_trees_equal(got, jconvert.convert_torch_file(path, kind, cfgs[0]))
    if kind == "pmap_vae":
        from_jax.load_flax_params(tsvd.SVDVAEEncoder(tsvd.PMAP_VAE_TINY),
                                  got["encoder"])
        from_jax.load_flax_params(tsvd.SVDVAEDecoder(tsvd.PMAP_VAE_TINY),
                                  got["decoder"])
        assert tsvd.vae_config_from_params(got, "float32") == \
            tsvd.PMAP_VAE_TINY
    else:
        pcfg = tpda.PromptDAConfig(
            vit=dataclasses.replace(tpda.PROMPT_TINY.vit, embed_dim=32,
                                    depth=4, num_heads=2),
            dpt=dataclasses.replace(tpda.PROMPT_TINY.dpt, features=16,
                                    out_channels=(8, 16, 24, 32)))
        ignored = []
        from_jax.load_flax_params(tpda.PromptDA(pcfg, (56, 56)), got,
                                  ignore_unused=True, ignored=ignored)
        assert sorted(ignored) == ["head.resize0.bias", "head.resize0.weight",
                                   "head.resize1.bias", "head.resize1.weight",
                                   "head.resize3.bias", "head.resize3.weight"]


def test_pmap_vae_weights_entry_plans_alike(tmp_path, capsys):
    """``download-weights --model geometrycrafter_pmap_vae --dry_run``:
    the same plan from both packages' CLIs, nothing fetched; the entry's
    kind now converts."""
    from metric_depth_video_toolbox_tpu.cli import download_weights as jdw
    from metric_depth_video_toolbox_tpu_torch.cli import \
        download_weights as tdw

    entry = tconvert.WEIGHT_REGISTRY["geometrycrafter_pmap_vae"]
    assert entry == jconvert.WEIGHT_REGISTRY["geometrycrafter_pmap_vae"]
    # the kind converts: no kind waits for a later item (``_LATER`` went
    # with the tracking converters)
    assert entry["kind"] == "pmap_vae" and not hasattr(tconvert, "_LATER")
    outs = []
    for i, mod in enumerate((jdw, tdw)):
        d = str(tmp_path / str(i))
        mod.main(["--model", "geometrycrafter_pmap_vae", "--dest_dir", d,
                  "--dry_run"])
        outs.append(capsys.readouterr().out)
        assert os.listdir(d) == []
    assert outs[0] == outs[1] == (
        "would snapshot https://huggingface.co/TencentARC/GeometryCrafter\n")


# -------------------------------------------------------------- upscale ----

def test_upscale_cli_matches_jax(tmp_path, monkeypatch):
    """``upscale`` file to file through both packages' commands: 5 colour
    frames of 36 x 48 (working size 28 x 42, a shrink), a 12 x 16 prompt
    video, batches of 2 (the last one short), on one converted checkpoint
    file; the commands' ViT-L configuration is PROMPT_TINY in float32
    here."""
    pytest.importorskip("cv2")
    from metric_depth_video_toolbox_tpu.cli import upscale_depth as jup
    from metric_depth_video_toolbox_tpu_torch.cli import main as tmain

    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    monkeypatch.setattr(jpda, "PromptDAConfig", lambda: f32(jpda))
    monkeypatch.setattr(tpda, "PromptDAConfig", lambda: f32(tpda))
    ckpt = str(tmp_path / "promptda.msgpack")
    tckpt.save_checkpoint(ckpt, tiny_tree(4))
    rng = np.random.default_rng(5)
    color = rng.integers(0, 256, (5, 36, 48, 3), np.uint8)
    yy, xx = np.mgrid[0:12, 0:16]
    prompt = np.stack([2.0 + np.sin(0.3 * xx + t) + 0.1 * yy
                       for t in range(5)]).astype(np.float32)
    out = {}
    for pkg in ("jax", "torch"):
        os.makedirs(tmp_path / pkg)
        c = str(tmp_path / pkg / "c.mkv")
        tvio.save_rgb_video(color, c, 24)
        tvio.save_depth_video(prompt, c + "_depth.mkv", 24, 100.0)
        argv = ["--color_video", c, "--depth_video", c + "_depth.mkv",
                "--batch_size", "2", "--checkpoint", ckpt]
        if pkg == "jax":
            jup.main(argv)
        else:
            tmain.main(["upscale"] + argv)
        out[pkg] = c + "_depth.mkv_upscaled.mkv"
    codes = {}
    for pkg, path in out.items():
        with tvio.VideoReader(path) as r:
            rgb = r.read_all().astype(np.int64)
        codes[pkg] = rgb[..., 0] * 256 + rgb[..., 2]
    d = np.abs(codes["torch"] - codes["jax"])
    assert codes["torch"].shape == (5, 36, 48)
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
