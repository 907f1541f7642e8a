"""The port's checkpoint converters (``models/convert.py``) against the JAX
package's, on the same synthetic upstream-layout state dicts: the trees
must be equal, the same key paths and every leaf bit-equal (same dtype,
same bytes). The state dicts come from the torch mirrors of the
weight-exact tests (the upstream module layouts) and from ``transformers``
for the HF layouts. Then ``convert_torch_file``'s dispatch (the kinds the
port converts, the tracking, pose and flow kinds loaded into the port's
models, the JAX package's ``cfg=None`` fault), the weight registry and
``download_weights``
through its test seams (nothing here reaches the network), and the
weight-exact decode held against the upstream graphs: the HF
Depth-Anything-V2 model and the Video-Depth-Anything head mirror, within
the float32 tolerances of the JAX package's weight-exact tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu.models import cotracker as jct
from metric_depth_video_toolbox_tpu.models import da3 as jda3
from metric_depth_video_toolbox_tpu.models import dpt as jdpt
from metric_depth_video_toolbox_tpu.models import raft as jraft
from metric_depth_video_toolbox_tpu.models import svd as jsvd
from metric_depth_video_toolbox_tpu.models import video_depth as jvd
from metric_depth_video_toolbox_tpu.models import vit as jvit
from metric_depth_video_toolbox_tpu.models import wan as jwan
from metric_depth_video_toolbox_tpu_torch.models import clip as tclip
from metric_depth_video_toolbox_tpu_torch.models import convert as tconvert
from metric_depth_video_toolbox_tpu_torch.models import cotracker as tct
from metric_depth_video_toolbox_tpu_torch.models import da3 as tda3
from metric_depth_video_toolbox_tpu_torch.models import depth_anything as tda
from metric_depth_video_toolbox_tpu_torch.models import dpt as tdpt
from metric_depth_video_toolbox_tpu_torch.models import droid as tdroid
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from metric_depth_video_toolbox_tpu_torch.models import raft as traft
from metric_depth_video_toolbox_tpu_torch.models import segmentation as tseg
from metric_depth_video_toolbox_tpu_torch.models import svd as tsvd
from metric_depth_video_toolbox_tpu_torch.models import video_depth as tvd
from metric_depth_video_toolbox_tpu_torch.models import vit as tvit
from metric_depth_video_toolbox_tpu_torch.models import wan as twan
from port_helpers import _one_torch_thread  # noqa: F401


def assert_trees_equal(got, want, path=""):
    """Same key paths; leaves of the same type, dtype, shape and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


def numpy_sd(module, seed, scale=0.05):
    """A torch module's state dict, every float tensor redrawn (seeded)."""
    g = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=g) * scale).numpy()
            if v.dtype.is_floating_point else v.numpy()
            for k, v in module.state_dict().items()}


# ------------------------------------------------ upstream state dicts ----

def da2_sd(n_tokens=12):
    from test_convert import _synth_da2_state_dict
    return _synth_da2_state_dict(np.random.default_rng(0), jvit.VIT_TINY,
                                 jdpt.DPT_TINY, n_tokens)


def hf_da2_sd(kind="relative"):
    from test_weight_exact import _hf_da2, _randomize
    model = _hf_da2(kind, max_depth=20.0 if kind == "metric" else None)
    return model, _randomize(model, seed=3)


def init_sd(make, seed, noise=0.05):
    """The state dict of ``make()`` at torch's default initialisation
    (seeded), every float tensor + ``noise`` * N(0, 1), so that norms,
    biases and embeddings are not at their trivial values."""
    torch.manual_seed(seed)
    module = make()
    g = torch.Generator().manual_seed(seed)
    return {k: (v + noise * torch.randn(v.shape, generator=g)).numpy()
            if v.dtype.is_floating_point else v.numpy()
            for k, v in module.state_dict().items()}


def vda_sd(n_tokens=12, chans=(16, 32, 48, 64), feat=32):
    """Upstream Video-Depth-Anything at ``vitt`` widths: ``pretrained.*``
    DINOv2 and the temporal DPT head ``head.*`` (its motion modules
    included), initialised as torch initialises the modules."""
    from test_weight_exact_vda import THeadTemporal
    from torch_mirrors import TDino
    v = jvit.VIT_TINY
    sd = {"pretrained." + k: a for k, a in init_sd(lambda: TDino(
        v.embed_dim, v.depth, v.num_heads, 14, n_tokens, v.out_indices),
        1).items()}
    sd.update({"head." + k: a for k, a in init_sd(lambda: THeadTemporal(
        v.embed_dim, chans, feat, 2, 4), 2).items()})
    # a positive disparity before the head's last relu, as a trained head
    # gives (drawn weights alone make it zero almost everywhere)
    sd["head.scratch.output_conv2.2.bias"] += 1.0
    return sd


VDA_J = jvd.VideoDepthConfig(vit=jvit.VIT_TINY, dpt=jdpt.DPT_TINY,
                             temporal_heads=2, norm_groups=4)
VDA_T = tvd.VideoDepthConfig(vit=tvit.VIT_TINY, dpt=tdpt.DPT_TINY,
                             temporal_heads=2, norm_groups=4)


def da3_sd():
    from test_weight_exact_da3 import TDA3
    return numpy_sd(TDA3(4), 2)


def da3_cfgs():
    from test_weight_exact_da3 import CHANS, CROSS, D, DEPTH, FEAT, HEADS
    out = []
    for vit_mod, dpt_mod, da3_mod in ((jvit, jdpt, jda3),
                                      (tvit, tdpt, tda3)):
        vit = dataclasses.replace(vit_mod.VIT_TINY, embed_dim=D, depth=DEPTH,
                                  num_heads=HEADS, cross_view_indices=CROSS)
        dpt = dpt_mod.DPTConfig(features=FEAT, out_channels=CHANS,
                                torch_resize=True, fast_head=False)
        out.append(da3_mod.DA3Config(vit=vit, dpt=dpt))
    return out


def wan_sd(prompt=True):
    from test_weight_exact_wan import TWanDiT
    sd = numpy_sd(TWanDiT(), 3)
    if prompt:     # the side-channel prompt encoding, shorter than the bank
        sd["mdvt.prompt_context"] = np.random.default_rng(4).standard_normal(
            (3, jwan.WAN_TINY.text_dim + 5)).astype(np.float32)
    return sd


WAN_J = dataclasses.replace(jwan.WAN_TINY, layers=2)
WAN_T = dataclasses.replace(twan.WAN_TINY, layers=2)


def u2net_sd():
    from test_weight_exact_u2net import TU2NET
    return numpy_sd(TU2NET(tseg.SEG_TINY), 4)


def svd_sds():
    from test_weight_exact_svd import TSVDUNet, TVAE
    return numpy_sd(TSVDUNet(jsvd.SVD_TINY), 5), numpy_sd(
        TVAE(jsvd.SVD_VAE_TINY), 6)


def m2svid_sd():
    from test_weight_exact_m2svid import _diffusers_key_to_sgm
    unet, _ = svd_sds()
    sd = {"model.diffusion_model." + _diffusers_key_to_sgm(k): v
          for k, v in unet.items()}
    sd["first_stage_model.dummy"] = np.zeros(1, np.float32)
    return sd


def clip_sd():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=8,
        projection_dim=16)
    torch.manual_seed(0)
    return numpy_sd(transformers.CLIPVisionModelWithProjection(cfg), 7)


# (upstream state dicts, JAX call, port call) per converter
CASES = {
    "dinov2_vit": lambda: (
        lambda c: c.convert_dinov2_vit(da2_sd(), jvit.VIT_TINY), None),
    "dpt_head": lambda: (
        lambda c: c.convert_dpt_head(da2_sd(), jvit.VIT_TINY), None),
    "da2": lambda: (lambda c: c.convert_da2(da2_sd(), jvit.VIT_TINY), None),
    "dinov2_hf": lambda: (lambda c: c.convert_dinov2_hf(
        hf_da2_sd()[1], _hf_vit()), None),
    "dpt_head_hf": lambda: (
        lambda c: c.convert_dpt_head_hf(hf_da2_sd()[1]), None),
    "da2_hf_resampled": lambda: (lambda c: c.convert_da2_hf(
        hf_da2_sd()[1], _hf_vit(), grid_hw=(3, 5)), None),
    "da3_resampled": lambda: (
        lambda c: c.convert_da3(da3_sd(), da3_cfgs()[0], grid_hw=(3, 2)),
        lambda c: c.convert_da3(da3_sd(), da3_cfgs()[1], grid_hw=(3, 2))),
    "vda": lambda: (lambda c: c.convert_vda(vda_sd(), VDA_J),
                    lambda c: c.convert_vda(vda_sd(), VDA_T)),
    "wan_prompt": lambda: (lambda c: c.convert_wan(wan_sd(), WAN_J),
                           lambda c: c.convert_wan(wan_sd(), WAN_T)),
    "wan": lambda: (lambda c: c.convert_wan(wan_sd(False), WAN_J),
                    lambda c: c.convert_wan(wan_sd(False), WAN_T)),
    "u2net": lambda: (lambda c: c.convert_u2net(u2net_sd()), None),
    "svd_unet": lambda: (
        lambda c: c.convert_svd_unet(svd_sds()[0], jsvd.SVD_TINY),
        lambda c: c.convert_svd_unet(svd_sds()[0], tsvd.SVD_TINY)),
    "svd_vae": lambda: (
        lambda c: c.convert_svd_vae(svd_sds()[1], jsvd.SVD_VAE_TINY),
        lambda c: c.convert_svd_vae(svd_sds()[1], tsvd.SVD_VAE_TINY)),
    "m2svid_sgm": lambda: (
        lambda c: c.convert_m2svid_sgm(m2svid_sd(), jsvd.SVD_TINY),
        lambda c: c.convert_m2svid_sgm(m2svid_sd(), tsvd.SVD_TINY)),
    "stereocrafter": lambda: (
        lambda c: c.convert_stereocrafter(*svd_sds(), jsvd.SVD_TINY,
                                          jsvd.SVD_VAE_TINY),
        lambda c: c.convert_stereocrafter(*svd_sds(), tsvd.SVD_TINY,
                                          tsvd.SVD_VAE_TINY)),
    "clip_vision": lambda: (
        lambda c: c.convert_clip_vision(clip_sd(), tclip.CLIP_TINY), None),
}


def _hf_vit():
    return dataclasses.replace(jvit.VIT_TINY, embed_dim=32, depth=4,
                               num_heads=2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_equals_jax(case):
    jcall, tcall = CASES[case]()
    want = jcall(jconvert)
    got = (tcall or jcall)(tconvert)
    assert_trees_equal(got, want)


def test_converted_trees_load_into_the_port_models():
    """Every converted tree has the port module's names: strict loads of a
    VDA tree (the learned resize layers used by the weight-exact decode),
    a DA3 tree, a Wan DiT, the U²-Net, the StereoCrafter inpainter and the
    CLIP tower; a U²-Net tree missing a leaf, or with a wrong shape,
    raises."""
    vda = tconvert.convert_vda(vda_sd(), VDA_T)
    exact = dataclasses.replace(VDA_T, dpt=dataclasses.replace(
        VDA_T.dpt, torch_resize=True, fast_head=False))
    from_jax.load_flax_params(tvd.VideoDepthAnything(exact, (42, 56)), vda)
    from_jax.load_flax_params(
        tda3.DA3(da3_cfgs()[1], (42, 28)),
        tconvert.convert_da3(da3_sd(), da3_cfgs()[1], grid_hw=(3, 2)))
    from_jax.load_flax_params(twan.WanDiT(WAN_T),
                              tconvert.convert_wan(wan_sd(), WAN_T))
    from_jax.load_flax_params(tsvd.SVDInpainter(
        tsvd.SVD_TINY, tsvd.SVD_VAE_TINY), tconvert.convert_stereocrafter(
            *svd_sds(), tsvd.SVD_TINY, tsvd.SVD_VAE_TINY))
    from_jax.load_flax_params(tclip.CLIPVisionTower(tclip.CLIP_TINY),
                              tconvert.convert_clip_vision(clip_sd(),
                                                           tclip.CLIP_TINY))
    tree = tconvert.convert_u2net(u2net_sd())
    from_jax.load_flax_params(tseg.U2Net(tseg.SEG_TINY), tree)
    del tree["params"]["side1"]["bias"]
    with pytest.raises(RuntimeError, match="side1.bias"):
        from_jax.load_flax_params(tseg.U2Net(tseg.SEG_TINY), tree)
    tree["params"]["side1"]["bias"] = np.zeros(2, np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        from_jax.load_flax_params(tseg.U2Net(tseg.SEG_TINY), tree)


# ------------------------------------------------- convert_torch_file ----

FILE_KINDS = {
    "da3": (da3_sd, lambda pkg: da3_cfgs()[pkg]),
    "wan": (wan_sd, lambda pkg: (WAN_J, WAN_T)[pkg]),
    "inspatio_world": (wan_sd, lambda pkg: (WAN_J, WAN_T)[pkg]),
    "u2net": (u2net_sd, lambda pkg: None),
    "vda": (vda_sd, lambda pkg: (VDA_J, VDA_T)[pkg]),
    "da2": (da2_sd, lambda pkg: jvit.VIT_TINY),
    "m2svid": (m2svid_sd, lambda pkg: (jsvd.SVD_TINY, tsvd.SVD_TINY)[pkg]),
    "svd_vae": (lambda: svd_sds()[1],
                lambda pkg: (jsvd.SVD_VAE_TINY, tsvd.SVD_VAE_TINY)[pkg]),
}


@pytest.mark.parametrize("kind", sorted(FILE_KINDS))
def test_convert_torch_file_matches_jax(tmp_path, kind):
    """A ``torch.save`` file (wrapped in ``state_dict`` for one kind) goes
    through both packages' ``convert_torch_file`` to equal trees."""
    make, cfg = FILE_KINDS[kind]
    sd = {k: torch.from_numpy(v) for k, v in make().items()}
    path = str(tmp_path / "upstream.pth")
    torch.save({"state_dict": sd} if kind == "u2net" else sd, path)
    assert_trees_equal(tconvert.convert_torch_file(path, kind, cfg(1)),
                       jconvert.convert_torch_file(path, kind, cfg(0)))


@pytest.mark.parametrize("kind,field", [("vda", "vit"), ("dinov2", "depth"),
                                        ("da2", "depth")])
def test_convert_torch_file_without_cfg_fails_like_jax(tmp_path, kind,
                                                       field):
    """The JAX package's dispatch passes ``cfg=None`` to the converters
    that read a config, so ``mdvt download-weights --model vda --convert``
    fails there with ``AttributeError``; the port's fails the same way."""
    path = str(tmp_path / "upstream.pth")
    torch.save({k: torch.from_numpy(v) for k, v in vda_sd().items()}, path)
    errors = []
    for pkg in (jconvert, tconvert):
        with pytest.raises(AttributeError) as e:
            pkg.convert_torch_file(path, kind)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == (f"'NoneType' object has no attribute "
                                      f"'{field}'")


def raft_sd():
    """torchvision ``raft_large`` layout at RAFT_TINY widths, batch-norm
    statistics drawn away from 0 / 1."""
    from test_weight_exact_raft import TRaft
    sd = numpy_sd(TRaft(jraft.RAFT_TINY), 11)
    rng = np.random.default_rng(11)
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 1.5, sd[k].shape).astype(np.float32)
    return sd


def droid_sd(prefix="module."):
    """DROID-SLAM layout at DROID_TINY widths (``module.`` prefixed, as
    Mega-SAM's DataParallel file), with an extra tensor of Mega-SAM's that
    the converter ignores."""
    from test_weight_exact_droid import TDroid
    torch.manual_seed(12)
    sd = {prefix + k: v.detach().numpy() for k, v in
          TDroid().state_keys().items()}
    sd[prefix + "update.motion_head.weight"] = np.ones((2, 3), np.float32)
    return sd


def cotracker3_sd():
    """cotracker3_offline layout at COTRACKER3_TINY widths with the
    upstream flow embedding (C = 64), its ``virual_tracks`` spelling."""
    from test_weight_exact_cotracker import TCoTracker3
    torch.manual_seed(13)
    cfg = dataclasses.replace(jct.COTRACKER3_TINY, flow_embed_dim=64)
    return {k: v.detach().numpy() for k, v in TCoTracker3(cfg)
            .state_dict().items()}


# the converters of the tracking, pose and flow models: upstream state
# dict maker, the torch.save'd file's kind, the port model built from the
# converted tree
A14_KINDS = {
    "droid": (lambda: droid_sd(""), lambda: tdroid.DroidNet(
        tdroid.DROID_TINY)),
    "megasam": (droid_sd, lambda: tdroid.DroidNet(tdroid.DROID_TINY)),
    "raft": (raft_sd, lambda: traft.RAFT(traft.RAFT_TINY)),
    "cotracker3": (cotracker3_sd, None),
}


@pytest.mark.parametrize("kind", sorted(A14_KINDS))
def test_a14_kinds_convert_like_jax(tmp_path, kind):
    """DROID (plain and Mega-SAM's prefixed file), torchvision RAFT and
    CoTracker3 through both packages' ``convert_torch_file``: equal trees,
    leaf for leaf; the tree loads strictly into the port's model (for
    CoTracker3, at the configuration read from the file's shapes, equal to
    the JAX package's)."""
    make, model = A14_KINDS[kind]
    sd = make()
    path = str(tmp_path / "upstream.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = tconvert.convert_torch_file(path, kind)
    assert_trees_equal(got, jconvert.convert_torch_file(path, kind))
    if kind == "cotracker3":
        tcfg = tconvert.cotracker3_config_from_state_dict(sd)
        jcfg = jconvert.cotracker3_config_from_state_dict(sd)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert tcfg.flow_embed_dim == 64 and tcfg.corr_levels == 2
        over = tconvert.cotracker3_config_from_state_dict(
            sd, iters=3, model_resolution=(32, 48))
        assert (over.iters, over.model_resolution) == (3, (32, 48))
        model = lambda: tct.CoTracker3(tcfg)  # noqa: E731
    from_jax.load_flax_params(model(), got)


def test_unknown_kind_and_registry_match_jax(tmp_path):
    path = str(tmp_path / "upstream.pth")
    torch.save({"w": torch.zeros(1)}, path)
    for pkg in (jconvert, tconvert):
        with pytest.raises(ValueError, match="unknown checkpoint kind"):
            pkg.convert_torch_file(path, "nosuch")
    assert tconvert.WEIGHT_REGISTRY == jconvert.WEIGHT_REGISTRY
    for name in tconvert.WEIGHT_REGISTRY:
        assert tconvert.weight_sources(name) == jconvert.weight_sources(name)
    kinds = {e["kind"] for e in tconvert.WEIGHT_REGISTRY.values()}
    assert kinds == {
        "video_depth", "dinov2", "da3", "wan", "svd_unet", "m2svid_sgm",
        "u2net", "clip_vision", "moge", "unidepth", "unik3d", "depthpro_hf",
        "pmap_vae", "raft", "cotracker3", "droid"}


# --------------------------------------------------- download_weights ----

def _refuse(*args, **kwargs):
    raise OSError("no network in this test")


@pytest.mark.parametrize("name", ["vda", "stereocrafter"])
def test_download_weights_matches_jax(tmp_path, capsys, name):
    """Through the test seams only: the dry-run plan, a failed fetch
    naming every missing file, a fetch that writes the files, and files
    already in place used as they are."""
    out = {}
    for tag, pkg in (("jax", jconvert), ("torch", tconvert)):
        dest = str(tmp_path / f"dest_{tag}")
        assert pkg.download_weights(name, dest, dry_run=True,
                                    _urlretrieve=_refuse,
                                    _snapshot=_refuse) == []
        plan = capsys.readouterr().out
        with pytest.raises(FileNotFoundError) as e:
            pkg.download_weights(name, dest, _urlretrieve=_refuse,
                                 _snapshot=_refuse)
        fetched = []

        def fetch(url, target):
            fetched.append(url)
            open(target, "wb").close()

        def snapshot(repo_id, local_dir):
            fetched.append(repo_id)
            import os
            os.makedirs(local_dir)
        paths = pkg.download_weights(name, dest, _urlretrieve=fetch,
                                     _snapshot=snapshot)
        again = pkg.download_weights(name, dest, _urlretrieve=_refuse,
                                     _snapshot=_refuse)
        out[tag] = (plan, str(e.value).replace(dest, "<dest>"), fetched,
                    [p.replace(dest, "<dest>") for p in paths],
                    again == paths, capsys.readouterr().out.replace(
                        dest, "<dest>"))
    assert out["torch"] == out["jax"]
    plan, error, fetched, paths, reused, _ = out["torch"]
    assert plan.startswith("would ") and fetched and reused
    for f in tconvert.WEIGHT_REGISTRY[name]["files"]:
        assert f in error


# ------------------------------------- the decode against upstream ----

@pytest.mark.parametrize("kind", ["relative", "metric"])
def test_da2_hf_decode_matches_upstream(kind):
    """The port's DepthAnything (weight-exact DPT) on a ``convert_da2_hf``
    tree against the ``transformers`` Depth-Anything-V2 forward: within
    2e-4 relative + 2e-5 absolute, the JAX package's tolerance
    (test_weight_exact.py)."""
    model, sd = hf_da2_sd(kind)
    vit = dataclasses.replace(tvit.VIT_TINY, embed_dim=32, depth=4,
                              num_heads=2, dtype="float32")
    dpt = tdpt.DPTConfig(features=16, out_channels=(8, 16, 24, 32),
                         dtype="float32", fast_head=False, torch_resize=True,
                         head_act="sigmoid" if kind == "metric" else "relu")
    cfg = tda.DepthAnythingConfig(vit=vit, dpt=dpt, metric=kind == "metric",
                                  max_depth=20.0)
    tm = tda.DepthAnything(cfg, (56, 56))
    from_jax.load_flax_params(tm, tconvert.convert_da2_hf(sd, vit))
    img = np.random.default_rng(7).uniform(0.1, 0.9, (1, 56, 56, 3)).astype(
        np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(((img - mean) / std).transpose(
            0, 3, 1, 2).copy())).predicted_depth.numpy()
        got = tm(torch.from_numpy(img)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_vda_head_decode_matches_upstream():
    """The port's DPTHeadTemporal (weight-exact decode) on converted
    weights against the upstream Video-Depth-Anything head mirror: within
    3e-4 relative + 3e-5 absolute (test_weight_exact_vda.py's)."""
    from test_weight_exact_vda import THeadTemporal
    t, gh, gw, d = 4, 4, 4, 16
    chans, feat = (8, 16, 24, 32), 16
    head = THeadTemporal(d, chans, feat, 2, 4)
    g = torch.Generator().manual_seed(31)
    head.load_state_dict({k: torch.randn(v.shape, generator=g) * 0.05
                          for k, v in head.state_dict().items()})
    head.eval()
    sd = {k: v.numpy() for k, v in head.state_dict().items()}
    tree = tconvert._dpt_head_from(sd, None)
    for i in range(4):
        tree[f"motion{i}"] = tconvert._motion_module(sd,
                                                     f"motion_modules.{i}")
    cfg = tvd.VideoDepthConfig(
        vit=dataclasses.replace(tvit.VIT_TINY, embed_dim=d,
                                dtype="float32"),
        dpt=tdpt.DPTConfig(features=feat, out_channels=chans,
                           dtype="float32", torch_resize=True,
                           fast_head=False),
        temporal_heads=2, temporal_layers=1, norm_groups=4)
    tm = tvd.DPTHeadTemporal(cfg)
    from_jax.load_flax_params(tm, tree)
    rng = np.random.default_rng(29)
    feats = [rng.normal(size=(t, gh, gw, d)).astype(np.float32) * 0.3
             for _ in range(4)]
    with torch.no_grad():
        want = head([torch.from_numpy(f) for f in feats], t,
                    patch=14)[:, 0].numpy()
        got = tm([torch.from_numpy(f) for f in feats])[..., 0].numpy()
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
