"""``mdvt-torch`` against the JAX package's ``mdvt``: every subcommand of
the reference is accepted (ported, or the not-ported exit), ``engine
<name>`` dispatches as the reference does, and the video writer resizes a
frame of another size as the reference's does."""

import argparse

import numpy as np
import pytest

from metric_depth_video_toolbox_tpu.cli import main as jmain
from metric_depth_video_toolbox_tpu.io import video as jvio
from metric_depth_video_toolbox_tpu_torch.cli import depth_engines as tengines
from metric_depth_video_toolbox_tpu_torch.cli import main as tmain
from metric_depth_video_toolbox_tpu_torch.io import video as tvio

REFERENCE_COMMANDS = sorted(jmain.SUBCOMMANDS) + ["bench"]


@pytest.mark.parametrize("command", REFERENCE_COMMANDS)
def test_every_reference_subcommand_is_accepted(command, capsys):
    """Ported subcommands reach their own parser (``--help`` exits 0 or
    returns); the others exit with their not-ported line. None is an
    invalid choice."""
    assert command in tmain.SUBCOMMANDS or command in tmain.NOT_PORTED
    if command in tmain.NOT_PORTED:
        with pytest.raises(SystemExit, match="not ported yet"):
            tmain.main([command])
        return
    try:
        tmain.main([command, "--help"])
    except SystemExit as e:
        assert e.code in (0, None)
    assert "usage" in capsys.readouterr().out


def test_engine_da3_reaches_da3_parser(capsys):
    with pytest.raises(SystemExit) as e:
        tmain.main(["engine", "da3", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--images_per_batch" in out and "--da3_resolution" in out


def test_engine_lists_the_reference_engines(capsys):
    from metric_depth_video_toolbox_tpu.cli import depth_engines as jengines

    assert list(tengines.MAINS) == list(jengines.MAINS)
    assert tengines.main([]) == 2
    assert tengines.main(["nosuch"]) == 2
    assert "da3" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["depthcrafter", "geometrycrafter",
                                  "mvsa"])
def test_engine_unported_exits_naming_a13(name, capsys):
    """The engines that exited naming ROADMAP A13 until the diffusion and
    MVS engines were ported now reach their own parsers, with their own
    flags."""
    with pytest.raises(SystemExit) as e:
        tmain.main(["engine", name, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "A13" not in out and "--window" in out
    assert ("--transformation_file" in out) == (name == "mvsa")
    assert ("--pmap_vae_checkpoint" in out) == (name == "geometrycrafter")


def test_video_writer_resizes_like_reference(tmp_path):
    """Frames of other sizes (larger, smaller, another aspect) written
    through both packages' writers with the lossless codec decode to
    identical frames of the writer's size."""
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, shape, np.uint8)
              for shape in ((48, 64, 3), (37, 91, 3), (96, 128, 3),
                            (60, 80, 3))]
    out = {}
    for name, vio in (("jax", jvio), ("torch", tvio)):
        path = str(tmp_path / f"{name}.mkv")
        with vio.VideoWriter(path, 24, 80, 60, codec_fourcc="FFV1") as w:
            for f in frames:
                w.write(f)
        with tvio.VideoReader(path) as r:
            out[name] = r.read_all()
    assert out["torch"].shape == (4, 60, 80, 3)
    np.testing.assert_array_equal(out["torch"], out["jax"])
    np.testing.assert_array_equal(out["torch"][3], frames[3])


def _flags(parser, verb=""):
    """{option string: (dest, default)} of a parser's flags; a subcommand
    parser's flags keyed "<verb> <option>"."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out.update(_flags(sub, f"{verb}{name} "))
        for opt in a.option_strings:
            if opt not in ("-h", "--help"):
                out[verb + opt] = (a.dest, a.default)
    return out


class _Parsed(Exception):
    """Carries the parser that an engine's main was about to run."""


def _engine_parser(module, name, monkeypatch):
    def grab(self, *a, **kw):
        raise _Parsed(self)
    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as e:
            module.MAINS[name]([])
    return e.value.args[0]


def _parsers(command, monkeypatch):
    import importlib

    pkgs = ("metric_depth_video_toolbox_tpu",
            "metric_depth_video_toolbox_tpu_torch")
    if command.startswith("engine "):
        return tuple(_engine_parser(importlib.import_module(
            f"{pkg}.cli.depth_engines"), command.split()[1], monkeypatch)
            for pkg in pkgs)
    names = {"movie": "movie_2_3d", "mask": "generate_video_mask",
             "convergence": "find_convergence_depth", "infill": "infill",
             "depth": "video_metric_convert",
             "download-weights": "download_weights", "view": "view_depthfile",
             "split-sbs": "split_sbs_video", "inpaint": "apply_inpainting",
             "project": "project", "upscale": "upscale_depth",
             "track": "track_points_in_video", "align": "align_3d_points",
             "flow": "optical_flow", "slam": "sam_track_video"}
    return tuple(importlib.import_module(f"{pkg}.cli.{names[command]}")
                 .build_parser() for pkg in pkgs)


# flags of the reference parsers that the port leaves out; each is exempt
# from parity only with a case in test_unported_options_raise below
UNPORTED_FLAGS = {"movie": (), "mask": (), "convergence": (), "infill": (),
                  "depth": (), "download-weights": (), "view": (),
                  "split-sbs": (), "inpaint": (), "project": (),
                  "engine unidepth": (), "engine unik3d": (),
                  "engine moge": (), "engine depthpro": (),
                  "engine videoanythingmetric": (), "upscale": (),
                  "engine depthcrafter": (), "engine geometrycrafter": (),
                  "engine mvsa": (), "track": (), "align": (), "flow": (),
                  "slam": ()}


@pytest.mark.parametrize("command", sorted(UNPORTED_FLAGS))
def test_port_parser_accepts_every_reference_flag(command, monkeypatch):
    ref, port = _parsers(command, monkeypatch)
    want, got = _flags(ref), _flags(port)
    for opt, (dest, default) in want.items():
        if opt in UNPORTED_FLAGS[command]:
            continue
        assert opt in got, f"{command}: {opt} missing"
        assert got[opt] == (dest, default), (command, opt)


# option values the port does not run yet: (command, argv, ROADMAP item)
UNPORTED_OPTIONS = [
    ("movie", ["--parallel", "2"], "A16"),
]


@pytest.mark.parametrize("command,argv,item", UNPORTED_OPTIONS)
def test_unported_options_raise(tmp_path, monkeypatch, command, argv, item):
    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    clip = str(tmp_path / "clip.mkv")
    if command == "movie":
        pytest.importorskip("cv2")
        tvio.save_rgb_video(np.zeros((16, 24, 32, 3), np.uint8), clip, 24)
        base = ["movie", "--color_video", clip, "--xfov", "60"]
    else:
        base = ["infill", "--sbs_color_video", clip]
    with pytest.raises(NotImplementedError, match=item):
        tmain.main(base + argv)
    for opts in UNPORTED_FLAGS.values():
        assert not set(opts) & set(argv)


@pytest.mark.parametrize("argv,want", [
    (["--quantize", "int8"], {"engine_kwargs": {
        "size": "vits", "input_size": 518, "quantize": "int8"}}),
    (["--depth_engine", "mvsa"], {"engine": "mvsa"})])
def test_movie_options_that_named_a13_reach_movie_to_3d(monkeypatch, argv,
                                                        want):
    """``movie --quantize int8`` and ``--depth_engine mvsa``, which raised
    naming ROADMAP A13, reach ``movie_to_3d`` (the depth stage's int8
    matmuls; the mvsa fallback onto the single-frame engine is held in
    test_torch_mvs.py)."""
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie as tmovie

    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    calls = []
    monkeypatch.setattr(tmovie, "movie_to_3d",
                        lambda *a, **kw: calls.append(kw))
    tmain.main(["movie", "--color_video", "c.mkv", "--xfov", "60"] + argv)
    for key, val in want.items():
        assert calls[0][key] == val


@pytest.mark.parametrize("command,argv", [
    ("movie", ["--infill_engine", "diffusion"]),
    ("infill", ["--infill_engine", "stereocrafter"])])
def test_diffusion_options_reach_their_pipeline(tmp_path, monkeypatch,
                                                command, argv):
    """Options that raised until the SVD-class infill was ported: ``movie
    --infill_engine diffusion`` reaches ``movie_to_3d`` with that engine,
    ``infill --infill_engine stereocrafter`` the chunk loop with the
    preset's engine (production scale, 768 x 1024, the halo blend on by
    default)."""
    from metric_depth_video_toolbox_tpu_torch.models import diffusion as td
    from metric_depth_video_toolbox_tpu_torch.pipeline import \
        infill_diffusion as tid
    from metric_depth_video_toolbox_tpu_torch.pipeline import movie as tmovie

    monkeypatch.setenv("MDVT_PLATFORM", "cpu")
    calls = []
    clip = str(tmp_path / "clip.mkv")
    if command == "movie":
        monkeypatch.setattr(tmovie, "movie_to_3d",
                            lambda *a, **kw: calls.append(kw))
        tmain.main(["movie", "--color_video", clip, "--xfov", "60"] + argv)
        assert calls[0]["infill_engine"] == "diffusion"
        return
    monkeypatch.setattr(tid, "infill_sbs_video_diffusion",
                        lambda *a, **kw: calls.append(kw) or "out.mkv")
    tmain.main(["infill", "--sbs_color_video", clip] + argv)
    (kw,) = calls
    eng = kw.pop("engine")
    assert isinstance(eng, tid.DiffusionInfillEngine)
    assert (eng.cfg, eng.work_hw) == (td.DIFFUSION_SVD, (768, 1024))
    assert kw == {"color_video": None, "max_frames": -1,
                  "mirror_left": True, "drift_correct": False}
