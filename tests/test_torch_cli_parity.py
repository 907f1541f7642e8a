"""``mdvt-torch`` against the JAX package's ``mdvt``: every subcommand of
the reference is accepted (ported, or the not-ported exit), ``engine
<name>`` dispatches as the reference does, and the video writer resizes a
frame of another size as the reference's does."""

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


@pytest.mark.parametrize("name", ["unidepth", "moge", "mvsa"])
def test_engine_unported_exits_naming_a13(name):
    with pytest.raises(SystemExit, match="A13"):
        tmain.main(["engine", name, "--color_video", "x.mkv"])


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


def _flags(parser):
    """{option string: (dest, default)} of a parser's flags."""
    return {opt: (a.dest, a.default) for a in parser._actions
            for opt in a.option_strings if opt not in ("-h", "--help")}


def _parsers(command):
    import importlib

    names = {"movie": "movie_2_3d", "mask": "generate_video_mask",
             "convergence": "find_convergence_depth", "infill": "infill",
             "depth": "video_metric_convert",
             "download-weights": "download_weights", "view": "view_depthfile"}
    return tuple(importlib.import_module(f"{pkg}.cli.{names[command]}")
                 .build_parser() for pkg in (
                     "metric_depth_video_toolbox_tpu",
                     "metric_depth_video_toolbox_tpu_torch"))


# flags of the reference parsers that the port leaves out; each is exempt
# from parity only with a case in test_unported_options_raise below
UNPORTED_FLAGS = {"movie": (), "mask": (), "convergence": (), "infill": (),
                  "depth": (), "download-weights": (), "view": ()}


@pytest.mark.parametrize("command", sorted(UNPORTED_FLAGS))
def test_port_parser_accepts_every_reference_flag(command):
    ref, port = _parsers(command)
    want, got = _flags(ref), _flags(port)
    for opt, (dest, default) in want.items():
        if opt in UNPORTED_FLAGS[command]:
            continue
        assert opt in got, f"{command}: {opt} missing"
        assert got[opt] == (dest, default), (command, opt)


# option values the port does not run yet: (command, argv, ROADMAP item)
UNPORTED_OPTIONS = [
    ("movie", ["--parallel", "2"], "A16"),
    ("movie", ["--quantize", "int8"], "A13"),
    ("movie", ["--depth_engine", "unidepth"], "A13"),
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
