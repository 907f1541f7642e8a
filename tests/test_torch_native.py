"""The port's ``io/native.py`` against the JAX package's and against its
own numpy path: the depth codec, PLY bytes and the byte ring. Where the
C++ library loads (``make -C native`` at first use), its bytes are held
against numpy's; the numpy path is held always.

The C++ encoder scales in float64, numpy's in float32, so their codes may
differ by one at a rounding boundary (as in the JAX package); decoding is
exact on both."""

import os

import numpy as np
import pytest

from metric_depth_video_toolbox_tpu.io import native as jnative
from metric_depth_video_toolbox_tpu_torch.io import native as tnative
from metric_depth_video_toolbox_tpu_torch.io import pointcloud as tpc
from port_helpers import _one_torch_thread  # noqa: F401


@pytest.fixture
def numpy_path(monkeypatch):
    """Both packages' modules on their numpy path."""
    for mod in (jnative, tnative):
        monkeypatch.setattr(mod, "_find_lib", lambda: None)


def _code(rgb):
    return rgb[..., 0].astype(np.int64) * 256 + rgb[..., 2]


def _depth(seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 100, (24, 40)).astype(np.float32)
    d[0, :4] = [-1.0, 0.0, 100.0, 250.0]       # clamped at both ends
    return d


def test_codec_numpy_path_matches_jax(numpy_path):
    d = _depth(0)
    rgb = tnative.encode_depth_rgb(d, 100.0)
    np.testing.assert_array_equal(rgb, jnative.encode_depth_rgb(d, 100.0))
    rgb[..., 1] = np.minimum(rgb[..., 1].astype(int) + 3, 255)  # R != G
    for average_rg in (True, False):
        got = tnative.decode_rgb_depth(rgb, 100.0, average_rg=average_rg)
        assert got.dtype == np.float32 and got.shape == d.shape
        np.testing.assert_array_equal(
            got, jnative.decode_rgb_depth(rgb, 100.0, average_rg=average_rg))
    assert not tnative.available()


def test_codec_native_matches_numpy_and_jax(monkeypatch):
    if not tnative.available():
        pytest.skip("native/libmdvt_native.so neither found nor built")
    d = _depth(1)
    nat = tnative.encode_depth_rgb(d, 100.0)
    np.testing.assert_array_equal(nat, jnative.encode_depth_rgb(d, 100.0))
    rgb = nat.copy()
    rgb[..., 1] = np.minimum(rgb[..., 1].astype(int) + 3, 255)
    nat_dec = [tnative.decode_rgb_depth(rgb, 100.0, average_rg=a)
               for a in (True, False)]
    monkeypatch.setattr(tnative, "_find_lib", lambda: None)
    num = tnative.encode_depth_rgb(d, 100.0)
    assert np.abs(_code(nat) - _code(num)).max() <= 1
    assert (nat[..., 0] == nat[..., 1]).all()
    for a, want in zip((True, False), nat_dec):
        np.testing.assert_array_equal(
            tnative.decode_rgb_depth(rgb, 100.0, average_rg=a), want)


@pytest.mark.parametrize("with_colors", [True, False])
def test_ply_bytes_equal_write_ply(tmp_path, with_colors):
    """``ply_bytes`` (C++ where built) equals the port's ``write_ply`` file
    and the JAX package's ``ply_bytes``; its numpy path too."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(57, 3)).astype(np.float32)
    cols = (rng.integers(0, 256, (57, 3)).astype(np.uint8) if with_colors
            else None)
    path = str(tmp_path / "c.ply")
    tpc.write_ply(path, pts, cols)
    with open(path, "rb") as f:
        want = f.read()
    assert tnative.ply_bytes(pts, cols) == want
    assert jnative.ply_bytes(pts, cols) == want
    tnative._find_lib, orig = (lambda: None), tnative._find_lib
    try:
        assert tnative.ply_bytes(pts, cols) == want
    finally:
        tnative._find_lib = orig


@pytest.mark.parametrize("native", [True, False])
def test_ring_buffer_like_jax(monkeypatch, native):
    """The same pushes and pops give the same bytes and counts in both
    packages' rings (C++, or each package's numpy path)."""
    if native and not tnative.available():
        pytest.skip("native/libmdvt_native.so neither found nor built")
    if not native:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_find_lib", lambda: None)
    data = bytes(range(256)) * 2
    log = []
    for mod in (jnative, tnative):
        ring = mod.RingBuffer(64)
        out = [ring.push(b"hello"), ring.used, ring.pop(3), ring.pop(10),
               ring.used, ring.push(data[:100]), ring.used,
               ring.push(np.frombuffer(data[100:110], np.uint8)),
               ring.pop(40), ring.pop(40), ring.used]
        log.append(out)
    assert log[0] == log[1]
    assert log[1][5] == 63 and log[1][8] == data[:40]


def test_autobuild_renames_a_complete_library_into_place(tmp_path,
                                                         monkeypatch):
    """The first use builds ``native/`` with its Makefile in a private
    directory and renames the library into place (no half-written file
    for a concurrent loader, no build directory left behind); the built
    library loads and encodes as the numpy path does, within one code."""
    import shutil

    if not (shutil.which("make") and shutil.which("g++")):
        pytest.skip("no make / g++ to build native/ with")
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    repo_native = os.path.join(tnative.REPO, "native")
    for name in ("Makefile", "mdvt_native.cpp"):
        shutil.copy(os.path.join(repo_native, name), native_dir)
    lib = str(native_dir / "libmdvt_native.so")
    monkeypatch.setattr(tnative, "LIB_PATH", lib)
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_SEARCHED", False)
    assert tnative.available()
    assert sorted(os.listdir(native_dir)) == [
        "Makefile", "libmdvt_native.so", "mdvt_native.cpp"]
    d = _depth(3)
    nat = tnative.encode_depth_rgb(d, 100.0)
    monkeypatch.setattr(tnative, "_find_lib", lambda: None)
    assert np.abs(_code(nat) - _code(tnative.encode_depth_rgb(d, 100.0))
                  ).max() <= 1
