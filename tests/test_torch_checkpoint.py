"""The port's checkpoint files (``io/checkpoint.py``) against Flax's and the
JAX package's: the port reads what ``flax.serialization`` writes and Flax
reads what the port writes, byte for byte the same file for the same tree
(float32, bfloat16, float16, int32, numpy scalars, Python values, empty
and nested dicts), Flax's chunked leaves both ways, the JAX package's
``save_checkpoint`` / ``load_checkpoint`` files both ways, and the pickle
format (read by both). Exact: every comparison is of bytes.
"""

import os
import pickle
import subprocess
import sys

import flax.serialization as ser
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metric_depth_video_toolbox_tpu.models import convert as jconvert
from metric_depth_video_toolbox_tpu_torch.io import checkpoint as ck
from metric_depth_video_toolbox_tpu_torch.models import convert as tconvert
from metric_depth_video_toolbox_tpu_torch.models import from_jax
from port_helpers import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bf16(a):
    """A bfloat16 numpy array (JAX's ml_dtypes type) of ``a``."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {
        "block0": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                   "bias": rng.standard_normal(4).astype(np.float32)},
        "bf16": bf16(rng.standard_normal((5, 3))),
        "half": rng.standard_normal((2, 2)).astype(np.float16),
        "ids": np.arange(7, dtype=np.int32),
        "zero_d": np.array(1.5, np.float32),
        "empty_leaf": np.zeros((0, 3), np.float32),
        "empty": {},
        "nested": {"a": {"b": {"c": np.ones(2, np.float64)}}}},
        "step": np.int64(12), "scale": np.float32(0.25), "count": 70000,
        "neg": -3, "ratio": 1.25, "name": "vda", "flag": True, "none": None,
        "raw": b"\x00\x01", "z": 1 + 2j, "seq": [1, 2.5, "x"]}


def bits(x):
    """Comparable bytes of a leaf (a bfloat16 tensor as int16)."""
    if torch.is_tensor(x):
        assert x.dtype == torch.bfloat16
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy()\
            .tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)) or torch.is_tensor(want):
        assert bits(got) == bits(want), path
    else:
        assert type(got) is type(want) and got == want, path


def test_port_reads_flax_and_flax_reads_port():
    """bfloat16 leaves come back as torch.bfloat16 tensors of the same
    bits; every other value as Flax restores it; the port's bytes are
    Flax's."""
    want = tree()
    data = ser.msgpack_serialize(want)
    got = ck.msgpack_restore(data)
    assert got["params"]["bf16"].dtype == torch.bfloat16
    assert isinstance(got["step"], np.int64) and got["step"] == 12
    assert_same(got, ser.msgpack_restore(data))
    assert ck.msgpack_serialize(got) == data
    assert ck.msgpack_serialize(want) == data
    back = ser.msgpack_restore(ck.msgpack_serialize(got))
    assert back["params"]["bf16"].dtype == want["params"]["bf16"].dtype
    assert_same(back, ser.msgpack_restore(data))


@pytest.mark.parametrize("limit", [64, 100])
def test_chunked_leaves(monkeypatch, limit):
    """Leaves over MAX_CHUNK_SIZE (made small here) are split as Flax
    splits them, in both directions, a bfloat16 leaf included."""
    rng = np.random.default_rng(1)
    want = {"w": rng.standard_normal((10, 7)).astype(np.float32),
            "b": bf16(rng.standard_normal(70)),
            "small": np.ones(3, np.float32)}
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", limit)
    monkeypatch.setattr(ck, "MAX_CHUNK_SIZE", limit)
    data = ser.msgpack_serialize(want)
    assert b"__msgpack_chunked_array__" in data
    got = ck.msgpack_restore(data)
    assert got["w"].shape == (10, 7) and got["b"].shape == (70,)
    assert_same(got, ser.msgpack_restore(data))
    assert ck.msgpack_serialize(got) == data
    assert_same(ser.msgpack_restore(ck.msgpack_serialize(got)),
                ser.msgpack_restore(data))


def test_files_round_trip_with_the_jax_package(tmp_path):
    """``.msgpack`` and ``.pkl`` files written by either package's
    ``save_checkpoint`` read by the other's ``load_checkpoint``; the same
    tree gives the same ``.msgpack`` file. Arrays read from a ``.msgpack``
    file are views of one buffer."""
    want = tree()
    del want["z"], want["raw"], want["name"], want["seq"]   # str, bytes
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jconvert.save_checkpoint(jpath, want)
    tconvert.save_checkpoint(tpath, want)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    got = tconvert.load_checkpoint(jpath)
    assert_same(got, jconvert.load_checkpoint(jpath))
    block = got["params"]["block0"]
    assert block["kernel"].base is not None and block["kernel"].flags.writeable
    assert_same(jconvert.load_checkpoint(tpath), jconvert.load_checkpoint(
        jpath))
    plain = {"params": {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3)},
             "n": 3}
    path = str(tmp_path / "plain.pkl")
    with open(path, "wb") as f:
        pickle.dump(plain, f)
    assert_same(tconvert.load_checkpoint(path),
                jconvert.load_checkpoint(path))
    # both writers write msgpack whatever the suffix (a ".pkl" they write
    # is then read as a pickle, and fails, by both readers)
    for pkg in (jconvert, tconvert):
        pkg.save_checkpoint(str(tmp_path / f"{pkg.__name__[-20:]}.pkl"),
                            plain)
    written = [p.read_bytes() for p in sorted(tmp_path.glob("*convert.pkl"))]
    assert len(written) == 2 and written[0] == written[1]
    assert ser.msgpack_restore(written[0])["n"] == 3


def test_bfloat16_leaves_load_into_a_module(tmp_path):
    """A bfloat16 leaf read from a file is a torch.bfloat16 tensor, which
    ``from_jax`` takes (as float32 of the same value)."""
    rng = np.random.default_rng(2)
    kernel = bf16(rng.standard_normal((3, 4)))
    path = str(tmp_path / "bf16.msgpack")
    jconvert.save_checkpoint(path, {"params": {"kernel": kernel,
                                               "bias": np.zeros(4)}})
    lin = torch.nn.Linear(3, 4)
    from_jax.load_flax_params(lin, tconvert.load_checkpoint(path))
    np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                  kernel.astype(np.float32).T)


def test_pickle_of_jax_arrays_names_jax(tmp_path):
    """A pickle that needs JAX to unpickle (JAX arrays as leaves) fails
    where JAX is absent with an error that says so."""
    path = str(tmp_path / "jax.pkl")
    with open(path, "wb") as f:
        pickle.dump({"w": jnp.ones(3)}, f)
    script = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "from metric_depth_video_toolbox_tpu_torch.io import checkpoint\n"
        "try:\n"
        f"    checkpoint.load_checkpoint({path!r})\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "refused: this pickle holds jax" in res.stdout
    assert ".msgpack" in res.stdout


def test_malformed_files_raise(tmp_path):
    data = ser.msgpack_serialize({"w": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        ck.msgpack_restore(data[:-3])
    with pytest.raises(ValueError, match="after the tree"):
        ck.msgpack_restore(data + b"\x00")
    with pytest.raises(TypeError, match="cannot write"):
        ck.msgpack_serialize({"w": object()})
