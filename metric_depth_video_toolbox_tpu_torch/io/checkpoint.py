"""Converted checkpoint files, read and written without JAX, Flax or the
``msgpack`` package.

Two formats for reading, chosen by the file's suffix, as the JAX
package's ``models/convert.py`` (``load_checkpoint``) reads them; its
``save_checkpoint`` and the port's write the first, whatever the suffix:

- ``.msgpack``: Flax's format (``flax.serialization.msgpack_serialize`` /
  ``to_bytes``, read by ``msgpack_restore`` / ``from_bytes``). A tree of
  maps with string keys whose leaves are arrays (msgpack ext type 1: a
  nested msgpack array ``[shape, dtype name, raw C-order bytes]``), numpy
  scalars (ext type 3, the same payload), complex numbers (ext type 2:
  ``[real, imag]``) and plain msgpack values (str, bin, int, float, bool,
  nil, arrays). A leaf larger than :data:`MAX_CHUNK_SIZE` bytes is split
  as Flax splits it: a map ``{"__msgpack_chunked_array__": True, "shape":
  {"0": d0, ...}, "chunks": {"0": flat chunk, ...}}``.
- anything else: a pickle of a tree of numpy arrays.

Reading keeps each array a view of the file's buffer (one read of the
file, no copy per leaf; a chunked leaf is joined into one copy). The dtype
``bfloat16``, which numpy lacks, is read as ``int16`` and returned as a
``torch.bfloat16`` tensor (a view of the same bytes); every other array
leaf is a numpy array. Writing streams each array's bytes to the file,
map keys sorted as the JAX package's writer has them, so that the same
tree gives the same file.
"""

from __future__ import annotations

import io
import os
import pickle
import struct

import numpy as np
import torch

# Flax's limit per array leaf before it chunks (flax.serialization)
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------- reading

# type byte -> struct code of a fixed-size number
_NUMBER = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
           0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (struct code of its length, the value's kind)
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}

class _Reader:
    """msgpack decoder over one buffer; arrays are views of it."""

    def __init__(self, buf):
        self.buf = buf
        self.mv = memoryview(buf)
        self.pos = 0

    def take(self, n):
        start = self.pos
        self.pos += n
        if self.pos > len(self.mv):
            raise ValueError("msgpack: truncated data")
        return start

    def unpack(self, fmt):
        start = self.take(struct.calcsize(fmt))
        return struct.unpack_from(fmt, self.mv, start)[0]

    def value(self):
        b = self.mv[self.take(1)]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _NUMBER:
            return self.unpack(_NUMBER[b])
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            return getattr(self, kind)(self.unpack(fmt))
        if 0xD4 <= b <= 0xD8:            # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n):
        return [self.value() for _ in range(n)]

    def str(self, n):
        start = self.take(n)
        return bytes(self.mv[start:start + n]).decode("utf-8")

    def bin(self, n):
        start = self.take(n)
        return bytes(self.mv[start:start + n])

    def ext(self, n):
        code = self.unpack(">b")
        start = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = self.ndarray(start, n)
            return arr if code == EXT_NDARRAY else arr[()]
        if code == EXT_COMPLEX:
            sub = _Reader(self.mv[start:start + n])
            real, imag = sub.value()
            return complex(real, imag)
        raise ValueError(f"msgpack: ext type {code} is not Flax's")

    def ndarray(self, start, n):
        """The ext payload ``[shape, dtype name, bytes]``, its bytes viewed
        in place."""
        sub = _Reader(self.mv[start:start + n])
        if sub.mv[sub.take(1)] != 0x93:
            raise ValueError("msgpack: ndarray payload is not a 3-array")
        shape = tuple(sub.value())
        name = sub.value()
        name = name.decode() if isinstance(name, bytes) else name
        b = sub.mv[sub.take(1)]
        if _SIZED.get(b, ("", ""))[1] in ("bin", "str"):
            nbytes = sub.unpack(_SIZED[b][0])
        elif 0xA0 <= b <= 0xBF:
            nbytes = b & 0x1F
        else:
            raise ValueError("msgpack: ndarray bytes are not bin or str")
        offset = start + sub.take(nbytes)
        if name == "bfloat16":
            raw = np.frombuffer(self.buf, np.int16, nbytes // 2, offset)
            return torch.from_numpy(raw.reshape(shape)).view(torch.bfloat16)
        dt = np.dtype(name)
        return np.frombuffer(self.buf, dt, nbytes // dt.itemsize,
                             offset).reshape(shape)


def _unchunk(node):
    if not isinstance(node, dict):
        return node
    if node.get(CHUNKED) is True:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if torch.is_tensor(chunks[0]):
            flat = torch.cat(chunks)
        else:
            flat = np.concatenate(chunks)
        return flat.reshape(shape)
    for key, val in node.items():
        node[key] = _unchunk(val)
    return node


def msgpack_restore(data):
    """Flax ``msgpack_restore``: bytes (or a writable buffer, whose arrays
    then are writable views) -> tree."""
    if isinstance(data, bytes):
        data = bytearray(data)     # writable views for torch.from_numpy
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.mv):
        raise ValueError(f"msgpack: {len(r.mv) - r.pos} bytes after the "
                         "tree")
    return _unchunk(tree)


def _unpickle(f):
    try:
        return pickle.load(f)
    except ModuleNotFoundError as e:
        if e.name and e.name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise RuntimeError(
                f"this pickle holds {e.name} objects (e.g. JAX arrays); the "
                "port reads pickles of numpy arrays only: convert the tree's "
                "leaves with numpy.asarray before pickling, or save it as "
                ".msgpack") from e
        raise


def load_checkpoint(path):
    """A converted checkpoint (``.msgpack`` in Flax's format, else a pickle)
    -> tree of arrays."""
    with open(path, "rb") as f:
        if not path.endswith(".msgpack"):
            return _unpickle(f)
        # one uninitialised buffer (a bytearray would be zeroed first)
        buf = np.empty(os.fstat(f.fileno()).st_size, np.uint8)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return msgpack_restore(buf)


# ---------------------------------------------------------------- writing

def _head(f, small, fixed_base, fixed_max, fmts, n):
    """A header for ``n`` items: a fix-form byte when it fits, else the
    smallest of ``fmts`` ((type byte, struct code, limit), ...)."""
    if fixed_base is not None and n <= fixed_max:
        f.write(bytes([fixed_base | n]))
        return
    for byte, code, limit in fmts:
        if n <= limit:
            f.write(bytes([byte]) + struct.pack(code, n))
            return
    raise ValueError(f"msgpack: {small} of {n} items is too large")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))


def _int(f, v):
    if 0 <= v <= 0x7F or -32 <= v < 0:
        f.write(struct.pack(">b", v) if v < 0 else bytes([v]))
    elif v >= 0:
        for byte, code, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                  (0xCE, ">I", 0xFFFFFFFF),
                                  (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                f.write(bytes([byte]) + struct.pack(code, v))
                return
        raise OverflowError(f"msgpack: int {v} too large")
    else:
        for byte, code, limit in ((0xD0, ">b", 0x80), (0xD1, ">h", 0x8000),
                                  (0xD2, ">i", 0x80000000),
                                  (0xD3, ">q", 0x8000000000000000)):
            if -v <= limit:
                f.write(bytes([byte]) + struct.pack(code, v))
                return
        raise OverflowError(f"msgpack: int {v} too small")


def _str(f, s):
    raw = s.encode("utf-8")
    _head(f, "str", 0xA0, 0x1F, _STR, len(raw))
    f.write(raw)


def _bin(f, raw):
    _head(f, "bin", None, 0, _BIN, len(raw))
    f.write(raw)


def _array_parts(x):
    """-> (shape, dtype name, C-order buffer) of a numpy array or tensor."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return (tuple(x.shape), "bfloat16",
                    memoryview(x.view(torch.int16).numpy().reshape(-1)
                               .view(np.uint8)))
        x = x.numpy()
    x = np.asarray(x)
    if not x.flags.c_contiguous:     # (ascontiguousarray makes 0-d 1-d)
        x = x.copy(order="C")
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError(f"msgpack: dtype {x.dtype} cannot be written")
    # as bytes: a bfloat16 numpy array (ml_dtypes) has no buffer format
    return (tuple(x.shape), x.dtype.name,
            memoryview(x.reshape(-1).view(np.uint8)))


def _ndarray_ext(f, x, code):
    shape, name, raw = _array_parts(x)
    head = io.BytesIO()
    head.write(bytes([0x93]))
    _value(head, list(shape))
    _str(head, name)
    _head(head, "bin", None, 0, _BIN, len(raw))
    head = head.getvalue()
    _ext_head(f, code, len(head) + len(raw))
    f.write(head)
    f.write(raw)


def _ext_head(f, code, n):
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        f.write(bytes([fixext[n]]) + struct.pack(">b", code))
        return
    for byte, fmt, limit in ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                             (0xC9, ">I", 0xFFFFFFFF)):
        if n <= limit:
            f.write(bytes([byte]) + struct.pack(fmt, n)
                    + struct.pack(">b", code))
            return
    raise ValueError(f"msgpack: an ext value of {n} bytes is too large")


def _nbytes(x):
    return x.numel() * x.element_size() if torch.is_tensor(x) else x.nbytes


def _chunked(x):
    """Flax's chunked form of an oversized leaf."""
    flat = x.reshape(-1)
    itemsize = x.element_size() if torch.is_tensor(x) else x.dtype.itemsize
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[s:s + step]
                       for i, s in enumerate(range(0, n, step))}}


def _value(f, v, sort_keys=True):
    if v is None:
        f.write(b"\xc0")
    elif v is True or v is False:
        f.write(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int) and not isinstance(v, np.generic):
        _int(f, v)
    elif isinstance(v, float) and not isinstance(v, np.generic):
        f.write(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        _str(f, v)
    elif isinstance(v, (bytes, bytearray)):
        _bin(f, bytes(v))
    elif isinstance(v, complex):
        payload = io.BytesIO()
        payload.write(b"\x92")
        _value(payload, v.real)
        _value(payload, v.imag)
        raw = payload.getvalue()
        _ext_head(f, EXT_COMPLEX, len(raw))
        f.write(raw)
    elif isinstance(v, np.generic):
        _ndarray_ext(f, np.asarray(v), EXT_NPSCALAR)
    elif isinstance(v, np.ndarray) or torch.is_tensor(v):
        if _nbytes(v) > MAX_CHUNK_SIZE:
            _value(f, _chunked(v), sort_keys=False)
        else:
            _ndarray_ext(f, v, EXT_NDARRAY)
    elif isinstance(v, dict):
        # keys sorted, as the JAX package's writer (a jax.tree.map) has them;
        # a chunked leaf's maps in Flax's order
        _head(f, "map", 0x80, 0x0F, _MAP, len(v))
        for key in sorted(v) if sort_keys else v:
            _value(f, key)
            _value(f, v[key], sort_keys)
    elif isinstance(v, (list, tuple)):
        _head(f, "array", 0x90, 0x0F, _ARRAY, len(v))
        for item in v:
            _value(f, item)
    else:
        raise TypeError(f"msgpack: cannot write {type(v).__name__}")


def msgpack_serialize(tree):
    """Flax ``msgpack_serialize``: tree -> bytes."""
    buf = io.BytesIO()
    _value(buf, tree)
    return buf.getvalue()


def save_checkpoint(path, params):
    """Write ``params`` (a tree of dicts and lists whose leaves are arrays,
    tensors or scalars) to ``path`` in Flax's msgpack, every leaf an array
    as the JAX package's ``save_checkpoint`` makes it (the same tree gives
    the same bytes); the chunks stream to the file. -> ``path``"""
    tmp = path + ".part"
    with open(tmp, "wb") as f:
        _value(f, _as_arrays(params))
    os.replace(tmp, path)
    return path


def _as_arrays(node):
    """The tree with each leaf an array (a tensor stays a tensor), as
    ``jax.tree.map(np.asarray, tree)`` makes it."""
    if isinstance(node, dict):
        return {k: _as_arrays(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_as_arrays(v) for v in node]
    if node is None or torch.is_tensor(node):
        return node
    return np.asarray(node)
