"""ctypes bindings of the repository's native host runtime
(``native/mdvt_native.cpp``), the port's copy of the JAX package's
``io/native.py``.

Host-side work in C++: the depth codec (the analysis path decodes through
it, ``pipeline/analyse.py``), single-pass PLY serialization and a lock-free
single-producer single-consumer byte ring. The repository's
``native/Makefile`` builds ``native/libmdvt_native.so`` at first use where
``make`` and ``g++`` exist; without the library every function runs its
numpy version, which gives the same bytes but for the encoder's codes,
within one of the C++ ones (which scale in float64).
:func:`available` says which path is in use.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LIB_PATH = os.path.join(REPO, "native", "libmdvt_native.so")

_LIB = None
_SEARCHED = False

# the codec's scale: 255**4 / 65536 codes per max_depth
_CODE_SCALE = 4228250625.0


def _autobuild(native_dir):
    """``make`` in a private copy of ``native/``, then the library renamed
    into place, so that a process loading it never sees a half-written
    file; a failed build leaves the numpy path."""
    if not (shutil.which("make") and shutil.which("g++")):
        return
    try:
        with tempfile.TemporaryDirectory(prefix=".build-",
                                         dir=native_dir) as tmp:
            for name in ("Makefile", "mdvt_native.cpp"):
                shutil.copy(os.path.join(native_dir, name), tmp)
            subprocess.run(["make", "-C", tmp, "-s"], timeout=180,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL, check=True)
            os.replace(os.path.join(tmp, os.path.basename(LIB_PATH)),
                       LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        pass


def _declare(lib):
    lib.encode_depth_rgb.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_float]
    lib.encode_depth_rgb.restype = None
    lib.decode_rgb_depth.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_float,
                                     ctypes.c_int]
    lib.decode_rgb_depth.restype = None
    lib.ply_serialize.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_void_p,
                                  ctypes.c_int64]
    lib.ply_serialize.restype = ctypes.c_int64
    lib.ring_create.argtypes = [ctypes.c_int64]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_destroy.restype = None
    for f in ("ring_push", "ring_pop"):
        getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int64]
        getattr(lib, f).restype = ctypes.c_int64
    lib.ring_used.argtypes = [ctypes.c_void_p]
    lib.ring_used.restype = ctypes.c_int64


def _find_lib():
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    if not os.path.exists(LIB_PATH):
        _autobuild(os.path.dirname(LIB_PATH))
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    _declare(lib)
    _LIB = lib
    return _LIB


def available():
    """True when the C++ library is loaded (else the numpy path runs)."""
    return _find_lib() is not None


def encode_depth_rgb(depth, max_depth):
    """float32 depth (..., H, W) -> uint8 (..., H, W, 3), the bit16 codec
    (R = G = the code's high byte, B its low byte)."""
    depth = np.ascontiguousarray(depth, np.float32)
    out = np.empty(depth.shape + (3,), np.uint8)
    lib = _find_lib()
    if lib is not None:
        lib.encode_depth_rgb(depth.ctypes.data, out.ctypes.data, depth.size,
                             ctypes.c_float(max_depth))
        return out
    scale = _CODE_SCALE / (max_depth * 65536.0)
    code = np.clip(np.clip(depth, 0, max_depth) * scale, 0,
                   65535).astype(np.uint16)
    out[..., 0] = code >> 8
    out[..., 1] = code >> 8
    out[..., 2] = code & 0xFF
    return out


def decode_rgb_depth(rgb, max_depth, average_rg=True):
    """uint8 (..., H, W, 3) -> float32 depth (..., H, W); ``average_rg``
    takes the code's high byte as the mean of R and G."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty(rgb.shape[:-1], np.float32)
    lib = _find_lib()
    if lib is not None:
        lib.decode_rgb_depth(rgb.ctypes.data, out.ctypes.data, out.size,
                             ctypes.c_float(max_depth), int(average_rg))
        return out
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    hi = (r + g) // 2 if average_rg else r
    code = (hi << 8) | b
    return (code * (max_depth * 65536.0 / _CODE_SCALE)).astype(np.float32)


def ply_bytes(points, colors=None):
    """A point cloud (N, 3) with optional uint8 colors (N, 3) as binary
    PLY bytes, those of ``io/pointcloud.py::write_ply``."""
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    cols = None
    if colors is not None:
        cols = np.ascontiguousarray(colors, np.uint8).reshape(-1, 3)
    lib = _find_lib()
    if lib is None:
        from metric_depth_video_toolbox_tpu_torch.io import pointcloud
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "cloud.ply")
            pointcloud.write_ply(path, pts, cols)
            with open(path, "rb") as f:
                return f.read()
    cap = 256 + pts.shape[0] * (12 + (3 if cols is not None else 0))
    out = np.empty(cap, np.uint8)
    n = lib.ply_serialize(pts.ctypes.data,
                          cols.ctypes.data if cols is not None else None,
                          pts.shape[0], out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("ply_serialize: buffer too small")
    return out[:n].tobytes()


class RingBuffer:
    """Lock-free single-producer single-consumer byte ring of
    ``capacity`` bytes, of which ``capacity - 1`` are usable (one slot
    tells full from empty). C++, or a deque of chunks without it."""

    def __init__(self, capacity):
        self._lib = _find_lib()
        self._cap = capacity
        if self._lib is not None:
            self._h = self._lib.ring_create(capacity)
            if not self._h:
                raise MemoryError("ring_create failed")
        else:
            from collections import deque
            self._q = deque()
            self._used = 0

    def push(self, data):
        """Append as many bytes of ``data`` as fit; -> the count taken."""
        data = (np.frombuffer(data, np.uint8) if isinstance(data, bytes)
                else np.ascontiguousarray(data, np.uint8))
        if self._lib is not None:
            return int(self._lib.ring_push(self._h, data.ctypes.data,
                                           data.size))
        n = min(data.size, self._cap - 1 - self._used)
        if n:
            self._q.append(bytes(data[:n]))
            self._used += n
        return n

    def pop(self, n):
        """Up to ``n`` bytes from the front."""
        if self._lib is not None:
            out = np.empty(n, np.uint8)
            got = int(self._lib.ring_pop(self._h, out.ctypes.data, n))
            return out[:got].tobytes()
        out = b""
        while self._q and len(out) < n:
            chunk = self._q.popleft()
            take = min(n - len(out), len(chunk))
            out += chunk[:take]
            if take < len(chunk):
                self._q.appendleft(chunk[take:])
        self._used -= len(out)
        return out

    @property
    def used(self):
        if self._lib is not None:
            return int(self._lib.ring_used(self._h))
        return self._used

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h",
                                                                None):
            self._lib.ring_destroy(self._h)
