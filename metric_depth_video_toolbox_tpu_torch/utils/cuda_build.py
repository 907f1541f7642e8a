"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``build/lib<name>-<hash>.so`` at the repository root,
keyed by the source's content), loaded with ``ctypes``. Nothing is built
when a module is imported: a wrapper calls :func:`load` on its first
launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded = {}      # name -> ctypes.CDLL
BUILD_LOG = {}    # name -> nvcc's output (ptxas register/smem report)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def load(name):
    """-> the ``ctypes.CDLL`` of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            BUILD_LOG[name] = proc.stdout
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                                   f"{proc.stdout}")
            os.replace(tmp, out)
        lib = _loaded[name] = ctypes.CDLL(str(out))
    return lib
