"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``build/lib<name>-<hash>.so`` at the repository root,
keyed by the content of the source, of the ``csrc`` headers it includes,
nested ones too, and by the flags), loaded with ``ctypes``. Nothing
is built when a module is imported: a wrapper calls :func:`load` on its
first launch; :func:`build` compiles several sources at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"

COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]
# nvcc flags of the sources that need their own (others take
# COMMON_FLAGS). The disparity sweeps are held bit for bit against their
# plain versions, so nothing may be contracted into a fused multiply-add
# there; the attention kernels are held to a tolerance and keep the default.
_NO_FMAD = COMMON_FLAGS[:4] + ["-fmad=false"] + COMMON_FLAGS[4:]
NVCC_FLAGS = {
    "disparity_sweep": _NO_FMAD,
    "disparity_sweep_dual": _NO_FMAD,
}
_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.MULTILINE)

_lock = threading.RLock()
_loaded = {}      # name -> ctypes.CDLL
BUILD_LOG = {}    # name -> nvcc's output (ptxas register/smem report)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def library_path(name):
    """-> where ``csrc/<name>.cu``'s library is (or will be) built."""
    flags = NVCC_FLAGS.get(name, COMMON_FLAGS)
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    seen, todo = set(), _INCLUDE.findall(source)
    while todo:                      # the csrc headers, nested ones too
        header = todo.pop().decode()
        if header not in seen:
            seen.add(header)
            text = (CSRC_DIR / header).read_bytes()
            source += text
            todo += _INCLUDE.findall(text)
    digest = hashlib.sha256(source + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names):
    """Compile each of ``names`` whose library is missing: one ``nvcc``
    process per source, all started together; raises if any fails."""
    with _lock:
        jobs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = open(tmp.with_suffix(".log"), "w+")
            flags = NVCC_FLAGS.get(name, COMMON_FLAGS)
            jobs[name] = (out, tmp, log, subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp),
                 str(CSRC_DIR / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT))
        failed = []
        for name, (out, tmp, log, proc) in jobs.items():
            proc.wait()
            log.seek(0)
            BUILD_LOG[name] = log.read()
            log.close()
            Path(log.name).unlink()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed for csrc/{name}.cu:\n"
                              f"{BUILD_LOG[name]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name):
    """-> the ``ctypes.CDLL`` of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
