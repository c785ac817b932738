"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and compiles
with ``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``visualcla_tpu_torch/_build/<name>-<hash>.so``.  The hash covers the source,
the flags and the compiler path, so an edited source rebuilds and an unchanged
one loads the library already built.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIBS: dict = {}
build_seconds: dict = {}  # name -> seconds the last build in this process took


def _nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "CUDA kernels are built from source at first use")
    return path


def _library_path(name: str, nvcc: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(
        src + " ".join(NVCC_FLAGS).encode() + nvcc.encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        nvcc = _nvcc_path()
        lib_path = _library_path(name, nvcc)
        if not os.path.exists(lib_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            # build into a private file, then rename: concurrent processes
            # (test workers) never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-o", tmp,
                     os.path.join(CSRC, name + ".cu")],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {name}.cu:\n{proc.stderr}")
                os.replace(tmp, lib_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            build_seconds[name] = time.perf_counter() - t0
        _LIBS[name] = ctypes.CDLL(lib_path)
        return _LIBS[name]
