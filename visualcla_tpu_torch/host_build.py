"""Build the package's host C++ sources (``csrc/host/<name>.cpp``: the native
tokenizer and image-preprocessing cores) with ``g++`` at first use, into
``visualcla_tpu_torch/_build/lib<name>-<hash>.so``, and load them with ctypes.

The hash covers the source and the flags, so an edited source rebuilds.  A
build goes to a private file that is then renamed, so concurrent processes
never load a half-written library.  Nothing is written outside ``_build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
HOST_CSRC = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def load_host_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/host/<name>.cpp``; raises on failure."""
    src = os.path.join(HOST_CSRC, name + ".cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp], check=True,
                           capture_output=True)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(lib_path)
