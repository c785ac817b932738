"""ctypes bindings for the native tokenizer core (``csrc/host/sptok.cpp``).

(The reference's equivalent native dependency is the sentencepiece C++ core
under LlamaTokenizer — modeling_utils.py:94.)

The shared library builds lazily (one g++ invocation into the package's
``_build/``, see ``host_build``); environments without a toolchain fall back to the pure-Python
``sp_bpe`` automatically (tokenizer.py catches any failure here).
Set VISUALCLA_NO_NATIVE=1 to force the Python path.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..host_build import load_host_library
from .sp_model import SPModel

_LIB_LOCK = threading.Lock()
_LIB = None


def _build_and_load() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if os.environ.get("VISUALCLA_NO_NATIVE"):
            raise RuntimeError("native tokenizer disabled via VISUALCLA_NO_NATIVE")
        lib = load_host_library("sptok")
        lib.sptok_create.restype = ctypes.c_void_p
        lib.sptok_create.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.sptok_free.argtypes = [ctypes.c_void_p]
        lib.sptok_encode.restype = ctypes.c_int32
        lib.sptok_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        _LIB = lib
        return lib


class NativeEncoder:
    """Native SP-BPE encoder over a parsed SPModel."""

    def __init__(self, model: SPModel):
        if model.model_type != "BPE":
            raise RuntimeError(
                f"native core supports BPE models only (got {model.model_type})"
            )
        self._lib = _build_and_load()
        blob = b"".join(p.encode("utf-8") for p in model.pieces)
        lens = np.asarray([len(p.encode("utf-8")) for p in model.pieces], np.int32)
        scores = np.asarray(model.scores, np.float32)
        types = np.asarray(model.types, np.uint8)
        self._handle = self._lib.sptok_create(
            blob,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            np.int32(model.vocab_size),
            np.int32(model.unk_id),
            np.int32(model.add_dummy_prefix),
            np.int32(model.remove_extra_whitespaces),
            np.int32(model.escape_whitespaces),
        )
        if not self._handle:
            raise RuntimeError("sptok_create failed")

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.sptok_free(self._handle)
            self._handle = None

    def encode(self, text: str, *, dummy_prefix: bool = True) -> list:
        data = text.encode("utf-8")
        cap = max(64, 4 * len(data) + 16)
        out = np.empty(cap, np.int32)
        n = self._lib.sptok_encode(
            self._handle, data, np.int32(len(data)), np.int32(dummy_prefix),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), np.int32(cap),
        )
        if n < 0:  # buffer too small (shouldn't happen at 4x bytes)
            cap = -n
            out = np.empty(cap, np.int32)
            n = self._lib.sptok_encode(
                self._handle, data, np.int32(len(data)), np.int32(dummy_prefix),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), np.int32(cap),
            )
        return out[:n].tolist()
