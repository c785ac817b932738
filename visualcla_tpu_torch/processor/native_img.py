"""ctypes bindings for the native image preprocessing core (``csrc/host/imgproc.cpp``).

(The reference's equivalent native dependency is Pillow's C resampling under
CLIPImageProcessor — modeling_utils.py:149-154.)

Same lazy-build pattern as text/native_tok.py; falls back to the numpy path in
``pil_resample`` when no toolchain is available (ImageProcessor handles that).
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..host_build import load_host_library

_LIB_LOCK = threading.Lock()
_LIB = None

_FILTERS = {"bicubic": 0, "bilinear": 1}


def _load() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        if os.environ.get("VISUALCLA_NO_NATIVE"):
            raise RuntimeError("native imgproc disabled via VISUALCLA_NO_NATIVE")
        lib = load_host_library("imgproc")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32 = ctypes.c_int32
        lib.imgproc_resize_u8.restype = i32
        lib.imgproc_resize_u8.argtypes = [u8p, i32, i32, i32, i32, i32, i32, u8p]
        lib.imgproc_clip_preprocess.restype = i32
        lib.imgproc_clip_preprocess.argtypes = [
            u8p, i32, i32, i32, i32, i32, i32, f32p, f32p, f32p,
        ]
        _LIB = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def resize_u8(img: np.ndarray, size, filter_name: str = "bicubic") -> np.ndarray:
    """PIL-exact resize; img (H, W, C) uint8, size (width, height) PIL-style."""
    lib = _load()
    w2, h2 = size
    img = np.ascontiguousarray(img, np.uint8)
    h, w, ch = img.shape
    out = np.empty((h2, w2, ch), np.uint8)
    rc = lib.imgproc_resize_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(h), np.int32(w), np.int32(ch), np.int32(h2), np.int32(w2),
        np.int32(_FILTERS[filter_name]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f"imgproc_resize_u8 failed ({rc})")
    return out


def clip_preprocess(
    img: np.ndarray, shortest: int, crop: int, mean, std,
    filter_name: str = "bicubic",
) -> np.ndarray:
    """Fused resize+crop+rescale+normalize+CHW -> (C, crop, crop) float32."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, ch = img.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((ch, crop, crop), np.float32)
    rc = lib.imgproc_clip_preprocess(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.int32(h), np.int32(w), np.int32(ch), np.int32(shortest),
        np.int32(crop), np.int32(_FILTERS[filter_name]),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise RuntimeError(f"imgproc_clip_preprocess failed ({rc})")
    return out
