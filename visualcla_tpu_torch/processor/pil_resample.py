"""Pillow-exact separable image resampling on uint8 numpy arrays.

The reference preprocesses with HF ``CLIPImageProcessor``, whose resize path is
PIL ``Image.resize(..., BICUBIC)`` on uint8 (reference chat path:
models/visualcla/modeling_utils.py:149-154 -> transformers image_transforms).
Token-identical greedy parity therefore requires reproducing Pillow's
fixed-point resampling bit-for-bit, not a float approximation.

This reimplements the algorithm of Pillow's ``Resample.c`` (two quantized 8bpc
passes: horizontal then vertical; per-output-pixel kernels normalized in double
then rounded to 1<<22 fixed point; accumulators seeded with the 0.5 ulp) as
vectorized integer numpy.  A C++ twin lives in ``csrc/host/`` for the host serving
path.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2  # Pillow's 8bpc fixed-point precision (=22)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5), support 2."""
    a = -0.5
    ax = np.abs(x)
    r = np.where(
        ax < 1.0,
        ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        np.where(ax < 2.0, (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a, 0.0),
    )
    return r


def _bilinear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


_FILTERS = {
    "bicubic": (_bicubic, 2.0),
    "bilinear": (_bilinear, 1.0),
}


def _coeffs(in_size: int, out_size: int, filter_name: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-output-pixel fixed-point kernels, exactly like precompute_coeffs.

    Returns (xmin (out,), kk (out, ksize) int64, ksize).
    """
    fn, support0 = _FILTERS[filter_name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1

    xx = np.arange(out_size, dtype=np.float64)
    center = (xx + 0.5) * scale
    xmin = np.maximum(0, np.floor(center - support)).astype(np.int64)
    xmax = np.minimum(in_size, np.ceil(center + support)).astype(np.int64) - xmin

    ss = 1.0 / filterscale
    offs = np.arange(ksize, dtype=np.float64)  # (ksize,)
    pos = (offs[None, :] + xmin[:, None].astype(np.float64) - center[:, None] + 0.5) * ss
    w = fn(pos)
    valid = offs[None, :] < xmax[:, None]
    w = np.where(valid, w, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    wsum[wsum == 0.0] = 1.0
    w = w / wsum
    # Pillow: kk[x] = lround(w * (1 << PRECISION_BITS)); lround rounds half away
    # from zero (C semantics), unlike numpy's bankers rounding.
    scaled = w * (1 << PRECISION_BITS)
    kk = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return xmin, kk.astype(np.int64), ksize


def _clip8(acc: np.ndarray) -> np.ndarray:
    """Pillow clip8: arithmetic shift then clamp to [0, 255]."""
    v = acc >> PRECISION_BITS
    return np.clip(v, 0, 255).astype(np.uint8)


def _resample_axis0(img: np.ndarray, out_size: int, filter_name: str) -> np.ndarray:
    """Resample along axis 0 of (H, W, C) uint8 -> (out_size, W, C) uint8."""
    in_size = img.shape[0]
    xmin, kk, ksize = _coeffs(in_size, out_size, filter_name)
    # dense (out, in) integer kernel matrix
    M = np.zeros((out_size, in_size), np.int64)
    rows = np.repeat(np.arange(out_size), ksize)
    cols = (xmin[:, None] + np.arange(ksize)[None, :]).reshape(-1)
    vals = kk.reshape(-1)
    ok = cols < in_size
    np.add.at(M, (rows[ok], cols[ok]), vals[ok])
    acc = np.tensordot(M, img.astype(np.int64), axes=([1], [0]))  # (out, W, C)
    acc += 1 << (PRECISION_BITS - 1)
    return _clip8(acc)


def resize_uint8(
    img: np.ndarray, size: Tuple[int, int], filter_name: str = "bicubic"
) -> np.ndarray:
    """PIL ``Image.resize(size=(width, height), resample)`` equivalent.

    img: (H, W, C) uint8.  size: (width, height) like PIL.  Horizontal pass
    first, then vertical — matching ImagingResample's pass order so the
    intermediate quantization is identical.
    """
    w2, h2 = size
    if img.ndim == 2:
        img = img[:, :, None]
    h, w = img.shape[:2]
    if (w2, h2) == (w, h):
        return img.copy()
    out = img
    if w2 != w:
        out = _resample_axis0(out.transpose(1, 0, 2), w2, filter_name).transpose(1, 0, 2)
    if h2 != h:
        out = _resample_axis0(out, h2, filter_name)
    return out


def shortest_edge_size(height: int, width: int, shortest: int) -> Tuple[int, int]:
    """HF get_resize_output_image_size(default_to_square=False): returns
    (new_height, new_width) with the short side == ``shortest`` and the long
    side int-truncated."""
    short, long = (height, width) if height <= width else (width, height)
    new_short = shortest
    new_long = int(new_short * long / short)
    return (new_short, new_long) if height <= width else (new_long, new_short)


def center_crop(img: np.ndarray, crop_h: int, crop_w: int) -> np.ndarray:
    """HF center_crop semantics on (H, W, C): crop, zero-padding if smaller."""
    h, w = img.shape[:2]
    top = (h - crop_h) // 2
    left = (w - crop_w) // 2
    if top >= 0 and left >= 0:
        return img[top : top + crop_h, left : left + crop_w]
    out = np.zeros((crop_h, crop_w) + img.shape[2:], img.dtype)
    src_t, dst_t = max(top, 0), max(-top, 0)
    src_l, dst_l = max(left, 0), max(-left, 0)
    hh = min(h, crop_h + top) - src_t
    ww = min(w, crop_w + left) - src_l
    out[dst_t : dst_t + hh, dst_l : dst_l + ww] = img[src_t : src_t + hh, src_l : src_l + ww]
    return out
