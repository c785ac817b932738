"""Plain reference of CLIP's image preprocessing, in NumPy.

The shortest edge is resized to the tower's size (the long edge truncated to
an integer), bicubic with a = -0.5 and the kernel widened by the scale when
shrinking, horizontally and then vertically, each pass rounded to 8 bits as
an 8-bit image is; then a centred crop, the 1/255 rescale and CLIP's mean and
deviation.  The passes are computed in float64, not in Pillow's fixed point,
so a pixel may land one level away from Pillow's.
"""
from __future__ import annotations

import numpy as np

MEAN = np.asarray((0.48145466, 0.4578275, 0.40821073), np.float32)
STD = np.asarray((0.26862954, 0.26130258, 0.27577711), np.float32)


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = ((x - 5.0) * x + 8.0) * x * a - 4.0 * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) resampling matrix, each row summing to one."""
    scale = n_in / n_out
    stretch = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale
    src = np.arange(n_in) + 0.5
    w = _cubic((src[None, :] - centre[:, None]) / stretch)
    return w / w.sum(axis=1, keepdims=True)


def _pass(img: np.ndarray, n_out: int) -> np.ndarray:
    """Resample axis 0 of an (H, W, C) 8-bit image, rounded to 8 bits."""
    out = np.tensordot(_weights(img.shape[0], n_out), img.astype(np.float64), axes=(1, 0))
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def preprocess(image: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (3, size, size) float32."""
    h, w = image.shape[:2]
    if h <= w:
        nh, nw = size, int(size * w / h)
    else:
        nh, nw = int(size * h / w), size
    x = _pass(image.transpose(1, 0, 2), nw).transpose(1, 0, 2) if nw != w else image
    x = _pass(x, nh) if nh != h else x
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[top:top + size, left:left + size].astype(np.float32) * np.float32(1 / 255)
    return ((x - MEAN) / STD).transpose(2, 0, 1)
