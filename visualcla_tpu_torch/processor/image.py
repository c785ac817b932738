"""CLIP image preprocessing (the port's own copy of
visualcla_tpu/processor/image.py): the host-exact path and the fused
on-device path ``device_preprocess``.

Replaces HF ``CLIPImageProcessor`` as used by the reference
(models/visualcla/modeling_utils.py:130-131, 149-154): shortest-edge bicubic
resize (PIL-exact, see ``pil_resample``), center crop, 1/255 rescale, CLIP
mean/std normalize, HWC->CHW.

``__call__``: host numpy (or the native core), bit-exact vs the HF/PIL stack.
``device_preprocess``: plain torch on the caller's device (resize as two
float matmuls, no uint8 rounding between the passes), close to the host path.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .pil_resample import PRECISION_BITS, _coeffs, center_crop, resize_uint8, shortest_edge_size

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
NPY_MAGIC = b"\x93NUMPY"


class ImageProcessor:
    """HF CLIPImageProcessor-compatible preprocessing."""

    def __init__(
        self,
        image_size: int = 224,
        crop_size: Optional[int] = None,
        image_mean: Sequence[float] = CLIP_MEAN,
        image_std: Sequence[float] = CLIP_STD,
        do_resize: bool = True,
        do_center_crop: bool = True,
        do_rescale: bool = True,
        do_normalize: bool = True,
        rescale_factor: float = 1.0 / 255.0,
        resample: str = "bicubic",
        patch_size: int = 14,
        use_native: bool = True,
    ):
        self.image_size = image_size
        self.crop_size = crop_size if crop_size is not None else image_size
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)
        self.do_resize = do_resize
        self.do_center_crop = do_center_crop
        self.do_rescale = do_rescale
        self.do_normalize = do_normalize
        self.rescale_factor = rescale_factor
        self.resample = resample
        self.patch_size = patch_size  # attached by the reference (modeling_utils.py:131)
        self._native = False
        if use_native:
            try:
                from . import native_img

                self._native = native_img.available()
            except Exception:
                self._native = False

    # -- host path ------------------------------------------------------------

    def _to_rgb_array(self, image) -> np.ndarray:
        """Accept PIL.Image / path / (H, W, 3) uint8 array.  A path may also
        hold a ``.npy`` uint8 array (read with numpy alone, whatever its
        name), for machines without Pillow."""
        if isinstance(image, str):
            with open(image, "rb") as f:
                is_npy = f.read(len(NPY_MAGIC)) == NPY_MAGIC
            if is_npy:
                image = np.load(image, allow_pickle=False)
            else:
                from PIL import Image

                image = Image.open(image)
        if hasattr(image, "convert"):  # PIL image
            image = np.asarray(image.convert("RGB"))
        image = np.asarray(image)
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        if image.dtype != np.uint8:
            raise ValueError(f"expected uint8 image, got {image.dtype}")
        return image

    def preprocess_one(self, image) -> np.ndarray:
        """One image -> (3, crop, crop) float32."""
        arr = self._to_rgb_array(image)
        if (self._native and self.do_resize and self.do_center_crop
                and self.do_rescale and self.do_normalize
                and self.rescale_factor == 1.0 / 255.0):
            from . import native_img

            return native_img.clip_preprocess(
                arr, self.image_size, self.crop_size,
                self.image_mean, self.image_std, self.resample,
            )
        if self.do_resize:
            h, w = arr.shape[:2]
            nh, nw = shortest_edge_size(h, w, self.image_size)
            arr = resize_uint8(arr, (nw, nh), self.resample)
        if self.do_center_crop:
            arr = center_crop(arr, self.crop_size, self.crop_size)
        x = arr.astype(np.float32)
        if self.do_rescale:
            x = x * np.float32(self.rescale_factor)
        if self.do_normalize:
            x = (x - np.asarray(self.image_mean, np.float32)) / np.asarray(
                self.image_std, np.float32
            )
        return x.transpose(2, 0, 1)

    def __call__(self, images, return_tensors: str = "np"):
        if not isinstance(images, (list, tuple)):
            images = [images]
        pixel_values = np.stack([self.preprocess_one(im) for im in images])
        return {"pixel_values": pixel_values}

    # -- config I/O (reads the reference checkpoints' preprocessor_config.json)

    @classmethod
    def from_pretrained(cls, path: str) -> "ImageProcessor":
        cfg_path = (
            os.path.join(path, "preprocessor_config.json")
            if os.path.isdir(path)
            else path
        )
        with open(cfg_path) as f:
            d = json.load(f)
        size = d.get("size", 224)
        if isinstance(size, dict):
            size = size.get("shortest_edge") or size.get("height", 224)
        crop = d.get("crop_size", size)
        if isinstance(crop, dict):
            crop = crop.get("height", 224)
        # PIL resampling filter codes (Image.Resampling): 2=bilinear,
        # 3=bicubic — CLIP checkpoints ship 3, but honor bilinear configs
        resample = {2: "bilinear", 3: "bicubic"}.get(d.get("resample", 3),
                                                     "bicubic")
        return cls(
            image_size=size,
            crop_size=crop,
            image_mean=d.get("image_mean", CLIP_MEAN),
            image_std=d.get("image_std", CLIP_STD),
            do_resize=d.get("do_resize", True),
            do_center_crop=d.get("do_center_crop", True),
            do_rescale=d.get("do_rescale", True),
            do_normalize=d.get("do_normalize", True),
            rescale_factor=d.get("rescale_factor", 1.0 / 255.0),
            resample=resample,
        )

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
            json.dump(
                {
                    "image_processor_type": "CLIPImageProcessor",
                    "size": {"shortest_edge": self.image_size},
                    "crop_size": {"height": self.crop_size, "width": self.crop_size},
                    "image_mean": list(self.image_mean),
                    "image_std": list(self.image_std),
                    "do_resize": self.do_resize,
                    "do_center_crop": self.do_center_crop,
                    "do_rescale": self.do_rescale,
                    "do_normalize": self.do_normalize,
                    "rescale_factor": self.rescale_factor,
                    "resample": 3,
                },
                f,
                indent=2,
            )


# ---------------------------------------------------------------------------
# fused on-device path
# ---------------------------------------------------------------------------

def _device_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Float resample matrix (out, in): Pillow's kernel and normalization
    without its 8-bit fixed-point quantization."""
    xmin, kk, ksize = _coeffs(in_size, out_size, "bicubic")
    M = np.zeros((out_size, in_size), np.float32)
    rows = np.repeat(np.arange(out_size), ksize)
    cols = (xmin[:, None] + np.arange(ksize)[None, :]).reshape(-1)
    vals = (kk.astype(np.float64) / (1 << PRECISION_BITS)).astype(np.float32).reshape(-1)
    ok = cols < in_size
    np.add.at(M, (rows[ok], cols[ok]), vals[ok])
    return M


def device_preprocess(images_u8, *, out_size: int = 224, mean=CLIP_MEAN, std=CLIP_STD,
                      dtype=None) -> torch.Tensor:
    """(B, H, W, 3) uint8 images (one size) -> (B, 3, out_size, out_size)
    pixels on the images' device: shortest-edge bicubic resize as two fp32
    matmuls (horizontal, then vertical, as the host path), clip to [0, 255],
    center crop, 1/255, CLIP normalize; float32 or ``dtype``."""
    x = torch.as_tensor(images_u8)
    B, H, W, C = x.shape
    nh, nw = shortest_edge_size(H, W, out_size)
    Mh = torch.from_numpy(_device_bicubic_matrix(H, nh)).to(x.device)  # (nh, H)
    Mw = torch.from_numpy(_device_bicubic_matrix(W, nw)).to(x.device)  # (nw, W)
    x = x.float()
    x = torch.einsum("ow,bhwc->bhoc", Mw, x)
    x = torch.einsum("oh,bhwc->bowc", Mh, x)
    x = x.clamp(0.0, 255.0)
    top, left = (nh - out_size) // 2, (nw - out_size) // 2
    x = x[:, top:top + out_size, left:left + out_size, :] * (1.0 / 255.0)
    x = (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)
    x = x.permute(0, 3, 1, 2)
    return x.to(dtype) if dtype is not None else x.contiguous()
