"""CLIP image preprocessing, the host-exact path (the port's own copy of
visualcla_tpu/processor/image.py; the JAX package's fused on-device path,
``device_preprocess``, is not ported yet: ROADMAP, open item 8).

Replaces HF ``CLIPImageProcessor`` as used by the reference
(models/visualcla/modeling_utils.py:130-131, 149-154): shortest-edge bicubic
resize (PIL-exact, see ``pil_resample``), center crop, 1/255 rescale, CLIP
mean/std normalize, HWC->CHW.

``__call__``: host numpy (or the native core), bit-exact vs the HF/PIL stack.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Union

import numpy as np

from .pil_resample import center_crop, resize_uint8, shortest_edge_size

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


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
        """Accept PIL.Image / path / (H, W, 3) uint8 array."""
        if isinstance(image, str):
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
