"""VisualCLAProcessor — bundles tokenizer + image processor.

Mirrors the reference's ``VisualCLAProcessor``
(models/visualcla/processing_visualcla.py:11-131): ``__call__(text, images)``
returns input_ids / attention_mask / pixel_values; either input is optional.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .image import ImageProcessor


class VisualCLAProcessor:
    def __init__(self, image_processor: ImageProcessor, tokenizer):
        self.image_processor = image_processor
        self.tokenizer = tokenizer

    def __call__(
        self,
        text=None,
        images=None,
        add_special_tokens: bool = False,
        **kwargs,
    ):
        if text is None and images is None:
            raise ValueError("You have to specify either text or images.")
        out = {}
        if text is not None:
            if isinstance(text, str):
                text = [text]
            encs = [
                self.tokenizer.encode(t, add_special_tokens=add_special_tokens)
                for t in text
            ]
            max_len = max(len(e) for e in encs)
            pad_id = self.tokenizer.pad_token_id
            ids = np.full((len(encs), max_len), pad_id, np.int32)
            mask = np.zeros((len(encs), max_len), np.int32)
            # LEFT-pad (decoder-only convention): the Engine honors leading
            # pads (pad_prompt masks them), so batched uneven prompts decode
            # like their single-row equivalents
            for i, e in enumerate(encs):
                ids[i, max_len - len(e):] = e
                mask[i, max_len - len(e):] = 1
            out["input_ids"] = ids
            out["attention_mask"] = mask
        if images is not None:
            out["pixel_values"] = self.image_processor(images)["pixel_values"]
        return out

    def batch_decode(self, sequences, **kwargs):
        return [self.tokenizer.decode(s, **kwargs) for s in sequences]

    def decode(self, ids, **kwargs):
        return self.tokenizer.decode(ids, **kwargs)
