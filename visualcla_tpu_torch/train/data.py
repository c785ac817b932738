"""Multimodal instruction-tuning data pipeline (port of
visualcla_tpu/train/data.py onto this package's own ``text/`` and
``processor/``).

The reference ships no training code or loaders — its README describes the data
only (README_EN.md:85-91: image-text pairs for pretraining; multimodal + text
instructions for SFT).  This loader covers both stages:

Record formats (JSON list or JSONL):
  {"image": "path.jpg"|null, "instruction": "...", "response": "...",
   "history": [...]}                                   # SFT
  {"image": "path.jpg", "caption": "..."}              # pretraining pairs
                                                        (caption == response,
                                                         fixed caption prompt)

Examples are rendered with the exact chat prompt protocol (text/prompt.py), the
prompt region label-masked (-100), response + EOS supervised; batches pad to
length buckets and prefetch on a background thread, which hands its error to
the consumer.  An image path may hold a ``.npy`` uint8 (H, W, 3) array.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator, List

import numpy as np

from ..text.prompt import encoding_text, img_marker_positions

IGNORE = -100
CAPTION_PROMPT = "描述这张图片。"  # fixed instruction for caption pretraining pairs


def load_records(path: str) -> List[dict]:
    with open(path) as f:
        head = f.read(1)
        f.seek(0)
        if head == "[":
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


class ExampleBuilder:
    def __init__(self, tokenizer, image_processor, num_patch: int,
                 image_dir: str = "", max_len: int = 2048):
        self.tok = tokenizer
        self.ip = image_processor
        self.num_patch = num_patch
        self.image_dir = image_dir
        self.max_len = max_len

    def build(self, rec: dict):
        """-> dict(input_ids, labels, img_start_pos, pixel_values|None) or None."""
        instruction = rec.get("instruction") or (CAPTION_PROMPT if "caption" in rec else None)
        response = rec.get("response") or rec.get("caption") or rec.get("output")
        if instruction is None or response is None:
            return None
        history = rec.get("history") or []
        has_image = bool(rec.get("image"))
        if has_image:
            enc = encoding_text(history, instruction, self.num_patch, self.tok)
        else:
            # text-only instruction: same protocol without the image placeholder
            enc = self._text_only(history, instruction)
        prompt_ids = enc["input_ids"][0].tolist()
        resp_ids = self.tok.encode(response) + [self.tok.eos_token_id]
        ids = (prompt_ids + resp_ids)[: self.max_len]
        labels = ([IGNORE] * len(prompt_ids) + resp_ids)[: self.max_len]
        pixels = None
        img_pos = -1
        if has_image:
            path = os.path.join(self.image_dir, rec["image"])
            pixels = self.ip.preprocess_one(path)
            img_pos = int(
                img_marker_positions(
                    np.asarray(ids)[None], self.tok.img_start_token_id
                )[0]
            )
        return {"input_ids": np.asarray(ids, np.int32),
                "labels": np.asarray(labels, np.int32),
                "img_start_pos": img_pos,
                "pixel_values": pixels}

    def _text_only(self, history, instruction):
        from ..text.prompt import PROMPT_TEMPLATE_MULTIMODAL, SEP_AFTER, SEP_BEFORE

        prompt = f"{SEP_BEFORE}Instruction: \n{instruction}{SEP_AFTER}{SEP_BEFORE}Response:"
        for hist in history[::-1]:
            if hist["type"] == "instruction":
                prompt = (f"{SEP_BEFORE}Instruction: \n{hist['value']}{SEP_AFTER}"
                          + prompt)
            else:
                prompt = f"{SEP_BEFORE}Response:{hist['value']}{SEP_AFTER}" + prompt
        return self.tok(self.tok.bos_token + PROMPT_TEMPLATE_MULTIMODAL + prompt)


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class DataLoader:
    """Shuffled, bucketed, prefetching batch iterator."""

    def __init__(
        self,
        records: List[dict],
        builder: ExampleBuilder,
        *,
        batch_size: int,
        image_size: int,
        seed: int = 0,
        buckets=(128, 256, 512, 1024, 2048),
        pad_id: int = 0,
        prefetch: int = 2,
        drop_remainder: bool = True,
    ):
        self.records = records
        self.builder = builder
        self.batch_size = batch_size
        self.image_size = image_size
        self.seed = seed
        self.buckets = buckets
        self.pad_id = pad_id
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):  # producer died: re-raise here
                raise item
            yield item

    def _produce(self, q: queue.Queue):
        try:
            rng = np.random.default_rng(self.seed)
            order = rng.permutation(len(self.records))
            batch: List[dict] = []
            for idx in order:
                ex = self.builder.build(self.records[int(idx)])
                if ex is None:
                    continue
                batch.append(ex)
                if len(batch) == self.batch_size:
                    q.put(self._collate(batch))
                    batch = []
            if batch and not self.drop_remainder:
                q.put(self._collate(batch))
            q.put(None)
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            q.put(e)

    def _collate(self, batch: List[dict]) -> dict:
        B = len(batch)
        L = _bucket(max(len(e["input_ids"]) for e in batch), self.buckets)
        ids = np.full((B, L), self.pad_id, np.int32)
        labels = np.full((B, L), IGNORE, np.int32)
        mask = np.zeros((B, L), np.int32)
        img_pos = np.full((B,), -1, np.int32)
        pixels = np.zeros((B, 3, self.image_size, self.image_size), np.float32)
        for i, e in enumerate(batch):
            n = len(e["input_ids"])
            ids[i, :n] = e["input_ids"]  # right-pad: loss masks pads anyway
            labels[i, :n] = e["labels"]
            mask[i, :n] = 1
            img_pos[i] = e["img_start_pos"]
            if e["pixel_values"] is not None:
                pixels[i] = e["pixel_values"]
        return {"input_ids": ids, "attention_mask": mask, "labels": labels,
                "img_start_pos": img_pos, "pixel_values": pixels}
