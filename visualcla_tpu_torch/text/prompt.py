"""Chat prompt protocol — byte-identical to the reference.

Rebuilds the Alpaca-style multimodal prompt of ``encoding_text``
(reference models/visualcla/modeling_utils.py:28-34, 49-80):

- header ``PROMPT_TEMPLATE_MULTIMODAL``;
- turns are ``### Instruction: \n{text}\n\n`` / ``### Response:{text}\n\n``;
- the ``<image_placeholder>`` line appears ONLY in the first instruction of the
  conversation and expands to ``<img>`` + ``<img_token>``*num_patch + ``</img>``;
- history is replayed newest->oldest by prepending (same net order);
- BOS is prepended as text and tokenized with ``add_special_tokens=False``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

PROMPT_TEMPLATE_MULTIMODAL = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
)

SEP_BEFORE = "### "
SEP_AFTER = "\n\n"

IMAGE_PLACEHOLDER = "<image_placeholder>"

History = List[Dict[str, str]]


def instruction_block(text: str, with_image) -> str:
    """``with_image`` is a bool (legacy: one placeholder line) or an int K
    (K placeholder lines — one per image attached to this turn, in order;
    the reference's webui plugin supports the same multi-image-per-turn
    protocol via inline <img> tags, script.py:68-95)."""
    k = int(with_image)
    body = "\n".join([IMAGE_PLACEHOLDER] * k + [text]) if k else text
    return f"{SEP_BEFORE}Instruction: \n{body}{SEP_AFTER}"


def response_block(text: str) -> str:
    return f"{SEP_BEFORE}Response:{text}{SEP_AFTER}"


def _entry_images(hist: Dict) -> int:
    """Image count a replayed instruction entry carries: an explicit
    ``images`` count wins; the legacy ``first_instruction`` flag means 1."""
    if "images" in hist:
        return int(hist["images"])
    return 1 if "first_instruction" in hist else 0


def build_prompt(history: History, text: str, num_images=None) -> str:
    """The prompt string for a new user turn ``text`` given ``history``
    (list of {'type': 'instruction'|'response', 'value': str}; the first
    instruction carries a 'first_instruction' key, later instructions may
    carry an 'images' count).

    ``num_images=None`` keeps the reference behavior byte-identical: the
    placeholder appears exactly when this is the conversation's first
    instruction (modeling_utils.py:59-74).  An int makes THIS turn carry
    that many placeholders regardless of position — the multi-image
    extension the reference only has in its webui plugin."""
    if num_images is None:
        num_images = 1 if history == [] else 0
    prompt = instruction_block(text, with_image=num_images)
    prompt += f"{SEP_BEFORE}Response:"
    for hist in history[::-1]:
        if hist["type"] == "instruction":
            prompt = instruction_block(
                hist["value"], with_image=_entry_images(hist)
            ) + prompt
        elif hist["type"] == "response":
            prompt = response_block(hist["value"]) + prompt
        else:
            raise ValueError(
                "history entry 'type' must be 'instruction' or 'response', "
                f"got {hist['type']!r}"
            )
    return PROMPT_TEMPLATE_MULTIMODAL + prompt


def encoding_text(history: History, text: str, num_patch: int, tokenizer,
                  num_images=None):
    """Prompt -> token ids, matching the reference's ``encoding_text``
    (modeling_utils.py:49-80).  Returns {'input_ids', 'attention_mask'} (1, S)
    numpy arrays.  ``num_images`` as in :func:`build_prompt`."""
    prompt_text = build_prompt(history, text, num_images=num_images)
    prompt_text = prompt_text.replace(
        IMAGE_PLACEHOLDER,
        tokenizer.img_start_token + num_patch * tokenizer.img_token + tokenizer.img_end_token,
    )
    input_text = tokenizer.bos_token + prompt_text
    return tokenizer(input_text, add_special_tokens=False)


def img_marker_positions(input_ids: Sequence[int], img_start_token_id: int) -> np.ndarray:
    """(B,) position of <img> per row (-1 if absent) — host-side helper."""
    arr = np.asarray(input_ids)
    hits = arr == img_start_token_id
    pos = hits.argmax(axis=-1)
    return np.where(hits.any(axis=-1), pos, -1).astype(np.int32)


def all_img_marker_positions(input_ids: Sequence[int],
                             img_start_token_id: int) -> np.ndarray:
    """(B, K) positions of EVERY <img> per row, K = max count over the batch,
    right-padded with -1 (-1 slots are skipped by the (B, K) splice,
    models/visualcla.py multimodal_embeds).  Order is prompt order, which is
    the order the images must be stacked in pixel_values."""
    arr = np.atleast_2d(np.asarray(input_ids))
    rows = [np.flatnonzero(r == img_start_token_id) for r in arr]
    K = max((len(p) for p in rows), default=0)
    K = max(K, 1)
    out = np.full((arr.shape[0], K), -1, np.int32)
    for i, p in enumerate(rows):
        out[i, : len(p)] = p
    return out
