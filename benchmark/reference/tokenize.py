"""Plain reference of the chat prompt and its token ids.

VisualCLA's single-turn multimodal prompt (the published ``encoding_text``):
BOS, the Alpaca header, ``### Instruction: \\n``, ``<img>``, one
``<img_token>`` per image embedding, ``</img>``, a newline, the instruction,
``\\n\\n### Response:``.  It is tokenized as HF's legacy slow LLaMA tokenizer
does: the text is split on the special tokens, and each text segment gets
SentencePiece's dummy ``▁`` prefix, its spaces escaped to ``▁``, BPE merges
by score (the highest first, the leftmost among equals), and byte fallback
for what is left outside the table.  The table is ``harness/vocab.py``'s.
"""
from __future__ import annotations

import re
from typing import Dict, List

from ..harness.vocab import CONTROL, N_BYTES, SPECIALS, pieces_and_scores

HEADER = ("Below is an instruction that describes a task. "
          "Write a response that appropriately completes the request.\n\n")


class Tokenizer:
    def __init__(self, vocab_size: int):
        pieces, scores, _ = pieces_and_scores(vocab_size)
        first = len(CONTROL) + N_BYTES
        self.piece_id: Dict[str, int] = {p: first + i for i, p in enumerate(pieces)}
        self.score: Dict[str, float] = dict(zip(pieces, scores))
        n = first + len(pieces)
        self.special_id = {"<s>": 1, "</s>": 2}
        self.special_id.update({t: n + i for i, t in enumerate(SPECIALS)})
        self.bos, self.eos = 1, 2
        self.pad = self.special_id["<pad>"]
        self._split = re.compile("(" + "|".join(
            re.escape(t) for t in sorted(self.special_id, key=len, reverse=True)) + ")")

    def _segment(self, text: str) -> List[int]:
        syms = list(("▁" + text).replace(" ", "▁"))
        while len(syms) > 1:
            best, at = None, -1
            for i in range(len(syms) - 1):
                s = self.score.get(syms[i] + syms[i + 1])
                if s is not None and (best is None or s > best):
                    best, at = s, i
            if at < 0:
                break
            syms[at:at + 2] = [syms[at] + syms[at + 1]]
        ids: List[int] = []
        for s in syms:
            if s in self.piece_id:
                ids.append(self.piece_id[s])
            else:  # byte fallback: <0x00> is id 3
                ids.extend(len(CONTROL) + b for b in s.encode("utf-8"))
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for part in self._split.split(text):
            if not part:
                continue
            if part in self.special_id:
                ids.append(self.special_id[part])
            else:
                ids.extend(self._segment(part))
        return ids

    def chat_prompt(self, instruction: str, num_image_tokens: int) -> List[int]:
        """The single-turn prompt's ids around one image."""
        text = ("<s>" + HEADER + "### Instruction: \n<img>" + "<img_token>" * num_image_tokens
                + "</img>\n" + instruction + "\n\n### Response:")
        return self.encode(text)

    def img_start(self, ids: List[int]) -> int:
        return ids.index(self.special_id["<img>"])
