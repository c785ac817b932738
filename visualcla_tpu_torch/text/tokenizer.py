"""VisualCLA tokenizer: SentencePiece model + the 4 added special tokens.

Mirrors the reference's tokenizer setup (models/visualcla/modeling_utils.py:94-102):
``LlamaTokenizer`` with added ``<pad>`` plus image markers ``<img>``, ``</img>``,
``<img_token>`` exposed as ``img_start_token`` / ``img_end_token`` / ``img_token``
attributes.  Encoding semantics replicate HF's *legacy* slow-tokenizer path (the
transformers 4.30/4.31 era the reference pins): text is split on added/special
tokens first, and every text segment gets the SP dummy-prefix ``▁``.

Backends, in preference order:
1. native C++ core (``csrc/host/sptok.cpp``) via ctypes — production path;
2. pure-Python ``sp_bpe`` — always available, bit-identical by test.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence, Union

from .sp_bpe import decode_pieces, encode as sp_encode
from .sp_model import SPModel

DEFAULT_SPECIALS = ("<pad>", "<img>", "</img>", "<img_token>")


class VisualCLATokenizer:
    """SentencePiece tokenizer + added tokens, HF-compatible surface."""

    def __init__(
        self,
        model: SPModel,
        added_tokens: Optional[Dict[str, int]] = None,
        *,
        legacy: bool = True,
        use_native: bool = True,
    ):
        self.sp = model
        self.legacy = legacy
        self.added_tokens: Dict[str, int] = dict(added_tokens or {})
        self._id_to_added = {i: t for t, i in self.added_tokens.items()}
        self._split_re = None
        self._native = None
        if use_native:
            try:
                from . import native_tok

                self._native = native_tok.NativeEncoder(model)
            except Exception:
                self._native = None
        self._rebuild_split_re()

    # -- vocab management ---------------------------------------------------

    def _rebuild_split_re(self):
        toks = sorted(self.added_tokens, key=len, reverse=True)
        control = [
            p for p, t in zip(self.sp.pieces, self.sp.types) if t == 3
        ]  # CONTROL pieces (<s>, </s>) also split like specials
        all_toks = toks + control
        if all_toks:
            self._split_re = re.compile(
                "(" + "|".join(re.escape(t) for t in all_toks) + ")"
            )
        else:
            self._split_re = None

    def add_special_tokens(self, tokens: Sequence[str]) -> int:
        """Append tokens after the SP vocab (HF ``add_tokens`` numbering).

        New ids skip any id already taken by a pre-loaded added token
        (added_tokens.json may hold a subset or have id gaps) — a collision
        would alias two specials onto one id and corrupt prompts."""
        added = 0
        taken = set(self.added_tokens.values())
        for t in tokens:
            if t not in self.added_tokens and t not in self.sp.piece_to_id:
                nid = self.sp.vocab_size + len(self.added_tokens)
                while nid in taken:
                    nid += 1
                self.added_tokens[t] = nid
                taken.add(nid)
                added += 1
        self._id_to_added = {i: t for t, i in self.added_tokens.items()}
        self._rebuild_split_re()
        return added

    def __len__(self) -> int:
        return self.sp.vocab_size + len(self.added_tokens)

    @property
    def vocab_size(self) -> int:
        return self.sp.vocab_size

    # -- special-token accessors (reference modeling_utils.py:96-102) -------

    @property
    def bos_token_id(self) -> int:
        return self.sp.bos_id

    @property
    def eos_token_id(self) -> int:
        return self.sp.eos_id

    @property
    def bos_token(self) -> str:
        return self.sp.pieces[self.sp.bos_id]

    @property
    def eos_token(self) -> str:
        return self.sp.pieces[self.sp.eos_id]

    @property
    def pad_token(self) -> str:
        return "<pad>"

    @property
    def pad_token_id(self) -> int:
        return self.convert_token_to_id("<pad>")

    @property
    def img_start_token(self) -> str:
        return "<img>"

    @property
    def img_end_token(self) -> str:
        return "</img>"

    @property
    def img_token(self) -> str:
        return "<img_token>"

    @property
    def img_start_token_id(self) -> int:
        return self.convert_token_to_id("<img>")

    @property
    def img_end_token_id(self) -> int:
        return self.convert_token_to_id("</img>")

    @property
    def img_token_id(self) -> int:
        return self.convert_token_to_id("<img_token>")

    def convert_token_to_id(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        return self.sp.piece_to_id.get(token, self.sp.unk_id)

    def convert_id_to_token(self, idx: int) -> str:
        if idx in self._id_to_added:
            return self._id_to_added[idx]
        if 0 <= idx < self.sp.vocab_size:
            return self.sp.pieces[idx]
        return self.sp.pieces[self.sp.unk_id]

    # -- encode / decode ----------------------------------------------------

    def _encode_segment(self, text: str, dummy_prefix: bool) -> List[int]:
        if self._native is not None:
            return self._native.encode(text, dummy_prefix=dummy_prefix)
        return sp_encode(self.sp, text, dummy_prefix=dummy_prefix)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """Tokenize, splitting out added/control tokens.  ``legacy=True``
        applies the dummy prefix to every segment (HF legacy Llama behavior —
        what the reference stack does for its prompt strings)."""
        ids: List[int] = []
        parts = self._split_re.split(text) if self._split_re else [text]
        first_text = True
        for part in parts:
            if not part:
                continue
            if self._split_re and self._split_re.fullmatch(part):
                ids.append(self.convert_token_to_id(part))
                continue
            dummy = self.legacy or first_text
            ids.extend(self._encode_segment(part, dummy_prefix=dummy))
            first_text = False
        if add_special_tokens:
            ids = [self.sp.bos_id] + ids
        return ids

    def __call__(self, text: str, add_special_tokens: bool = False):
        import numpy as np

        ids = self.encode(text, add_special_tokens=add_special_tokens)
        return {
            "input_ids": np.asarray([ids], np.int32),
            "attention_mask": np.ones((1, len(ids)), np.int32),
        }

    def decode(
        self, ids: Sequence[int], skip_special_tokens: bool = True
    ) -> str:
        out_parts: List[str] = []
        sp_ids: List[int] = []

        def flush():
            if sp_ids:
                out_parts.append(decode_pieces(self.sp, sp_ids))
                sp_ids.clear()

        for i in ids:
            i = int(i)
            if i in self._id_to_added or (
                0 <= i < self.sp.vocab_size and self.sp.types[i] == 3
            ):
                if skip_special_tokens:
                    continue
                flush()
                out_parts.append(self.convert_id_to_token(i))
            else:
                sp_ids.append(i)
        flush()
        return "".join(out_parts)

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.convert_id_to_token(int(i)) for i in ids]

    # HF-name aliases (reference code calls these spellings)
    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        if isinstance(tokens, str):
            return self.convert_token_to_id(tokens)
        return [self.convert_token_to_id(t) for t in tokens]

    def batch_decode(self, sequences, **kwargs) -> List[str]:
        return [self.decode(s, **kwargs) for s in sequences]

    def tokenize(self, text: str) -> List[str]:
        return self.convert_ids_to_tokens(self.encode(text))

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_pretrained(
        cls, path: str, *, legacy: bool = True, use_native: bool = True
    ) -> "VisualCLATokenizer":
        """Load from a directory holding ``tokenizer.model``
        (+ optional HF ``added_tokens.json`` / ``tokenizer_config.json``),
        then attach the 4 VisualCLA specials exactly like the reference
        (modeling_utils.py:94-102)."""
        model_file = (
            os.path.join(path, "tokenizer.model") if os.path.isdir(path) else path
        )
        sp = SPModel.load(model_file)
        added: Dict[str, int] = {}
        added_file = os.path.join(os.path.dirname(model_file), "added_tokens.json")
        if os.path.exists(added_file):
            with open(added_file) as f:
                added.update({k: int(v) for k, v in json.load(f).items()})
        tok = cls(sp, added, legacy=legacy, use_native=use_native)
        tok.add_special_tokens(DEFAULT_SPECIALS)
        return tok
