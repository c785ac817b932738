"""SentencePiece-compatible encoding — pure-Python reference implementation.

Replicates the sentencepiece C++ runtime's behavior for the model types that
matter here (LLaMA/Chinese-Alpaca ship BPE models; unigram supported for
generality):

- **BPE** (bpe_model.cc): greedily merge the adjacent symbol pair whose
  concatenation is a vocab piece with the highest score; ties broken by
  leftmost position.  Implemented with a lazy-invalidation heap over a
  doubly-linked symbol list — O(n log n).
- **Unigram** (unigram_model.cc): Viterbi max-sum-of-scores segmentation.
- **Byte fallback**: any leftover symbol not in the vocab is emitted as
  ``<0xXX>`` byte pieces (or the unk id if the model has no byte table).

A native C++ core with identical semantics lives in ``csrc/host/sptok.cpp``; this
module is the executable spec it is tested against.
"""
from __future__ import annotations

import heapq
from typing import List

from .sp_model import SPModel

_UNK_PENALTY = 10.0  # unigram_model.cc kUnkPenalty


def normalize(model: SPModel, text: str, *, dummy_prefix: bool = True) -> str:
    """SP normalization for identity-charsmap models (LLaMA family):
    optional whitespace collapse, space->▁ escape, dummy ▁ prefix."""
    if model.remove_extra_whitespaces:
        text = " ".join(s for s in text.split(" ") if s)
    if dummy_prefix and model.add_dummy_prefix and text:
        text = " " + text
    if model.escape_whitespaces:
        text = text.replace(" ", "▁")
    return text


def _piece_ids(model: SPModel, piece: str) -> List[int]:
    """Resolve one merged symbol to ids (vocab hit, byte fallback, or unk)."""
    pid = model.piece_to_id.get(piece)
    # CONTROL/UNUSED pieces are never produced by encoding plain text
    if pid is not None and model.types[pid] not in (3, 5):
        return [pid]
    if model.has_byte_fallback:
        return [model.byte_to_id[b] for b in piece.encode("utf-8")]
    return [model.unk_id]


def encode_bpe(model: SPModel, normalized: str) -> List[int]:
    """SP-BPE over a normalized string (no specials inside). Returns ids."""
    n = len(normalized)
    if n == 0:
        return []
    # doubly-linked list of live symbols, each a (start, end) span of `normalized`
    spans = [(i, i + 1) for i in range(n)]
    prev = list(range(-1, n - 1))
    nxt = list(range(1, n + 1))
    alive = [True] * n
    rev = 0  # revision counter per merge to invalidate stale heap entries
    version = [0] * n

    def pair_key(i: int):
        """Heap key for pair (i, nxt[i]): None if merged piece not in vocab."""
        j = nxt[i]
        if j >= n:
            return None
        piece = normalized[spans[i][0] : spans[j][1]]
        pid = model.piece_to_id.get(piece)
        if pid is None or model.types[pid] != 1:  # only NORMAL pieces merge
            return None
        return (-model.scores[pid], spans[i][0])

    heap = []
    for i in range(n - 1):
        k = pair_key(i)
        if k is not None:
            heapq.heappush(heap, (k, i, version[i], version[nxt[i]]))

    while heap:
        k, i, vi, vj = heapq.heappop(heap)
        j = nxt[i] if i < n else n
        if not alive[i] or j >= n or version[i] != vi or version[j] != vj:
            continue
        if pair_key(i) != k:  # stale (neighbors changed)
            continue
        # merge j into i
        spans[i] = (spans[i][0], spans[j][1])
        alive[j] = False
        nxt[i] = nxt[j]
        if nxt[j] < n:
            prev[nxt[j]] = i
        rev += 1
        version[i] = rev
        # new candidate pairs (prev[i], i) and (i, nxt[i])
        if prev[i] >= 0:
            kk = pair_key(prev[i])
            if kk is not None:
                heapq.heappush(heap, (kk, prev[i], version[prev[i]], version[i]))
        if nxt[i] < n:
            kk = pair_key(i)
            if kk is not None:
                heapq.heappush(heap, (kk, i, version[i], version[nxt[i]]))

    out: List[int] = []
    i = 0
    while i < n:
        if alive[i]:
            out.extend(_piece_ids(model, normalized[spans[i][0] : spans[i][1]]))
            i = nxt[i]
        else:
            i += 1
    return out


def encode_unigram(model: SPModel, normalized: str) -> List[int]:
    """Viterbi segmentation maximizing total piece score (unigram models)."""
    n = len(normalized)
    if n == 0:
        return []
    max_len = max((len(p) for p in model.pieces), default=1)
    min_score = min(model.scores)
    unk_score = min_score - _UNK_PENALTY
    NEG = float("-inf")
    best = [NEG] * (n + 1)
    back: List[tuple] = [None] * (n + 1)  # (start, ids)
    best[0] = 0.0
    for end in range(1, n + 1):
        for start in range(max(0, end - max_len), end):
            if best[start] == NEG:
                continue
            piece = normalized[start:end]
            pid = model.piece_to_id.get(piece)
            if pid is not None and model.types[pid] == 1:
                s = best[start] + model.scores[pid]
                if s > best[end]:
                    best[end] = s
                    back[end] = (start, [pid])
        # single-char unk/byte fallback transition
        start = end - 1
        if best[start] != NEG:
            s = best[start] + unk_score
            if s > best[end]:
                best[end] = s
                back[end] = (start, _piece_ids(model, normalized[start:end]))
    ids: List[int] = []
    pos = n
    while pos > 0:
        start, pid_list = back[pos]
        ids[:0] = pid_list
        pos = start
    return ids


def encode(model: SPModel, text: str, *, dummy_prefix: bool = True) -> List[int]:
    normalized = normalize(model, text, dummy_prefix=dummy_prefix)
    if model.model_type == "UNIGRAM":
        return encode_unigram(model, normalized)
    return encode_bpe(model, normalized)


def decode_pieces(model: SPModel, ids: List[int]) -> str:
    """SP detokenization: bytes folded, ▁ -> space, dummy prefix stripped."""
    chunks: List[bytes] = []
    byte_buf = bytearray()
    for i in ids:
        if 0 <= i < model.vocab_size and model.types[i] == 6:  # BYTE
            byte_buf.append(int(model.pieces[i][1:-1], 16))
            continue
        if byte_buf:
            chunks.append(bytes(byte_buf))
            byte_buf = bytearray()
        if 0 <= i < model.vocab_size and model.types[i] not in (3, 5):
            chunks.append(model.pieces[i].encode("utf-8"))
    if byte_buf:
        chunks.append(bytes(byte_buf))
    text = b"".join(chunks).decode("utf-8", errors="replace")
    if model.escape_whitespaces:
        text = text.replace("▁", " ")
    if model.add_dummy_prefix and text.startswith(" "):
        text = text[1:]
    return text
