"""The benchmark's tokenizer vocabulary: a SentencePiece BPE table of exactly
the configuration's vocabulary size, with no files.

The table is an input of the benchmark, as the weights are: the program reads
it through its own tokenizer (``VisualCLATokenizer`` over an in-memory
``SPModel``), the plain reference (``benchmark/reference/tokenize.py``)
through its own encoder.  Its layout is SentencePiece's: ``<unk> <s> </s>``,
the 256 byte pieces, then ``pieces`` (single characters at score -100, then
pairs of CJK characters at scores -1, -2, ..., which BPE merges in that
order), then the four added specials.  Copied from the port's
``fixtures.make_tokenizer`` so that the prompt is the length the port's own
smoke test measured.
"""
from __future__ import annotations

import math

SPECIALS = ("<pad>", "<img>", "</img>", "<img_token>")
CONTROL = ("<unk>", "<s>", "</s>")
N_BYTES = 256
# the characters an instruction is written in: each is one piece, and no two
# of them merge (pairs are made only of the first ``pair_side`` CJK singles)
CHARS = sorted(set("abcdefghijklmnopqrstuvwxyz0123456789 .,!?:#\n"
                   "图片里有什么这是一只猫狗在上的和描述张请详细回答问题。"))


def _singles():
    return [chr(c) for c in range(0x4E00, 0x9FA6) if chr(c) not in CHARS]


def pieces_and_scores(vocab_size: int):
    """(pieces, scores, pair_side): the NORMAL pieces after the byte table,
    their BPE scores, and how many CJK singles the pairs are built from."""
    singles = _singles()
    n_needed = vocab_size - len(SPECIALS) - len(CONTROL) - N_BYTES - len(CHARS) - len(singles)
    if n_needed < 0:
        raise ValueError(f"vocab_size {vocab_size} is below the single-character table")
    side = int(math.ceil(math.sqrt(n_needed)))
    pairs = [a + b for a in singles[:side] for b in singles[:side]][:n_needed]
    pieces = CHARS + singles + pairs
    scores = [-100.0] * (len(CHARS) + len(singles)) + [-float(i + 1) for i in range(len(pairs))]
    return pieces, scores, side


def instruction_alphabet(vocab_size: int):
    """Characters an instruction is drawn from: CJK singles that take part in
    no pair, so an instruction of n characters is n tokens."""
    return _singles()[pieces_and_scores(vocab_size)[2]:]


def program_tokenizer(vocab_size: int):
    """The port's tokenizer over this table (imports the port)."""
    from visualcla_tpu_torch.text import VisualCLATokenizer, build_test_model

    pieces, scores, _ = pieces_and_scores(vocab_size)
    tok = VisualCLATokenizer(build_test_model(pieces, scores))
    tok.add_special_tokens(SPECIALS)
    if len(tok) != vocab_size:
        raise RuntimeError(f"tokenizer holds {len(tok)} ids, the configuration {vocab_size}")
    return tok
