"""Inputs for driving the port at full width without files: an in-process
tokenizer of the model's exact vocabulary size, a seeded image, the chat
prompt, and a switch that routes the LLaMA layers' kernels (cached attention,
the int4 matmul) through their plain PyTorch versions.  ``chip_smoke.py`` and
``tools/profile_torch_slice.py`` share them, so both measure the same prompt
(same length, same bucket) against the same plain attention."""
from __future__ import annotations

import contextlib

import numpy as np

from visualcla_tpu.text import DEFAULT_SPECIALS, VisualCLATokenizer, build_test_model

from .models import llama as llama_mod
from .ops import linear as linear_mod
from .ops.attention import cached_attention_ref
from .ops.cuda.int4_matmul import int4_matmul_ref

SEED = 0
PROMPT = "请详细描述这张图片。"


def make_tokenizer(vocab_size: int) -> VisualCLATokenizer:
    """A SentencePiece vocabulary of exactly ``vocab_size`` ids (with the 4
    specials), so every id the model can emit decodes."""
    chars = sorted(set("abcdefghijklmnopqrstuvwxyz0123456789 .,!?:#\n"
                       "图片里有什么这是一只猫狗在上的和描述张请详细回答问题。"))
    singles = [chr(c) for c in range(0x4E00, 0x9FA6) if chr(c) not in chars]
    n_needed = vocab_size - len(DEFAULT_SPECIALS) - 3 - 256 - len(chars) - len(singles)
    side = int(np.ceil(np.sqrt(n_needed)))
    pairs = [a + b for a in singles[:side] for b in singles[:side]][:n_needed]
    vocab = chars + singles + pairs
    scores = [-100.0] * (len(chars) + len(singles)) + [-float(i + 1) for i in range(len(pairs))]
    tok = VisualCLATokenizer(build_test_model(vocab, scores))
    tok.add_special_tokens(DEFAULT_SPECIALS)
    assert len(tok) == vocab_size, (len(tok), vocab_size)
    return tok


def random_image(seed: int) -> np.ndarray:
    """A seeded (480, 640, 3) uint8 image."""
    return np.random.default_rng(seed).integers(0, 256, (480, 640, 3), dtype=np.uint8)


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the LLaMA layers run the kernels' plain PyTorch
    versions instead of the kernels: cached attention (B1/B2, int8 K/V
    included) and the int4 matmul (B3)."""
    orig = llama_mod.cached_attention, linear_mod.int4_matmul
    llama_mod.cached_attention = cached_attention_ref
    linear_mod.int4_matmul = int4_matmul_ref
    try:
        yield
    finally:
        llama_mod.cached_attention, linear_mod.int4_matmul = orig
