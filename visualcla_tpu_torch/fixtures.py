"""Inputs for driving the port at full width without files: an in-process
tokenizer of the model's exact vocabulary size, a seeded image, the chat
prompt, seeded inputs of the paged kernel B4, and a switch that routes the
LLaMA layers' kernels (cached attention, the int4 matmul, the paged append
attention) through their plain PyTorch versions.  ``chip_smoke.py`` and
``tools/profile_torch_slice.py`` share them, so both measure the same prompt
(same length, same bucket) against the same plain attention."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .text import DEFAULT_SPECIALS, VisualCLATokenizer, build_test_model

from .engine import paged as paged_mod
from .models import llama as llama_mod
from .ops import linear as linear_mod
from .ops.attention import cached_attention_ref
from .ops.cuda.int4_matmul import int4_matmul_ref
from .ops.cuda.paged_attention import paged_append_attention_ref
from .ops.quantization import quantize_kv

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
    included), the int4 matmul (B3) and the paged append attention (B4)."""
    orig = (llama_mod.cached_attention, linear_mod.int4_matmul,
            paged_mod.paged_append_attention)
    llama_mod.cached_attention = cached_attention_ref
    linear_mod.int4_matmul = int4_matmul_ref
    paged_mod.paged_append_attention = paged_append_attention_ref
    try:
        yield
    finally:
        (llama_mod.cached_attention, linear_mod.int4_matmul,
         paged_mod.paged_append_attention) = orig


def paged_case(ctx_lens, N: int, Nkv: int, *, hd: int = 128, block_size: int = 64,
               L: int = 2, layer: int = 1, dtype=torch.bfloat16, kv_int8: bool = False,
               spare_blocks: int = 3, device="cpu", seed: int = 0) -> dict:
    """Seeded keyword arguments of ``paged_append_attention``: row b holds
    ``ctx_lens[b]`` old tokens in its own shuffled pool blocks (-1 = a parked
    row: lens 1, dummy block 0, offset BS-1, as the engine passes it) and
    appends its new token at slot ctx_lens[b].  Pools are random in ``dtype``,
    or int8 with random positive scales."""
    BS = block_size
    rng = np.random.default_rng(seed)
    need = [0 if c < 0 else c // BS + 1 for c in ctx_lens]
    NB = 1 + sum(need) + spare_blocks
    ids = rng.permutation(np.arange(1, NB))
    B = len(ctx_lens)
    max_blocks = max(max(need), 1)
    tables = np.zeros((B, max_blocks), np.int32)
    lens, blk, off = np.ones(B, np.int32), np.zeros(B, np.int32), np.full(B, BS - 1, np.int32)
    start = 0
    for b, c in enumerate(ctx_lens):
        if c < 0:
            continue
        tables[b, :need[b]] = ids[start:start + need[b]]
        start += need[b]
        lens[b], blk[b], off[b] = c + 1, tables[b, c // BS], c % BS
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device)

    pool_shape, scale_shape = (L, NB, BS, Nkv * hd), (L, NB, BS, Nkv)
    out = {"q": rnd(B, N, hd).to(dtype)}
    if kv_int8:
        (kn, vn), (ksn, vsn) = (t.unbind(0) for t in quantize_kv(rnd(2, B, Nkv, hd)))
        out.update(
            k_new=kn, v_new=vn,
            k_pool=torch.randint(-127, 128, pool_shape, generator=g, device=device,
                                 dtype=torch.int8),
            v_pool=torch.randint(-127, 128, pool_shape, generator=g, device=device,
                                 dtype=torch.int8),
            k_new_scales=ksn, v_new_scales=vsn,
            k_scales=0.01 + 0.02 * torch.rand(scale_shape, generator=g, device=device),
            v_scales=0.01 + 0.02 * torch.rand(scale_shape, generator=g, device=device))
    else:
        out.update(k_new=rnd(B, Nkv, hd).to(dtype), v_new=rnd(B, Nkv, hd).to(dtype),
                   k_pool=rnd(*pool_shape).to(dtype), v_pool=rnd(*pool_shape).to(dtype))
    for name, a in (("tables", tables), ("lens", lens), ("blk", blk), ("off", off)):
        out[name] = torch.as_tensor(a, device=device)
    out["layer"] = layer
    return out
