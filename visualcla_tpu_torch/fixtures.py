"""Inputs for driving the port at full width without files: an in-process
tokenizer of the model's exact vocabulary size, a seeded image, the chat
prompt, seeded inputs of the paged kernels B4, B5 and B6, and a switch that
routes the kernels of the model (cached attention, the int4 matmul, the
paged append and verify attention, the vision towers' flash attention)
through their plain PyTorch versions.
``chip_smoke.py`` and ``tools/profile_torch_slice.py`` share them, so both
measure the same prompt (same length, same bucket) against the same plain
attention."""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .text import DEFAULT_SPECIALS, VisualCLATokenizer, build_test_model

from .engine import paged as paged_mod
from .engine import paged_spec as paged_spec_mod
from .models import llama as llama_mod
from .ops import attention as attention_mod
from .ops import linear as linear_mod
from .ops.attention import cached_attention_ref
from .ops.cuda.flash_attention import flash_attention_ref
from .ops.cuda.int4_matmul import int4_matmul_ref
from .ops.cuda.paged_attention import paged_append_attention_ref, paged_verify_attention_ref
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
    """Within the block, the model runs the kernels' plain PyTorch versions
    instead of the kernels: cached attention (B1/B2, int8 K/V included), the
    int4 matmul (B3), the paged append attention (B4), the paged verify
    attention (B5) and the vision towers' flash attention (B2u, under
    ``VISUALCLA_VIT_ATTN=flash``)."""
    orig = (llama_mod.cached_attention, linear_mod.int4_matmul,
            paged_mod.paged_append_attention, paged_spec_mod.paged_verify_attention,
            attention_mod.flash_attention)
    llama_mod.cached_attention = cached_attention_ref
    linear_mod.int4_matmul = int4_matmul_ref
    paged_mod.paged_append_attention = paged_append_attention_ref
    paged_spec_mod.paged_verify_attention = paged_verify_attention_ref
    attention_mod.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        (llama_mod.cached_attention, linear_mod.int4_matmul,
         paged_mod.paged_append_attention, paged_spec_mod.paged_verify_attention,
         attention_mod.flash_attention) = orig


def _paged_inputs(ctx_lens, Sq: int, N: int, Nkv: int, hd: int, BS: int, L: int,
                  dtype, kv_int8: bool, spare_blocks: int, device, seed: int):
    """Shared by the paged cases: row b holds ``ctx_lens[b]`` old tokens and
    has blocks for ``Sq`` new ones, in its own shuffled pool blocks (-1 = a
    parked row, a zeroed table).  -> (tables, inputs dict with q (B, Sq, N,
    hd), k_new, v_new (B, Sq, Nkv, hd) and the pools, random in ``dtype`` or
    int8 with random positive scales)."""
    rng = np.random.default_rng(seed)
    need = [0 if c < 0 else (c + Sq - 1) // BS + 1 for c in ctx_lens]
    NB = 1 + sum(need) + spare_blocks
    ids = rng.permutation(np.arange(1, NB))
    tables = np.zeros((len(ctx_lens), max(max(need), 1)), np.int32)
    start = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[start:start + n]
        start += n
    g = torch.Generator(device=device).manual_seed(seed)
    B = len(ctx_lens)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device)

    pool_shape, scale_shape = (L, NB, BS, Nkv * hd), (L, NB, BS, Nkv)
    out = {"q": rnd(B, Sq, N, hd).to(dtype)}
    if kv_int8:
        (kn, vn), (ksn, vsn) = (t.unbind(0) for t in quantize_kv(rnd(2, B, Sq, Nkv, hd)))
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
        out.update(k_new=rnd(B, Sq, Nkv, hd).to(dtype), v_new=rnd(B, Sq, Nkv, hd).to(dtype),
                   k_pool=rnd(*pool_shape).to(dtype), v_pool=rnd(*pool_shape).to(dtype))
    return tables, out


def paged_case(ctx_lens, N: int, Nkv: int, *, hd: int = 128, block_size: int = 64,
               L: int = 2, layer: int = 1, dtype=torch.bfloat16, kv_int8: bool = False,
               spare_blocks: int = 3, device="cpu", seed: int = 0) -> dict:
    """Seeded keyword arguments of ``paged_append_attention``: row b holds
    ``ctx_lens[b]`` old tokens in its own shuffled pool blocks (-1 = a parked
    row: lens 1, dummy block 0, offset BS-1, as the engine passes it) and
    appends its new token at slot ctx_lens[b].  Pools are random in ``dtype``,
    or int8 with random positive scales."""
    BS = block_size
    tables, out = _paged_inputs(ctx_lens, 1, N, Nkv, hd, BS, L, dtype, kv_int8, spare_blocks,
                                device, seed)
    out = {k: (v[:, 0] if k in ("q", "k_new", "v_new", "k_new_scales", "v_new_scales") else v)
           for k, v in out.items()}
    B = len(ctx_lens)
    lens, blk, off = np.ones(B, np.int32), np.zeros(B, np.int32), np.full(B, BS - 1, np.int32)
    for b, c in enumerate(ctx_lens):
        if c >= 0:
            lens[b], blk[b], off[b] = c + 1, tables[b, c // BS], c % BS
    for name, a in (("tables", tables), ("lens", lens), ("blk", blk), ("off", off)):
        out[name] = torch.as_tensor(a, device=device)
    out["layer"] = layer
    return out


def paged_verify_case(ctx_lens, Sq: int, N: int, Nkv: int, *, hd: int = 128,
                      block_size: int = 64, L: int = 2, layer: int = 1, dtype=torch.bfloat16,
                      kv_int8: bool = False, spare_blocks: int = 3, device="cpu",
                      seed: int = 0) -> dict:
    """Seeded keyword arguments of ``paged_verify_attention``: row b holds
    ``ctx_lens[b]`` old tokens and appends ``Sq`` new ones from slot
    ctx_lens[b], in its own shuffled pool blocks (-1 = a parked row: lens Sq
    and a zeroed table, as the engine passes it)."""
    tables, out = _paged_inputs(ctx_lens, Sq, N, Nkv, hd, block_size, L, dtype, kv_int8,
                                spare_blocks, device, seed)
    lens = np.asarray([Sq + max(c, 0) for c in ctx_lens], np.int32)
    out.update(tables=torch.as_tensor(tables, device=device),
               lens=torch.as_tensor(lens, device=device), layer=layer)
    return out


def paged_decode_args(case: dict, layer: Optional[int] = None) -> dict:
    """Keyword arguments of ``paged_decode_attention`` (B6) from a
    ``paged_case``: layer ``layer`` (the case's by default) of its pools as
    (NB, BS, Nkv, hd), and lens counting the old tokens (0 for a parked
    row)."""
    l = case["layer"] if layer is None else layer
    L, NB, BS, KVL = case["k_pool"].shape
    hd = case["q"].shape[-1]
    out = {"q": case["q"], "tables": case["tables"], "lens": case["lens"] - 1}
    for name in ("k_pool", "v_pool"):
        out[name] = case[name][l].view(NB, BS, KVL // hd, hd)
    if case.get("k_scales") is not None:
        out.update(k_scales=case["k_scales"][l], v_scales=case["v_scales"][l])
    return out
