"""Inputs for driving the port at full width without files: an in-process
tokenizer of the model's exact vocabulary size, a seeded image, the chat
prompt, seeded inputs of the paged kernels B4, B5 and B6, the training
step's models (QLoRA, and stage 1 over a bf16 or quantized text tower),
its batch and its FLOPs reckoned from the shapes, and a switch that routes
the kernels of the model (cached attention, the int4 matmul, the
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

from .core.config import VisualCLAConfig
from .processor import ImageProcessor
from .text import DEFAULT_SPECIALS, VisualCLATokenizer, build_test_model

from .engine import graphs as graphs_mod
from .engine import paged as paged_mod
from .engine import paged_spec as paged_spec_mod
from .models import llama as llama_mod
from .models.visualcla import VisualCLAModel, init_random_, quantize_text_tower_
from .ops import attention as attention_mod
from .ops import linear as linear_mod
from .ops.attention import cached_attention_ref
from .ops.cuda.flash_attention import flash_attention_ref
from .ops.cuda.int4_matmul import int4_matmul_ref
from .ops.cuda.paged_attention import paged_append_attention_ref, paged_verify_attention_ref
from .ops.quantization import quantize_kv
from .train.lora import add_lora

SEED = 0
PROMPT = "请详细描述这张图片。"
# the training step's batch: one row of TRAIN_SEQ tokens, the first
# TRAIN_MASKED labels ignored (the prompt), ``<img>`` at position 2
TRAIN_SEQ, TRAIN_MASKED, TRAIN_IMG_POS = 512, 80, 2
LORA_R, LORA_ALPHA = 8, 16.0


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
    ``VISUALCLA_VIT_ATTN=flash``).  The decode loops run eagerly within it:
    a captured graph would replay the kernels it was captured with."""
    orig = (llama_mod.cached_attention, linear_mod.int4_matmul,
            paged_mod.paged_append_attention, paged_spec_mod.paged_verify_attention,
            attention_mod.flash_attention)
    llama_mod.cached_attention = cached_attention_ref
    linear_mod.int4_matmul = int4_matmul_ref
    paged_mod.paged_append_attention = paged_append_attention_ref
    paged_spec_mod.paged_verify_attention = paged_verify_attention_ref
    attention_mod.flash_attention = flash_attention_ref
    try:
        with graphs_mod.eager():
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


def train_model(cfg: VisualCLAConfig, stage: int, device="cuda", seed: int = SEED,
                dtype=torch.bfloat16, bits: Optional[int] = None) -> VisualCLAModel:
    """The training step's model on seeded random weights made on ``device``:
    stage 2 is the QLoRA tree (int8 decoder matmuls, float embed_tokens,
    lm_head, vision, resampler and projection, LoRA r=LORA_R on the text and
    vision targets in ``dtype``); stage 1 the dense model, or with ``bits``
    (8 or 4) its text tower quantized on ``device`` (``quantize_text_tower_``:
    the layers and the head at that tier, the embedding table per-row int8;
    at 4 the layout of the JAX package's ``quantize_tree(bits=4)``)."""
    if stage == 2 and bits not in (None, 8):
        raise ValueError(f"the stage-2 model is the int8 QLoRA tree, got bits={bits}")
    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_random_(VisualCLAModel(cfg, device=device, dtype=dtype), gen)
    if stage == 2:
        quantize_text_tower_(model, 8, head=False)
        add_lora(model, r=LORA_R, alpha=LORA_ALPHA, generator=gen, dtype=dtype)
    elif bits is not None:
        quantize_text_tower_(model, bits)
    return model


def train_batch(cfg: VisualCLAConfig, tokenizer: VisualCLATokenizer, seed: int = SEED,
                seq: int = TRAIN_SEQ) -> dict:
    """One seeded training row (numpy): random ids with ``<img>`` at
    TRAIN_IMG_POS followed by its placeholders and ``</img>``, the first
    TRAIN_MASKED labels -100, and one image preprocessed to the tower's size."""
    rng = np.random.default_rng(seed)
    T = cfg.num_image_tokens
    ids = rng.integers(5, tokenizer.sp.vocab_size, (1, seq)).astype(np.int64)
    p = TRAIN_IMG_POS
    ids[0, p] = tokenizer.img_start_token_id
    ids[0, p + 1:p + 1 + T] = tokenizer.img_token_id
    ids[0, p + 1 + T] = tokenizer.img_end_token_id
    labels = ids.copy()
    labels[0, :TRAIN_MASKED] = -100
    size = cfg.vision_config.image_size
    pixels = ImageProcessor(image_size=size, crop_size=size).preprocess_one(random_image(seed))
    return {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": labels,
            "img_start_pos": np.asarray([p]), "pixel_values": pixels[None]}


def train_step_flops(cfg: VisualCLAConfig, stage: int, seq: int = TRAIN_SEQ, batch: int = 1,
                     remat: bool = True) -> dict:
    """Model FLOPs of one training step, reckoned from the shapes (2 a
    multiply-add).  The forward F is 2 x (layer matmul parameters, LoRA's
    included) x tokens for the decoder, the LM head, attention (4 x S^2 x
    width a layer, the causal half not taken off), the ViT (its attention
    likewise), the resampler and the projection.  The input gradient is one
    more F; the weight gradients count only the trainable leaves' products
    (stage 2: the LM head, LoRA, resampler and projection; stage 1: the
    whole vision side); remat recomputes one more F."""
    t, v, rs = cfg.text_config, cfg.vision_config, cfg.visual_resampler_config
    H, I, L, V = t.hidden_size, t.intermediate_size, t.num_hidden_layers, t.vocab_size
    q_out, kv_out = t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim
    S = seq * batch
    layer_params = H * q_out + 2 * H * kv_out + q_out * H + 3 * H * I
    Hv, Iv, T = v.hidden_size, v.intermediate_size, (v.image_size // v.patch_size) ** 2 + 1
    Q, Hr, Ir = rs.num_query_tokens, rs.hidden_size, rs.intermediate_size
    lora_text = sum(LORA_R * (i + o) for i, o in (
        (H, q_out), (H, kv_out), (H, kv_out), (q_out, H), (H, I), (H, I), (I, H)))
    lora_vision = LORA_R * (4 * 2 * Hv + 2 * (Hv + Iv))
    parts = {
        "text": 2.0 * L * (layer_params + (lora_text if stage == 2 else 0)) * S,
        "head": 2.0 * H * V * S,
        "attention": 4.0 * L * seq * seq * q_out * batch,
        "vit": batch * (2.0 * v.num_hidden_layers * (
            (4 * Hv * Hv + 2 * Hv * Iv + (lora_vision if stage == 2 else 0)) * T
            + 2 * T * T * Hv) + 2.0 * (T - 1) * 3 * v.patch_size ** 2 * Hv),
        "resampler": batch * 2.0 * rs.num_hidden_layers * (
            2 * Q * Hr * Hr + 2 * (Q + T) * Hr * Hr + 2 * Q * Hr * Ir + 2 * Q * (Q + T) * Hr),
        "projection": batch * 2.0 * Q * Hr * H,
    }
    forward = sum(parts.values())
    if stage == 2:
        wgrad = (parts["head"] + 2.0 * L * lora_text * S
                 + batch * 2.0 * v.num_hidden_layers * lora_vision * T
                 + parts["resampler"] + parts["projection"])
    else:
        wgrad = parts["vit"] + parts["resampler"] + parts["projection"]
    total = 2 * forward + wgrad + (forward if remat else 0)
    return {"parts": parts, "forward": forward, "weight_grads": wgrad, "total": total}
