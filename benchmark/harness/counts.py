"""Operations and bytes, reckoned from a configuration's shapes, and the
card's peaks: the yardstick behind ``mfu`` and the kernels' rooflines.

An operation is a multiply or an add (a multiply-add is 2).  A call's bound
is the larger of its bytes over the memory rate and its operations over the
bf16 tensor-core rate; each input byte is counted read once and each output
byte written once, whatever the kernel reads again.  The arithmetic of the
bounds is the port's ``chip_smoke.py``'s, that of the model's operations its
``fixtures.train_step_flops``'s forward, copied here so that a change to the
program cannot move the yardstick.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S)


def _text(cfg: dict):
    t = cfg["text_config"]
    H, I, L, V = t["hidden_size"], t["intermediate_size"], t["num_hidden_layers"], t["vocab_size"]
    N = t["num_attention_heads"]
    Nkv = t.get("num_key_value_heads") or N
    return H, I, L, V, N, Nkv, H // N


def layer_matmuls(cfg: dict):
    """The (in, out) of one decoder layer's seven products."""
    H, I, _, _, N, Nkv, hd = _text(cfg)
    return [(H, N * hd), (H, Nkv * hd), (H, Nkv * hd), (N * hd, H), (H, I), (H, I), (I, H)]


def layer_params(cfg: dict) -> int:
    return sum(i * o for i, o in layer_matmuls(cfg))


# -- model operations ---------------------------------------------------------

def encode_ops(cfg: dict) -> float:
    """One image through the ViT, the resampler and the projection."""
    v, r = cfg["vision_config"], cfg["visual_resampler_config"]
    H = cfg["text_config"]["hidden_size"]
    Hv, Iv, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    T = (v["image_size"] // P) ** 2 + 1
    Q, Hr, Ir = r["num_query_tokens"], r["hidden_size"], r["intermediate_size"]
    vit = (v["num_hidden_layers"] * (2.0 * (4 * Hv * Hv + 2 * Hv * Iv) * T + 4.0 * T * T * Hv)
           + 2.0 * (T - 1) * 3 * P * P * Hv)
    res = r["num_hidden_layers"] * 2.0 * (2 * Q * Hr * Hr + 2 * (Q + T) * Hr * Hr
                                          + 2 * Q * Hr * Ir + 2 * Q * (Q + T) * Hr)
    return vit + res + 2.0 * Q * Hr * H


def prefill_ops(cfg: dict, S: int) -> float:
    """An admission of S real tokens: the encode, the layers' products, causal
    attention (each query over itself and the positions before it) and the
    head for the last token."""
    H, _, L, V, N, _, hd = _text(cfg)
    attn = L * 2.0 * 2 * N * hd * S * (S + 1) / 2
    return encode_ops(cfg) + 2.0 * L * layer_params(cfg) * S + attn + 2.0 * H * V


def decode_ops(cfg: dict, context: int) -> float:
    """One decoded token whose attention covers ``context`` positions (the
    cached ones and its own)."""
    H, _, L, V, N, _, hd = _text(cfg)
    return 2.0 * L * layer_params(cfg) + L * 4.0 * N * hd * context + 2.0 * H * V


# -- B3: the int4 matmul -------------------------------------------------------

def int4_call(T: int, n_in: int, n_out: int, group: int, out_bytes: int = 2):
    """(bytes, operations) of x (T, in) bf16 @ an int4 (in, out) carrier with
    f32 scales per group -> (T, out)."""
    nbytes = n_in * n_out // 2 + (n_in // group) * n_out * 4 + T * n_in * 2 + T * n_out * out_bytes
    return nbytes, 2.0 * T * n_in * n_out


def int4_pass_bound_s(cfg: dict, T: int, head_tokens: int) -> float:
    """B3's bound for one pass of the text tower at T tokens: every layer's
    seven products, and the head at ``head_tokens`` (its logits in f32)."""
    g = cfg["int4_group"]
    L, V, H = cfg["text_config"]["num_hidden_layers"], cfg["text_config"]["vocab_size"], \
        cfg["text_config"]["hidden_size"]
    layer = sum(bound_s(*int4_call(T, i, o, g)) for i, o in layer_matmuls(cfg))
    return L * layer + bound_s(*int4_call(head_tokens, H, V, g, out_bytes=4))


# -- B4: paged append attention ------------------------------------------------

def kv_slot_bytes(cfg: dict) -> int:
    """K and V of one position in one layer, as the pool stores them."""
    _, _, _, _, _, Nkv, hd = _text(cfg)
    if cfg["kv_cache"] == "int8":
        return 2 * Nkv * (hd + 4)  # int8 values and an f32 scale per head
    return 2 * Nkv * hd * 2


def paged_append_bytes(cfg: dict, cached: int) -> int:
    """B4 for one token in one layer: q and the new K/V in, ``cached``
    positions read, one written, the output out."""
    _, _, _, _, N, _, hd = _text(cfg)
    slot = kv_slot_bytes(cfg)
    return 2 * N * hd * 2 + slot + cached * slot + slot


def paged_append_ops(cfg: dict, cached: int) -> float:
    _, _, _, _, N, _, hd = _text(cfg)
    return 4.0 * N * hd * (cached + 1)
