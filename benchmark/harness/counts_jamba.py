"""Operations and bytes of a Jamba configuration, reckoned from its shapes:
the yardstick behind ``mfu.jamba`` and the rooflines of kernels B3, B4, B7
and B8 on a Jamba tower.
The conventions, the peaks and ``bound_s`` are ``harness/counts``'s: an
operation is a multiply or an add, each input byte is read once and each
output byte written once.  A token's products are those of the layers it
passes (the 4 attention layers' projections, the 28 Mamba mixers', the 16
dense MLPs', the router and its top-k experts in the 16 MoE layers) and the
head's; the scan's own arithmetic is counted at 7 operations a (channel,
state) and 14 a channel (the 4-tap conv, softplus, the skip and the gate),
a rounding error beside the products."""
from __future__ import annotations

from . import counts
from .counts import BF16_OPS_PER_S, bound_s, encode_ops, int4_call  # noqa: F401
from .weights_jamba import dt_rank, layer_kinds


def dims(cfg: dict):
    H, I, V, E = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], cfg["num_experts"]
    N, Nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return H, I, V, E, N, Nkv, H // N, cfg["mamba_expand"] * H, cfg["mamba_d_state"], dt_rank(cfg)


def attention_matmuls(cfg: dict):
    H, _, _, _, N, Nkv, hd, _, _, _ = dims(cfg)
    return [(H, N * hd), (H, Nkv * hd), (H, Nkv * hd), (N * hd, H)]


def mamba_matmuls(cfg: dict):
    """(in, out) of a Mamba mixer's products: in_proj, x_proj, dt_proj, out_proj."""
    H, _, _, _, _, _, _, D, S, R = dims(cfg)
    return [(H, 2 * D), (D, R + 2 * S), (R, D), (D, H)]


def mlp_matmuls(cfg: dict):
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    return [(H, I), (H, I), (I, H)]


def _params(mm) -> int:
    return sum(i * o for i, o in mm)


def mamba_params(cfg: dict) -> int:
    """A mixer's weights: its products, the conv (4 taps and a bias), A_log,
    D, dt_proj's bias and the three inner norms."""
    _, _, _, _, _, _, _, D, S, R = dims(cfg)
    return _params(mamba_matmuls(cfg)) + D * cfg["mamba_d_conv"] + D + D * S + 2 * D + R + 2 * S


def param_counts(cfg: dict) -> dict:
    """The tower's parameters by part (norms of the layers left out, a few
    hundred thousand)."""
    H, I, V, E = dims(cfg)[:4]
    kinds = layer_kinds(cfg)
    n_attn = sum(k == "attention" for k, _ in kinds)
    n_moe = sum(e > 1 for _, e in kinds)
    return {"mamba": (len(kinds) - n_attn) * mamba_params(cfg),
            "attention": n_attn * _params(attention_matmuls(cfg)),
            "dense_mlp": (len(kinds) - n_moe) * _params(mlp_matmuls(cfg)),
            "experts": n_moe * E * _params(mlp_matmuls(cfg)),
            "routers": n_moe * E * H,
            "embedding_and_head": 2 * V * H}


def active_matmul_params(cfg: dict) -> int:
    """The weights a token's products read: every layer's, the router, its
    top-k experts, and the head (not the embedding: a lookup)."""
    H, I, V, E = dims(cfg)[:4]
    k = cfg["num_experts_per_tok"]
    total = 0
    for kind, n_exp in layer_kinds(cfg):
        total += _params(attention_matmuls(cfg) if kind == "attention" else mamba_matmuls(cfg))
        total += (E * H + k * _params(mlp_matmuls(cfg))) if n_exp > 1 else _params(
            mlp_matmuls(cfg))
    return total + V * H


def scan_ops_token(cfg: dict) -> float:
    """A token's conv and scan arithmetic in one Mamba layer."""
    _, _, _, _, _, _, _, D, S, _ = dims(cfg)
    return 7.0 * D * S + 14.0 * D


def _n_attention(cfg: dict) -> int:
    return sum(k == "attention" for k, _ in layer_kinds(cfg))


def _n_mamba(cfg: dict) -> int:
    return sum(k == "mamba" for k, _ in layer_kinds(cfg))


def prefill_ops(cfg: dict, S: int) -> float:
    """An admission of S real tokens: the encode, every token's products
    (the head once, for the last token), causal attention in the attention
    layers and the scan in the Mamba layers."""
    H, _, V, _, N, _, hd = dims(cfg)[:7]
    products = 2.0 * (active_matmul_params(cfg) - V * H) * S + 2.0 * H * V
    attn = _n_attention(cfg) * 2.0 * 2 * N * hd * S * (S + 1) / 2
    return encode_ops(cfg) + products + attn + _n_mamba(cfg) * scan_ops_token(cfg) * S


def decode_ops(cfg: dict, context: int) -> float:
    """One decoded token whose attention covers ``context`` positions."""
    _, _, _, _, N, _, hd = dims(cfg)[:7]
    return (2.0 * active_matmul_params(cfg) + _n_attention(cfg) * 4.0 * N * hd * context
            + _n_mamba(cfg) * scan_ops_token(cfg))


# -- B7: the experts' int4 products ------------------------------------------------

def expert_bytes(cfg: dict) -> int:
    """One expert's int4 carriers and f32 scales: gate and up (H -> 2I, one
    stacked carrier) and down (I -> H)."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    g = cfg["int4_group"]
    return H * 2 * I // 2 + (H // g) * 2 * I * 4 + I * H // 2 + (I // g) * H * 4


def assignment_bytes(cfg: dict) -> int:
    """A routed token's activations through B7's two launches (bf16): its
    input and gate/up output, then the down product's input and output."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    return 2 * (H + 2 * I) + 2 * (I + H)


def b7_bound_s(cfg: dict, experts_hit: float, assignments: float) -> float:
    """B7's least time for the carriers of ``experts_hit`` experts (each an
    (MoE layer, pass) that got a token) and ``assignments`` routed tokens."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    nbytes = experts_hit * expert_bytes(cfg) + assignments * assignment_bytes(cfg)
    return bound_s(nbytes, assignments * 2.0 * 3 * H * I)


# -- B8: Mamba's conv and scan -------------------------------------------------------

def b8_token_bytes(cfg: dict, step: bool) -> int:
    """B8's bytes for one token in one Mamba layer: the conv reads x and
    writes u, the scan reads u, dt, z, B and C and writes y (bf16); a
    decode step also reads and writes the row's states (conv bf16, SSM
    f32), which an admission's chunk keeps in registers."""
    _, _, _, _, _, _, _, D, S, _ = dims(cfg)
    nbytes = 2 * 2 * D + 2 * (4 * D + 2 * S)
    if step:
        nbytes += 2 * (D * S * 4 + D * (cfg["mamba_d_conv"] - 1) * 2)
    return nbytes


def b8_bound_s(cfg: dict, prompt_tokens: float, decode_tokens: float) -> float:
    L = _n_mamba(cfg)
    nbytes = L * (prompt_tokens * b8_token_bytes(cfg, False)
                  + decode_tokens * b8_token_bytes(cfg, True))
    return bound_s(nbytes, L * scan_ops_token(cfg) * (prompt_tokens + decode_tokens))



# -- B3 and B4 on a Jamba tower ------------------------------------------------------

def int4_matmuls(cfg: dict):
    """(in, out) of the products B3 runs in one pass of the tower: the
    attention layers' four, the Mamba mixers' in_proj and out_proj, the dense
    MLPs' three (x_proj, dt_proj and the router stay bf16; the experts are
    B7's)."""
    out = []
    for kind, n_exp in layer_kinds(cfg):
        if kind == "attention":
            out += attention_matmuls(cfg)
        else:
            mm = mamba_matmuls(cfg)
            out += [mm[0], mm[3]]
        if n_exp == 1:
            out += mlp_matmuls(cfg)
    return out


def int4_pass_bound_s(cfg: dict, T: int, head_tokens: int) -> float:
    """B3's bound for one pass of the tower at T tokens, and the head at
    ``head_tokens`` (its logits in f32): ``counts.int4_pass_bound_s`` over
    ``int4_matmuls``."""
    g, H, V = cfg["int4_group"], cfg["hidden_size"], cfg["vocab_size"]
    return (sum(bound_s(*int4_call(T, i, o, g)) for i, o in int4_matmuls(cfg))
            + bound_s(*int4_call(head_tokens, H, V, g, out_bytes=4)))


def b4_token_bound(cfg: dict, cached: int):
    """(bytes, operations) of B4 for one decoded token over ``cached``
    positions, in each of the attention layers."""
    n = _n_attention(cfg)
    return (n * counts.paged_append_bytes(cfg, cached),
            n * counts.paged_append_ops(cfg, cached))
