"""Jamba decoder: Mamba-1 and attention layers 7:1, a sparse MoE in every
other layer (transformers' ``modeling_jamba``, the AI21 Jamba 1.5 / 2 Mini
family).

The equations are those of transformers 4.57's ``JambaForCausalLM`` with
``use_mamba_kernels=False``: ``JambaMambaMixer.slow_forward``
(modeling_jamba.py:725-808), ``JambaAttention`` without positional encoding
(:274-345), ``JambaSparseMoeBlock`` (:843-903: softmax over the experts in
f32, top-k, the weights NOT renormalized) and the two decoder layers
(:906-1060: input norm, mixer, residual; pre-feed-forward norm, MoE or
dense SiLU MLP, residual).  Layer kinds follow ``JambaConfig.
layers_block_type`` / ``layers_num_experts``.

The surface is ``Llama``'s where the engines read it (``embed``, the layer
loop through ``forward``, ``final_norm``, ``logits``, ``kv_heads``), with two
kinds of state:

- the attention layers' K/V, in a cache of ``num_attention_layers`` layers
  (``init_kv_cache``; the paged pool's blocks at decode);
- per row and Mamba layer the conv state (the last 3 inputs, model dtype)
  and the SSM state (D x N, f32), ``init_state``: (Lm, rows, D, 3) and
  (Lm, rows, D, N), layer-major so one layer's slice is contiguous.

``forward`` runs a chunk of an admission from slot ``write_slot``: the K/V
go into the cache at those slots, and the Mamba states in the cache's
``conv`` / ``ssm`` entries (zeroed when the chunk starts at slot 0) carry
over to the next chunk.  With ``chunk_parity`` (the chunk's index mod 2)
the chunk starts from a saved copy of the states (``conv_saved`` /
``ssm_saved``, two of each) and saves its own end state in the other one,
so running a chunk twice (a graph capture's warm-up, then its replay)
gives the same states as running it once; each row's real tokens in the chunk are the
``kv_valid`` slots inside it, and positions past them leave the states
unchanged (kernel B8's chunk form), so the state kept is the one at the
last real token.  ``paged_decode`` is one decode step over the paged pool:
B4 in the attention layers, B8's step form in the Mamba layers (masked by
the pass's ``run`` vector), B7 or B3 in the feed-forward.

Weight tiers: "none" (dense, the CPU tests) and "int4" (the card's): every
large product (attention, Mamba's ``in_proj`` / ``out_proj``, the dense MLP,
the experts, the head) grouped int4, the embedding table per-row int8; the
router, ``x_proj``, ``dt_proj``, the convolution, ``A_log``, ``D`` and the
norms stay in the model's dtype.  The experts' products go through kernel
B7 (``ops.cuda.moe_int4``), which computes each expert over the tokens
routed to it only; the routing (counts, offsets, the permutation into
expert order) stays on the device, so the MoE replays inside captured
graphs.  Dense experts run on the CPU only.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import JambaConfig
from ..ops.attention import cached_attention
from ..ops.cuda import moe_int4, selective_scan as b8
from ..ops.cuda.flash_attention import slot_vector
from ..ops.cuda.paged_attention import paged_append_attention
from ..ops.linear import Int4Linear, Int8Table, Linear, make_linear, quantize_linear
from ..ops.norms import RMSNorm
from ..ops.quantization import effective_group, quantize_grouped, quantize_kv
from .llama import put_chunk

# what serves a Jamba tower today: the paged pool without speculation
SERVED_BY = "the paged pool (PagedServingEngine, PoolWorker(paged=True)) without speculation"
# the paths that do not serve it (``Jamba.require``): path -> (what, why)
REFUSED = {
    "engine": ("the B=1 Engine (chat, generate, stream)", "its cache holds no Mamba states"),
    "contiguous_pool": ("the contiguous pool (ServingEngine)", "its rows hold no Mamba states"),
    "speculation": ("speculative decoding", "a rejected draft would need the Mamba states "
                    "rolled back"),
    "beams": ("beam search", "each beam would need its own Mamba states"),
    "mesh": ("sharding over a mesh", "no partition rules for its experts and Mamba states"),
    "training": ("training", "B7 and B8 have no backward"),
}


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# -- the experts -----------------------------------------------------------------

class Experts(nn.Module):
    """E dense (out, in) weights, stacked (E, out, in): the plain tier, run
    expert by expert on the CPU."""

    def __init__(self, E: int, n_in: int, n_out: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = _frozen(torch.empty(E, n_out, n_in, device=device, dtype=dtype))

    def forward(self, x, offsets, max_rows):
        if x.device.type != "cpu":
            raise NotImplementedError("dense experts run on the CPU only; serve the Jamba tower "
                                      "at the int4 tier (kernel B7) on the card")
        bounds = offsets.tolist()
        y = torch.zeros(x.shape[0], self.weight.shape[1], dtype=x.dtype, device=x.device)
        for e in range(self.weight.shape[0]):
            a, b = bounds[e], bounds[e + 1]
            if b > a:
                y[a:b] = x[a:b] @ self.weight[e].t()
        return y


class ExpertsInt4(nn.Module):
    """E grouped int4 weights as stacked v2 carriers q (E, G, gs/2, out) and
    scales (E, G, out): kernel B7."""

    def __init__(self, E: int, n_in: int, n_out: int, group: int, *, device=None):
        super().__init__()
        G = n_in // group
        self.q = _frozen(torch.empty(E, G, group // 2, n_out, dtype=torch.uint8, device=device))
        self.scale = _frozen(torch.empty(E, G, n_out, dtype=torch.float32, device=device))

    def put(self, e: int, weight: torch.Tensor, col0: int = 0) -> None:
        """Quantize one expert's dense (out, in) weight where the carrier
        lies into columns [col0, col0 + out) of expert ``e``."""
        group = 2 * self.q.shape[2]
        wq = quantize_grouped(weight.to(self.q.device).t(), group=group)
        n = weight.shape[0]
        self.q[e, :, :, col0:col0 + n] = wq["q"]
        self.scale[e, :, col0:col0 + n] = wq["scale"]

    def forward(self, x, offsets, max_rows):
        return moe_int4.moe_int4_matmul(x, self.q, self.scale, offsets, max_rows)


def _experts(E, n_in, n_out, quant, device, dtype):
    if quant == "int4":
        return ExpertsInt4(E, n_in, n_out, effective_group(n_in), device=device)
    if quant != "none":
        raise NotImplementedError(f"the Jamba tower's experts take the 'none' or 'int4' tier, "
                                  f"got {quant!r}")
    return Experts(E, n_in, n_out, device=device, dtype=dtype)


def route(router: Linear, x: torch.Tensor, k: int):
    """(T, H) -> (weights (T, k) f32, experts (T, k)): the router's logits
    accumulated in f32, softmax over the experts in f32, top-k; the weights
    are not renormalized (and stay f32, where HF casts them to the model's
    dtype)."""
    probs = torch.softmax(router.forward_f32(x).float(), dim=-1)
    return torch.topk(probs, k, dim=-1)


def dispatch(experts: torch.Tensor, E: int):
    """Top-k choices (T, k) -> (order, offsets): the assignments (flattened
    t * k + j) sorted by expert, stably, and each expert's range of them
    (E + 1,) int32, all on the device."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(E, dtype=torch.int32, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = F.pad(torch.cumsum(counts, 0, dtype=torch.int32), (1, 0))
    return order, offsets, counts


class MoE(nn.Module):
    """``JambaSparseMoeBlock``: E SiLU-gated experts, top-k of a softmax
    router.  gate and up are one stacked weight (E, 2I, H) (one B7 launch),
    down (E, H, I) another."""

    def __init__(self, cfg: JambaConfig, *, quant: str, device=None, dtype=None):
        super().__init__()
        H, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
        self.E, self.k, self.I = E, cfg.num_experts_per_tok, I
        self.router = Linear(H, E, False, device=device, dtype=dtype)
        self.gate_up = _experts(E, H, 2 * I, quant, device, dtype)
        self.down = _experts(E, I, H, quant, device, dtype)

    def forward(self, x: torch.Tensor, tally=None, live=None) -> torch.Tensor:
        """x (B, S, H) -> (B, S, H).  ``live`` (B, S) bool: the tokens a
        request needs; the others (a chunk's padding, rows that do not run)
        go to a sentinel expert E, past the last expert's range, so B7 skips
        them, the tally leaves them out and their output is 0.  ``tally``:
        (tokens (E,) int64, hit () int64) device counters, the assignments
        an expert got and the experts that got any, added to in place."""
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        T = x2.shape[0]
        w, idx = route(self.router, x2, self.k)
        if live is not None:
            live = live.reshape(T, 1)
            idx = torch.where(live, idx, self.E)
        order, offsets, counts = dispatch(idx, self.E + 1)
        offsets, counts = offsets[:self.E + 1], counts[:self.E]
        if tally is not None:
            tally[0].add_(counts)
            tally[1].add_((counts > 0).sum())
        xs = x2.index_select(0, order // self.k)  # (T k, H) in expert order
        h = self.gate_up(xs, offsets, T)
        h = F.silu(h[:, :self.I]) * h[:, self.I:]
        y = self.down(h, offsets, T)
        out = torch.empty_like(y).index_copy_(0, order, y).view(T, self.k, -1)
        # the k outputs of a token summed in a fixed order (no atomics)
        out = (out.float() * w[..., None]).sum(1)
        if live is not None:  # the sentinel's rows were never written
            out = torch.where(live, out, 0.0)
        return out.to(x.dtype).reshape(shape)


# -- the Mamba mixer ---------------------------------------------------------------

class MambaMixer(nn.Module):
    """``JambaMambaMixer``: in_proj -> causal depthwise conv + SiLU -> x_proj
    -> RMSNorms on dt, B, C -> dt_proj (+ bias) -> selective scan with the D
    skip, gated by SiLU(z) -> out_proj.  The conv and the scan are kernel
    B8."""

    def __init__(self, cfg: JambaConfig, *, quant: str, device=None, dtype=None):
        super().__init__()
        if cfg.mamba_proj_bias:
            raise NotImplementedError("mamba_proj_bias=true checkpoints are not supported")
        if cfg.mamba_d_conv != 4:
            raise NotImplementedError(f"mamba_d_conv {cfg.mamba_d_conv}: B8 has 4 taps")
        H, D, N, R = cfg.hidden_size, cfg.mamba_inner, cfg.mamba_d_state, cfg.mamba_dt_rank
        kw = dict(device=device, dtype=dtype)
        self.D_inner, self.N, self.R = D, N, R
        self.in_proj = make_linear(H, 2 * D, quant, **kw)
        self.conv_weight = _frozen(torch.empty(D, 4, **kw))  # conv1d.weight (D, 1, 4)
        self.conv_bias = _frozen(torch.zeros(D, **kw)) if cfg.mamba_conv_bias else None
        self.x_proj = Linear(D, R + 2 * N, False, **kw)
        self.dt_proj = Linear(R, D, True, **kw)
        self.A_log = _frozen(torch.empty(D, N, **kw))
        self.D = _frozen(torch.ones(D, **kw))
        self.out_proj = make_linear(D, H, quant, **kw)
        eps = cfg.rms_norm_eps
        self.dt_norm = RMSNorm(R, eps, **kw)
        self.b_norm = RMSNorm(N, eps, **kw)
        self.c_norm = RMSNorm(N, eps, **kw)

    def _params(self, u):
        """dt_proj's product without its bias (B8 adds it in f32), B and C."""
        p = self.x_proj(u)
        dt, Bm, Cm = p.split([self.R, self.N, self.N], dim=-1)
        return (F.linear(self.dt_norm(dt), self.dt_proj.weight), self.b_norm(Bm),
                self.c_norm(Cm))

    def forward(self, x, conv, ssm, lens) -> torch.Tensor:
        """A chunk: x (B, W, H), states (B, D, 3) / (B, D, N) in place, lens
        (B,) real positions of each row in the chunk."""
        xz = self.in_proj(x)
        xi, z = xz[..., :self.D_inner], xz[..., self.D_inner:]
        u = b8.conv_chunk(xi, self.conv_weight, self.conv_bias, conv, lens)
        dt, Bm, Cm = self._params(u)
        y = b8.scan_chunk(u, dt, self.dt_proj.bias, self.A_log, Bm, Cm, self.D, z, ssm, lens)
        return self.out_proj(y)

    def step(self, x, conv, ssm, run) -> torch.Tensor:
        """One token a row: x (B, 1, H); the states of rows outside ``run``
        are left unwritten."""
        xz = self.in_proj(x)[:, 0]
        xi, z = xz[:, :self.D_inner], xz[:, self.D_inner:]
        u = b8.conv_step(xi, self.conv_weight, self.conv_bias, conv, run)
        dt, Bm, Cm = self._params(u)
        y = b8.scan_step(u, dt, self.dt_proj.bias, self.A_log, Bm, Cm, self.D, z, ssm, run)
        return self.out_proj(y[:, None])


# -- layers and the tower ------------------------------------------------------------

class JambaLayer(nn.Module):
    def __init__(self, cfg: JambaConfig, i: int, *, quant: str, device=None, dtype=None):
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        N, Nkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        kw = dict(device=device, dtype=dtype)
        self.kind = cfg.layers_block_type[i]
        self.hd = hd
        self.input_norm = RMSNorm(H, cfg.rms_norm_eps, **kw)
        self.ff_norm = RMSNorm(H, cfg.rms_norm_eps, **kw)
        if self.kind == "attention":
            self.q_proj = make_linear(H, N * hd, quant, **kw)
            self.k_proj = make_linear(H, Nkv * hd, quant, **kw)
            self.v_proj = make_linear(H, Nkv * hd, quant, **kw)
            self.o_proj = make_linear(N * hd, H, quant, **kw)
        else:
            self.mamba = MambaMixer(cfg, quant=quant, **kw)
        if cfg.layers_num_experts[i] > 1:
            self.moe = MoE(cfg, quant=quant, **kw)
        else:
            self.gate_proj = make_linear(H, I, quant, **kw)
            self.up_proj = make_linear(H, I, quant, **kw)
            self.down_proj = make_linear(I, H, quant, **kw)

    def qkv(self, x):
        B, Sq = x.shape[:2]
        return tuple(p(x).reshape(B, Sq, -1, self.hd)
                     for p in (self.q_proj, self.k_proj, self.v_proj))

    def feed_forward(self, h, tally=None, live=None):
        """``live``: the tokens the MoE routes (``MoE.forward``)."""
        x = self.ff_norm(h)
        if hasattr(self, "moe"):
            return h + self.moe(x, tally, live)
        return h + self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Jamba(nn.Module):
    """The Jamba text tower.  ``quant``: "none" or "int4" (the layers);
    ``head_quant``: the embedding's and head's tier (default ``quant``)."""

    def __init__(self, cfg: JambaConfig, *, device=None, dtype=None, quant: str = "none",
                 head_quant: Optional[str] = None):
        super().__init__()
        if quant not in ("none", "int4"):
            raise NotImplementedError(f"the Jamba tower takes the 'none' or 'int4' tier, "
                                      f"got {quant!r}")
        head_quant = quant if head_quant is None else head_quant
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        if head_quant == "none":
            self.embed_tokens = _frozen(torch.empty(cfg.vocab_size, cfg.hidden_size, **kw))
        else:
            self.embed_tokens = Int8Table(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(JambaLayer(cfg, i, quant=quant, **kw)
                                    for i in range(cfg.num_hidden_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = make_linear(cfg.hidden_size, cfg.vocab_size, head_quant, **kw)
        self.kv_heads = cfg.num_key_value_heads
        self.tp = None
        kinds = cfg.layers_block_type
        # each layer's index among the attention layers, the Mamba layers and
        # the MoE layers
        self.attn_index = {i: kinds[:i].count("attention") for i in range(len(kinds))
                           if kinds[i] == "attention"}
        self.mamba_index = {i: kinds[:i].count("mamba") for i in range(len(kinds))
                            if kinds[i] == "mamba"}
        moe = [i for i, n in enumerate(cfg.layers_num_experts) if n > 1]
        self.moe_index = {i: j for j, i in enumerate(moe)}

    # a paged pool keeps the rows' Mamba states beside the K/V (``pool_state``)
    stateful = True

    def require(self, path: str) -> None:
        """Raise ``NotImplementedError`` where ``path`` (a key of ``REFUSED``)
        does not serve the tower."""
        if path in REFUSED:
            what, why = REFUSED[path]
            raise NotImplementedError(f"{what} does not run a Jamba text tower ({why}); "
                                      f"it is served by {SERVED_BY}")

    # -- state -----------------------------------------------------------------

    def init_kv_cache(self, batch: int, max_len: int, dtype, *, device=None) -> dict:
        """Zeroed K/V of the attention layers, (La, B, Nkv, max_len, hd), with
        the Mamba states of ``batch`` rows (``init_state``) and two saved
        copies of them (``conv_saved`` / ``ssm_saved``, (2, ...))."""
        cfg = self.cfg
        shape = (cfg.num_attention_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
        state = self.init_state(batch, dtype, device=device)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device), **state,
                **{k + "_saved": torch.zeros((2,) + v.shape, dtype=v.dtype, device=device)
                   for k, v in state.items()}}

    def init_state(self, rows: int, dtype, *, device=None) -> dict:
        """Zeroed Mamba states: conv (Lm, rows, D, 3) in ``dtype``, ssm (Lm,
        rows, D, N) f32."""
        cfg = self.cfg
        Lm, D, N = cfg.num_mamba_layers, cfg.mamba_inner, cfg.mamba_d_state
        return {"conv": torch.zeros(Lm, rows, D, cfg.mamba_d_conv - 1, dtype=dtype, device=device),
                "ssm": torch.zeros(Lm, rows, D, N, dtype=torch.float32, device=device)}

    def pool_state(self, rows: int, dtype, *, device=None) -> dict:
        """What a paged pool keeps per row beside the K/V: the Mamba states
        (``init_state``), and the MoE counters (assignments (L_moe, E),
        experts hit ()) the pool's passes add to on the device."""
        tally = (torch.zeros(len(self.moe_index), self.cfg.num_experts, dtype=torch.int64,
                             device=device), torch.zeros((), dtype=torch.int64, device=device))
        return {**self.init_state(rows, dtype, device=device), "moe_tally": tally}

    # -- the surface the engines read --------------------------------------------

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        if isinstance(self.embed_tokens, Int8Table):
            e = self.embed_tokens(input_ids)
        else:
            e = F.embedding(input_ids, self.embed_tokens)
        return e.to(self.final_norm.weight.dtype)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head, accumulated and returned in f32."""
        return self.lm_head.forward_f32(hidden)

    def forward(self, inputs_embeds, rope_positions, kv_cache: dict, kv_valid, write_slot: int,
                tally=None, chunk_parity: Optional[int] = None):
        """A chunk of an admission (or a whole prompt) from cache slot
        ``write_slot`` (an int): -> (final-normed hidden (B, Sq, H), the
        cache).  ``rope_positions`` is unused: Jamba's attention has no
        positional encoding.  ``tally``: the MoE counters (``MoE.forward``),
        (tokens (L_moe, E), hit ()) on the device.  ``chunk_parity``: start
        from saved state ``chunk_parity`` and save the end state in the
        other (see the module's docstring)."""
        if not isinstance(write_slot, int):
            raise TypeError("a Jamba chunk starts at one host slot for every row")
        B, Sq = inputs_embeds.shape[:2]
        if write_slot == 0:  # a new sequence: its Mamba states start at zero
            kv_cache["conv"].zero_()
            kv_cache["ssm"].zero_()
        elif chunk_parity is not None:
            for name in ("conv", "ssm"):
                kv_cache[name].copy_(kv_cache[name + "_saved"][chunk_parity])
        live = kv_valid[:, write_slot:write_slot + Sq]  # the chunk's real tokens
        lens = live.sum(-1)
        slots = slot_vector(write_slot, B, inputs_embeds.device)
        h = inputs_embeds
        for i, layer in enumerate(self.layers):
            x = layer.input_norm(h)
            if layer.kind == "attention":
                a = self.attn_index[i]
                q, k, v = layer.qkv(x)
                for name, t in (("k", k), ("v", v)):
                    put_chunk(kv_cache[name], t.transpose(1, 2).to(kv_cache[name].dtype), a,
                              write_slot)
                attn = cached_attention(q, kv_cache["k"], kv_cache["v"], kv_valid, slots,
                                        layer_index=a)
                h = h + layer.o_proj(attn.reshape(B, Sq, -1))
            else:
                m = self.mamba_index[i]
                h = h + layer.mamba(x, kv_cache["conv"][m], kv_cache["ssm"][m], lens)
            h = layer.feed_forward(h, self._tally(tally, i), live)
        if chunk_parity is not None:
            for name in ("conv", "ssm"):
                kv_cache[name + "_saved"][1 - chunk_parity].copy_(kv_cache[name])
        return self.final_norm(h), kv_cache

    def _tally(self, tally, i):
        if tally is None or i not in self.moe_index:
            return None
        return tally[0][self.moe_index[i]], tally[1]

    def paged_decode(self, embeds, state, tables, blk, off, lens, run, tally=None):
        """One decode step over the paged pool: embeds (B, 1, H); ``state`` a
        ``PagedState`` holding the attention layers' pools and the rows'
        Mamba states (``conv`` / ``ssm``); lens (B,) the attended length
        including the new token; ``run`` (B,) bool, the rows that run: the
        others' Mamba states are left unwritten and their tokens routed to no
        expert.  -> final-normed hidden (B, 1, H)."""
        h = embeds
        for i, layer in enumerate(self.layers):
            x = layer.input_norm(h)
            if layer.kind == "attention":
                q, k, v = layer.qkv(x)
                if state.k_scales is not None:
                    (k, v), (ksc, vsc) = (t.unbind(0) for t in quantize_kv(torch.stack((k, v))))
                    ksc, vsc = ksc[:, 0], vsc[:, 0]
                else:
                    k, v, ksc, vsc = k.to(state.k_pool.dtype), v.to(state.v_pool.dtype), None, None
                attn = paged_append_attention(
                    q[:, 0], k[:, 0], v[:, 0], state.k_pool, state.v_pool, tables, lens, blk, off,
                    self.attn_index[i], ksc, vsc, state.k_scales, state.v_scales)
                h = h + layer.o_proj(attn.reshape(attn.shape[0], 1, -1))
            else:
                m = self.mamba_index[i]
                h = h + layer.mamba.step(x, state.conv[m], state.ssm[m], run)
            h = layer.feed_forward(h, self._tally(tally, i), run)
        return self.final_norm(h)

    @torch.no_grad()
    def forward_logits(self, input_ids: torch.Tensor, inputs_embeds=None) -> torch.Tensor:
        """Full-sequence forward for tests: (B, S) ids (or embeddings) ->
        (B, S, V) f32 logits (the sequence right-padded to a multiple of 128
        slots inside, as the pool's buckets are)."""
        h = self.embed(input_ids) if inputs_embeds is None else inputs_embeds
        B, S = h.shape[:2]
        L = -(-S // 128) * 128
        h = F.pad(h, (0, 0, 0, L - S))
        cache = self.init_kv_cache(B, L, h.dtype, device=h.device)
        valid = (torch.arange(L, device=h.device) < S)[None].expand(B, L)
        hidden, _ = self(h, None, cache, valid, 0)
        return self.logits(hidden[:, :S])


@torch.no_grad()
def quantize_jamba_(text: Jamba, head: bool = True) -> Jamba:
    """The int4 tier of a dense Jamba tower, in place where its weights lie:
    the attention and dense-MLP products, Mamba's in_proj / out_proj, the
    experts (B7's stacked carriers) and the head grouped int4, the embedding
    table per-row int8; each dense original dropped as its quantized form
    exists."""
    for layer in text.layers:
        names = (("q_proj", "k_proj", "v_proj", "o_proj") if layer.kind == "attention" else ())
        for name in names + ("gate_proj", "up_proj", "down_proj"):
            if hasattr(layer, name):
                if isinstance(getattr(layer, name), Int4Linear):
                    raise ValueError("the text tower is quantized already")
                setattr(layer, name, quantize_linear(getattr(layer, name), "int4"))
        if layer.kind == "mamba":
            for name in ("in_proj", "out_proj"):
                setattr(layer.mamba, name, quantize_linear(getattr(layer.mamba, name), "int4"))
        if hasattr(layer, "moe"):
            for name in ("gate_up", "down"):
                dense = getattr(layer.moe, name)
                E, n_out, n_in = dense.weight.shape
                mod = ExpertsInt4(E, n_in, n_out, effective_group(n_in), device=dense.weight.device)
                for e in range(E):
                    mod.put(e, dense.weight[e])
                setattr(layer.moe, name, mod)
    if head:
        text.lm_head = quantize_linear(text.lm_head, "int4")
        table = text.embed_tokens
        del text.embed_tokens
        text.embed_tokens = Int8Table.from_dense(table)
    return text
