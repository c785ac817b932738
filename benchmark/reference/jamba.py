"""Plain float32 reference of VisualCLA over a Jamba text tower, in PyTorch,
shaped for the harness; the repository's tests read the same equations
(``tests/jamba_reference.py`` is ``text_logits`` over given tensors).

It follows transformers' ``modeling_jamba`` (4.57, ``use_mamba_kernels=
False``): the Mamba mixer of ``JambaMambaMixer.slow_forward`` (in_proj; the
causal depthwise 4-tap conv with its bias and SiLU; x_proj into dt, B, C,
each RMS-normed; dt_proj with its bias, softplus; A = -exp(A_log); the
sequential scan s = exp(A dt) s + (dt B) u, y = C . s + D u; the gate
SiLU(z); out_proj), ``JambaAttention`` (GQA, no positional encoding,
causal), ``JambaSparseMoeBlock`` (the router's softmax in f32, top-k, the
weights not renormalized) and the decoder layers (RMSNorm, mixer, residual;
RMSNorm, MoE or dense SiLU MLP, residual).  The vision side and the splice
are ``reference/model.py``'s (``Reference.encode``).

It runs the layers one at a time over every sampled sequence at once,
drawing each layer's weights again from the seed (``harness/weights_jamba``:
an MoE layer is 11.3 GB in f32, the tower 206 GB) and deriving the
configuration's tier from them (``weights`` "int4": the layers' products,
the experts and the head grouped int4, the embedding per-row int8; the rest
as drawn).  Attention at a decode position reads keys and values rounded as
the pool stores them (``kv``); the prompt's positions read them unrounded,
as the admission's scratch holds them.  ``ssm_state`` "bf16" rounds the
SSM state to bf16 after every token; ``activations`` "fp8" rounds each text
product's input to e4m3 at its row's scale (``reference/model.py``'s
``fp8_rows``).  Departures from HF's code:
the routing weights and ``C . s`` stay f32 (HF rounds both to the model's
dtype); each token's experts are summed in its top-k order.  TF32 is off.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import List, Optional

import torch
import torch.nn.functional as F

from ..harness.weights_jamba import dt_rank, draw, layer_kinds, text_spec
from .model import Reference, fp8_rows, int4_grouped, int8_rows, kv_round

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the text tower's tensors that the int4 tier stores grouped int4
INT4 = ("self_attn.", "mamba.in_proj.", "mamba.out_proj.", "gate_proj", "up_proj", "down_proj")


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


class JambaReference:
    def __init__(self, cfg: dict, seed: int, device, vision_weights: Optional[dict],
                 precision: Optional[dict] = None, text_weights: Optional[Mapping] = None):
        """``vision_weights``: tower -> {name: tensor} of the vision side
        (``weights_jamba.make``'s; None: no image); the text tower is drawn
        from ``seed``, or read from ``text_weights`` (HF name -> tensor)."""
        self.cfg, self.seed, self.device = cfg, seed, device
        self.prec = precision or {"weights": cfg["weights"], "kv": cfg["kv_cache"]}
        self.vision = None if vision_weights is None else Reference(cfg, vision_weights)
        self.text_weights = text_weights
        if text_weights is None:
            self.shapes = {n: (s, k) for n, s, k in text_spec(cfg)}

    def W(self, name: str) -> torch.Tensor:
        """One text tensor in f32, at the precision's tier."""
        if self.text_weights is not None:
            w = self.text_weights[name].to(self.device)
        else:
            shape, kind = self.shapes[name]
            w = draw(name, shape, kind, self.seed, self.device)
        if self.prec["weights"] == "int4":
            if name == "model.embed_tokens.weight":
                return int8_rows(w)
            if (name == "lm_head.weight" or any(k in name for k in INT4)) and w.dim() == 2:
                return int4_grouped(w, self.cfg["int4_group"])
        return w.float()

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w^T, x rounded as the precision computes a product's input."""
        if self.prec.get("activations") == "fp8":
            x = fp8_rows(x)
        return x @ w.t()

    # -- the mixers -------------------------------------------------------------

    def attention(self, xs, hs_P, p):
        """xs: per seq the normed (S, H); -> per seq (S, H)."""
        cfg, kv = self.cfg, self.prec["kv"]
        N, Nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        hd = cfg["hidden_size"] // N
        Wq, Wk, Wv, Wo = (self.W(f"{p}self_attn.{n}_proj.weight") for n in "qkvo")
        out = []
        for x, P in zip(xs, hs_P):
            S = x.shape[0]
            q = self.mm(x, Wq).reshape(S, N, hd)
            k = self.mm(x, Wk).reshape(S, Nkv, hd).repeat_interleave(N // Nkv, 1)
            v = self.mm(x, Wv).reshape(S, Nkv, hd).repeat_interleave(N // Nkv, 1)
            mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()

            def att(q, k, v, m):
                s = torch.einsum("qnd,knd->nqk", q, k) / math.sqrt(hd)
                s = s.masked_fill(~m[None], float("-inf"))
                return torch.einsum("nqk,knd->qnd", s.softmax(-1), v).reshape(q.shape[0], -1)

            parts = [att(q[:P], k, v, mask[:P])]
            if S > P:  # decode positions: over the pool as it stores K/V
                parts.append(att(q[P:], kv_round(k, kv), kv_round(v, kv), mask[P:]))
            out.append(self.mm(torch.cat(parts), Wo))
        return out

    def mamba(self, xs, p):
        """The mixer over every seq at once, padded to the longest (the
        padding's outputs are dropped and its states never read)."""
        cfg = self.cfg
        H, D, N, R = (cfg["hidden_size"], cfg["mamba_expand"] * cfg["hidden_size"],
                      cfg["mamba_d_state"], dt_rank(cfg))
        eps, m = cfg["rms_norm_eps"], p + "mamba."
        lens = [x.shape[0] for x in xs]
        T = max(lens)
        x = torch.stack([F.pad(x, (0, 0, 0, T - len(x))) for x in xs])  # (B, T, H)
        xz = self.mm(x, self.W(m + "in_proj.weight"))
        xi, z = xz[..., :D], xz[..., D:]
        w = self.W(m + "conv1d.weight").reshape(D, -1)
        taps = w.shape[1]
        xp = F.pad(xi, (0, 0, taps - 1, 0))
        u = sum(w[:, j] * xp[:, j:j + T] for j in range(taps))
        if cfg.get("mamba_conv_bias", True):
            u = u + self.W(m + "conv1d.bias")
        u = F.silu(u)
        q = self.mm(u, self.W(m + "x_proj.weight"))
        dt, B, C = q[..., :R], q[..., R:R + N], q[..., R + N:]
        dt = _rms(dt, self.W(m + "dt_layernorm.weight"), eps)
        B = _rms(B, self.W(m + "b_layernorm.weight"), eps)
        C = _rms(C, self.W(m + "c_layernorm.weight"), eps)
        dt = F.softplus(self.mm(dt, self.W(m + "dt_proj.weight")) + self.W(m + "dt_proj.bias"))
        A = -torch.exp(self.W(m + "A_log"))  # (D, N)
        s = torch.zeros(x.shape[0], D, N, device=x.device)
        round_state = self.prec.get("ssm_state") == "bf16"
        ys = []
        for t in range(T):
            d = dt[:, t, :, None]
            s = torch.exp(A * d) * s + (d * B[:, t, None, :]) * u[:, t, :, None]
            if round_state:
                s = s.to(torch.bfloat16).float()
            ys.append(torch.einsum("bdn,bn->bd", s, C[:, t]))
        y = (torch.stack(ys, 1) + u * self.W(m + "D")) * F.silu(z)
        out = self.mm(y, self.W(m + "out_proj.weight"))
        return [out[i, :n] for i, n in enumerate(lens)]

    def feed_forward(self, x, p, n_exp):
        """x (T, H), every seq's tokens at once."""
        f = p + "feed_forward."
        if n_exp == 1:
            g, up, dn = (self.W(f"{f}{n}_proj.weight") for n in ("gate", "up", "down"))
            return self.mm(F.silu(self.mm(x, g)) * self.mm(x, up), dn)
        probs = torch.softmax(self.mm(x, self.W(f + "router.weight")), dim=-1)
        w, idx = torch.topk(probs, self.cfg["num_experts_per_tok"], dim=-1)
        out = torch.zeros(x.shape[0], w.shape[1], x.shape[1], device=x.device)
        for e in range(n_exp):
            t, j = torch.where(idx == e)
            if len(t):
                q = f"{f}experts.{e}."
                g, up = self.W(q + "gate_proj.weight"), self.W(q + "up_proj.weight")
                h = F.silu(self.mm(x[t], g)) * self.mm(x[t], up)
                del g, up
                out[t, j] = self.mm(h, self.W(q + "down_proj.weight"))
        return (out * w[..., None]).sum(1)

    # -- the model --------------------------------------------------------------

    @torch.no_grad()
    def logits(self, seqs: List[dict]) -> List[torch.Tensor]:
        """Teacher-forced logits, as ``Reference.logits``: each seq's ``ids``
        (the prompt, then every served token but the last), ``prompt_len``,
        ``img_start`` and ``pixels``; -> per seq (len(ids) - prompt_len + 1,
        V) f32 logits, those that predicted each served token."""
        cfg, dev = self.cfg, self.device
        eps = cfg["rms_norm_eps"]
        table = self.W("model.embed_tokens.weight")
        hs = []
        for s in seqs:
            e = table[torch.as_tensor(s["ids"], device=dev)]
            img = self.vision.encode(torch.as_tensor(s["pixels"], device=dev))
            p = s["img_start"]
            e[p + 1:p + 1 + len(img)] = img
            hs.append(e)
        del table
        hs = self.layers(hs, [s["prompt_len"] for s in seqs])
        head = self.W("lm_head.weight")
        final = self.W("model.final_layernorm.weight")
        return [self.mm(_rms(h[s["prompt_len"] - 1:], final, eps), head) for h, s in zip(hs, seqs)]

    def layers(self, hs: List[torch.Tensor], P: List[int]) -> List[torch.Tensor]:
        """The layers over each seq's embeddings (S, H), the first ``P`` of a
        seq its prompt; -> each seq's output before the final norm."""
        cfg = self.cfg
        eps = cfg["rms_norm_eps"]
        for i, (kind, n_exp) in enumerate(layer_kinds(cfg)):
            p = f"model.layers.{i}."
            xs = [_rms(h, self.W(p + "input_layernorm.weight"), eps) for h in hs]
            mixed = self.attention(xs, P, p) if kind == "attention" else self.mamba(xs, p)
            hs = [h + y for h, y in zip(hs, mixed)]
            n = [len(h) for h in hs]
            x = _rms(torch.cat(hs), self.W(p + "pre_ff_layernorm.weight"), eps)
            hs = [h + y for h, y in zip(hs, self.feed_forward(x, p, n_exp).split(n))]
        return hs


@torch.no_grad()
def text_logits(ids: torch.Tensor, cfg: Mapping, weights: Mapping[str, torch.Tensor],
                embeds: Optional[torch.Tensor] = None, state_dtype=None) -> torch.Tensor:
    """The text tower alone over HF-named tensors, every position a prompt
    position: (S,) ids (or (S, H) embeddings) -> (S, V) float32 logits.
    ``state_dtype`` torch.bfloat16 rounds the SSM state after every token."""
    prec = {"weights": "none", "kv": "bf16",
            **({"ssm_state": "bf16"} if state_dtype == torch.bfloat16 else {})}
    ref = JambaReference(dict(cfg), 0, ids.device, None, prec, text_weights=weights)
    h = ref.W("model.embed_tokens.weight")[ids] if embeds is None else embeds.float()
    h = ref.layers([h], [h.shape[0]])[0]
    h = _rms(h, ref.W("model.final_layernorm.weight"), cfg["rms_norm_eps"])
    return ref.mm(h, ref.W("lm_head.weight"))


