"""Plain float32 reference of the served VisualCLA model, in PyTorch.

It follows the published architectures, with no kernel, cache or batching:

- CLIP ViT-L/14 (HF ``CLIPVisionModel``): the patch convolution without bias,
  the class token, learned positions, the pre-layer norm, pre-LN blocks
  (attention with biases, quick-gelu MLP), and the post-layer norm over the
  whole sequence, whose every token feeds the resampler;
- VisualCLA's resampler: learned queries; in each layer the queries attend
  over [queries ; image tokens] (BERT cross-attention with biases), then
  post-LN blocks with an exact-gelu MLP;
- the projection into the text width, written over the ``<img_token>``
  embeddings that follow ``<img>``;
- the LLaMA decoder (DeepSeek-LLM and Mistral without a sliding window are
  its equations): RMSNorm, rotary positions on halves, causal attention whose
  key and value heads are shared by ``N / Nkv`` query heads, a SiLU-gated
  MLP, the final norm and the head.

Precision follows the configuration: float32 everywhere, with the text
tower's matrices derived as the configuration states them (``weights``:
"bf16" as drawn; "int4": grouped int4 layers and head, group 128, per-row
int8 embedding table; a control's "fp8": e4m3 per output channel, and with
``activations`` "fp8" each product's input e4m3 per row) and the attention
of each decode position over keys and values rounded as the KV cache stores
them (``kv``: "bf16", "int8" or "int4" per token and head).
The prompt's own positions attend over the unrounded keys and values, as a
prefill into a scratch cache does.  Weights are read from the dict that
``harness.weights.make`` draws; nothing of the program is imported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _round_int(w: torch.Tensor, scale: torch.Tensor, top: int) -> torch.Tensor:
    return torch.round(w / scale).clamp_(-top, top) * scale


def int4_grouped(w: torch.Tensor, group: int) -> torch.Tensor:
    """(out, in) -> the same, each run of ``group`` inputs of an output
    rounded to 15 levels of its absmax / 7 (round half to even)."""
    out_f, in_f = w.shape
    g = w.float().reshape(out_f, in_f // group, group)
    s = g.abs().amax(dim=-1, keepdim=True) / 7.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return _round_int(g, s, 7).reshape(out_f, in_f)


def int8_rows(w: torch.Tensor) -> torch.Tensor:
    """Each row rounded to 255 levels of its absmax / 127."""
    w = w.float()
    s = w.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return _round_int(w, s, 127)


def fp8_rows(w: torch.Tensor) -> torch.Tensor:
    """Each row scaled to e4m3's range and rounded to float8 e4m3."""
    w = w.float()
    s = w.abs().amax(dim=-1, keepdim=True) / FP8_MAX
    s = torch.where(s == 0, torch.ones_like(s), s)
    return (w / s).to(torch.float8_e4m3fn).float() * s


def kv_round(x: torch.Tensor, kv: str) -> torch.Tensor:
    """Keys or values (..., hd) as the cache stores them."""
    if kv == "bf16":
        return x
    top = {"int8": 127, "int4": 7}[kv]
    s = x.abs().amax(dim=-1, keepdim=True) / top
    s = torch.where(s == 0, torch.ones_like(s), s)
    return _round_int(x, s, top)


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _attend(q, k, v, mask=None):
    """q (Sq, N, hd), k and v (Sk, N, hd) -> (Sq, N * hd)."""
    s = torch.einsum("qnd,knd->nqk", q, k) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s.masked_fill(~mask[None], float("-inf"))
    return torch.einsum("nqk,knd->qnd", s.softmax(-1), v).reshape(q.shape[0], -1)


class Reference:
    def __init__(self, cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]],
                 precision: Optional[dict] = None):
        """``precision``: {"weights": "bf16" | "int4" | "fp8", "kv": "bf16" |
        "int8" | "int4", optionally "activations": "fp8"}; default: what
        ``cfg`` states."""
        self.cfg = cfg
        self.w = {k: v for tower in weights.values() for k, v in tower.items()}
        self.prec = precision or {"weights": cfg["weights"], "kv": cfg["kv_cache"]}

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A text-tower product's input, rounded as the precision computes it
        (``activations``: "fp8" rounds each row to e4m3 at its own scale)."""
        return fp8_rows(x) if self.prec.get("activations") == "fp8" else x

    def f32(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def text_matrix(self, name: str) -> torch.Tensor:
        w, tier = self.w[name], self.prec["weights"]
        if tier == "int4":
            return int4_grouped(w, self.cfg["int4_group"])
        if tier == "fp8":
            return fp8_rows(w)
        return w.float()

    def embedding_table(self) -> torch.Tensor:
        w = self.w["model.embed_tokens.weight"]
        return int8_rows(w) if self.prec["weights"] == "int4" else w.float()

    # -- vision side -----------------------------------------------------------

    def encode(self, pixels: torch.Tensor) -> torch.Tensor:
        """(3, S, S) float32 -> (Q, H) image embeddings in the text width."""
        v, r = self.cfg["vision_config"], self.cfg["visual_resampler_config"]
        g = self.f32
        p = "vision_model."
        x = F.conv2d(pixels[None].float(), g(p + "embeddings.patch_embedding.weight"),
                     stride=v["patch_size"])[0].flatten(1).t()
        x = torch.cat([g(p + "embeddings.class_embedding")[None], x])
        x = x + g(p + "embeddings.position_embedding.weight")
        eps = v["layer_norm_eps"]
        x = _layer_norm(x, g(p + "pre_layrnorm.weight"), g(p + "pre_layrnorm.bias"), eps)
        nh = v["num_attention_heads"]
        for l in range(v["num_hidden_layers"]):
            q = f"{p}encoder.layers.{l}."

            def lin(n, t):
                return t @ g(q + n + ".weight").t() + g(q + n + ".bias")

            y = _layer_norm(x, g(q + "layer_norm1.weight"), g(q + "layer_norm1.bias"), eps)
            heads = [lin(f"self_attn.{n}_proj", y).reshape(len(y), nh, -1) for n in "qkv"]
            x = x + lin("self_attn.out_proj", _attend(*heads))
            y = _layer_norm(x, g(q + "layer_norm2.weight"), g(q + "layer_norm2.bias"), eps)
            h = lin("mlp.fc1", y)
            x = x + lin("mlp.fc2", h * torch.sigmoid(1.702 * h))
        x = _layer_norm(x, g(p + "post_layernorm.weight"), g(p + "post_layernorm.bias"), eps)

        p = "visual_resampler."
        eps, nh = r["layer_norm_eps"], r["num_attention_heads"]
        h = g(p + "query_embeddding")[0]
        for l in range(r["num_hidden_layers"]):
            a = f"{p}encoder.layer.{l}.crossattention."
            f = f"{p}encoder.layer.{l}."

            def lin(n, t):
                return t @ g(n + ".weight").t() + g(n + ".bias")

            kv_in = torch.cat([h, x])
            q = lin(a + "self.query", h).reshape(len(h), nh, -1)
            k = lin(a + "self.key", kv_in).reshape(len(kv_in), nh, -1)
            vv = lin(a + "self.value", kv_in).reshape(len(kv_in), nh, -1)
            att = _layer_norm(lin(a + "output.dense", _attend(q, k, vv)) + h,
                              g(a + "output.LayerNorm.weight"), g(a + "output.LayerNorm.bias"),
                              eps)
            ffn = lin(f + "output.dense", F.gelu(lin(f + "intermediate.dense", att)))
            h = _layer_norm(ffn + att, g(f + "output.LayerNorm.weight"),
                            g(f + "output.LayerNorm.bias"), eps)
        return h @ g("image_projection_layer.weight").t() + g("image_projection_layer.bias")

    # -- text tower ------------------------------------------------------------

    @torch.no_grad()
    def logits(self, seqs: List[dict]) -> List[torch.Tensor]:
        """Teacher-forced logits.  Each seq: ``ids`` (the prompt, then every
        served token but the last), ``prompt_len``, ``img_start`` and
        ``pixels`` (3, S, S) float32.  -> per seq (len(ids) - prompt_len + 1,
        V) float32 logits at positions prompt_len - 1 ... the end: those that
        predicted each served token."""
        t = self.cfg["text_config"]
        H, N = t["hidden_size"], t["num_attention_heads"]
        Nkv = t.get("num_key_value_heads") or N
        hd, eps, kv = H // N, t["rms_norm_eps"], self.prec["kv"]
        dev = self.w["model.norm.weight"].device
        table = self.embedding_table()
        hs, ropes, masks = [], [], []
        for s in seqs:
            ids = torch.as_tensor(s["ids"], device=dev)
            e = table[ids]
            img = self.encode(torch.as_tensor(s["pixels"], device=dev))
            p = s["img_start"]
            e[p + 1:p + 1 + len(img)] = img
            hs.append(e)
            S = len(ids)
            inv = 1.0 / (t["rope_theta"] ** (torch.arange(0, hd, 2, device=dev).float() / hd))
            ang = torch.arange(S, device=dev).float()[:, None] * inv[None]
            ang = torch.cat([ang, ang], -1)
            ropes.append((ang.cos()[:, None], ang.sin()[:, None]))
            masks.append(torch.ones(S, S, dtype=torch.bool, device=dev).tril())
        del table

        def rot(x, cs):
            cos, sin = cs
            half = x.shape[-1] // 2
            return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin

        for l in range(t["num_hidden_layers"]):
            p = f"model.layers.{l}."
            W = {n: self.text_matrix(p + n + ".weight") for n in (
                "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")}
            n_in, n_post = self.f32(p + "input_layernorm.weight"), self.f32(
                p + "post_attention_layernorm.weight")
            for i, s in enumerate(seqs):
                h, S, P = hs[i], len(hs[i]), s["prompt_len"]
                x = self.act(_rms(h, n_in, eps))
                q = rot((x @ W["self_attn.q_proj"].t()).reshape(S, N, hd), ropes[i])
                k = rot((x @ W["self_attn.k_proj"].t()).reshape(S, Nkv, hd), ropes[i])
                v = (x @ W["self_attn.v_proj"].t()).reshape(S, Nkv, hd)
                rep = N // Nkv
                k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
                out = [_attend(q[:P], k, v, masks[i][:P])]
                if S > P:  # decode positions: over the cache as it is stored
                    out.append(_attend(q[P:], kv_round(k, kv), kv_round(v, kv), masks[i][P:]))
                h = h + self.act(torch.cat(out)) @ W["self_attn.o_proj"].t()
                x = self.act(_rms(h, n_post, eps))
                m = F.silu(x @ W["mlp.gate_proj"].t()) * (x @ W["mlp.up_proj"].t())
                hs[i] = h + self.act(m) @ W["mlp.down_proj"].t()
            del W
        head = self.text_matrix("lm_head.weight")
        n_final = self.f32("model.norm.weight")
        return [self.act(_rms(h[s["prompt_len"] - 1:], n_final, eps)) @ head.t()
                for h, s in zip(hs, seqs)]
