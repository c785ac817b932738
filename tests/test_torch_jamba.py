"""The Jamba text tower (``models/jamba.py``) against the plain reference
(``tests/jamba_reference.py``) and the reference against transformers'
``JambaForCausalLM``, at tiny sizes in float32 on the CPU: the full forward,
the int4 tier, routing, the loader, the paged pool's chunked admissions and
decode, and the paths that refuse the tower.

Tolerances: in float32 the port and the reference differ only in the order
of sums (f32 products, the scan's reduction over the states), ~1e-6 of the
logits' scale; ``TOL`` (2e-4 absolute on logits of magnitude ~1) leaves
two orders of magnitude of room and is still a hundred times below what a
state lost at a chunk boundary or decayed by padding moves (>= 0.05 here).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from tests import jamba_reference as ref
from visualcla_tpu_torch.checkpoint.jamba import load_text_
from visualcla_tpu_torch.core.config import (JambaConfig, LlamaConfig, VisualCLAConfig,
                                             tiny_visualcla_config)
from visualcla_tpu_torch.engine import paged
from visualcla_tpu_torch.engine.paged import PagedServingEngine
from visualcla_tpu_torch.engine.sampling import SamplingConfig
from visualcla_tpu_torch.models import jamba
from visualcla_tpu_torch.models.jamba import Jamba, dispatch, quantize_jamba_, route
from visualcla_tpu_torch.models.visualcla import VisualCLAModel, init_random_, quantize_text_tower_
from visualcla_tpu_torch.ops.cuda import selective_scan as b8
from visualcla_tpu_torch.ops.linear import Linear
from visualcla_tpu_torch.ops.quantization import dequantize_grouped

TOL = 2e-4

HF = dict(vocab_size=96, hidden_size=64, intermediate_size=96, num_hidden_layers=4,
          num_attention_heads=4, num_key_value_heads=2, attn_layer_period=4, attn_layer_offset=1,
          expert_layer_period=2, expert_layer_offset=1, num_experts=4, num_experts_per_tok=2,
          mamba_d_state=16, mamba_d_conv=4, mamba_expand=2, mamba_dt_rank=8,
          mamba_conv_bias=True, mamba_proj_bias=False, rms_norm_eps=1e-6,
          tie_word_embeddings=False, hidden_act="silu")


def hf_weights(cfg: dict, seed: int) -> dict:
    """HF-named float32 tensors of a Jamba tower: matrices N(0, 0.05^2), norm
    weights 1 + N(0, 0.1^2), A_log log(1..N) + N(0, 0.1^2), dt_proj's bias the
    inverse softplus of a log-uniform dt in [1e-3, 1e-1] (Mamba's init), so
    the state carries over many tokens."""
    g = torch.Generator().manual_seed(seed)
    H, I, V, E = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], cfg["num_experts"]
    N, Nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, D, S, R = H // N, cfg["mamba_expand"] * H, cfg["mamba_d_state"], ref.dt_rank(cfg)

    def w(*shape, std=0.05):
        return torch.randn(*shape, generator=g) * std

    def norm(n):
        return 1.0 + w(n, std=0.1)

    out = {"model.embed_tokens.weight": w(V, H, std=0.5), "lm_head.weight": w(V, H, std=0.2),
           "model.final_layernorm.weight": norm(H)}
    for i, (kind, n_exp) in enumerate(ref.layer_kinds(cfg)):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = norm(H)
        out[p + "pre_ff_layernorm.weight"] = norm(H)
        if kind == "attention":
            for n, shape in (("q", (N * hd, H)), ("k", (Nkv * hd, H)), ("v", (Nkv * hd, H)),
                             ("o", (H, N * hd))):
                out[f"{p}self_attn.{n}_proj.weight"] = w(*shape, std=0.1)
        else:
            m = p + "mamba."
            dt = torch.exp(torch.rand(D, generator=g) * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3))
            out.update({m + "in_proj.weight": w(2 * D, H, std=0.1),
                        m + "conv1d.weight": w(D, 1, 4, std=0.3), m + "conv1d.bias": w(D, std=0.1),
                        m + "x_proj.weight": w(R + 2 * S, D, std=0.1),
                        m + "dt_proj.weight": w(D, R, std=0.1),
                        m + "dt_proj.bias": dt + torch.log(-torch.expm1(-dt)),
                        m + "A_log": torch.log(torch.arange(1, S + 1).float()).expand(D, S)
                        + w(D, S, std=0.1),
                        m + "D": norm(D), m + "out_proj.weight": w(H, D, std=0.1),
                        m + "dt_layernorm.weight": norm(R), m + "b_layernorm.weight": norm(S),
                        m + "c_layernorm.weight": norm(S)})
        f = p + "feed_forward."
        if n_exp > 1:
            out[f + "router.weight"] = w(E, H, std=0.3)
            for e in range(E):
                for n, shape in (("gate", (I, H)), ("up", (I, H)), ("down", (H, I))):
                    out[f"{f}experts.{e}.{n}_proj.weight"] = w(*shape, std=0.1)
        else:
            for n, shape in (("gate", (I, H)), ("up", (I, H)), ("down", (H, I))):
                out[f"{f}{n}_proj.weight"] = w(*shape, std=0.1)
    return out


def port_config(**over) -> JambaConfig:
    return JambaConfig.from_hf_dict({**HF, "model_type": "jamba", **over})


def port_tower(weights: dict, **over) -> Jamba:
    t = Jamba(port_config(**over), dtype=torch.float32)
    load_text_(t, dict(weights))
    return t


@pytest.fixture(scope="module")
def weights():
    return hf_weights(HF, 7)


# -- the reference against transformers --------------------------------------------


def test_reference_matches_transformers(weights):
    tr = pytest.importorskip("transformers")
    cfg = tr.JambaConfig(**HF, use_mamba_kernels=False, attn_implementation="eager")
    model = tr.JambaForCausalLM(cfg).eval()
    model.load_state_dict(weights)
    ids = torch.randint(0, HF["vocab_size"], (1, 29), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(ids).logits[0]
    got = ref.logits(ids[0], HF, weights)
    assert (got - want).abs().max() < 1e-5


# -- the tower ------------------------------------------------------------------------


def test_config_layer_kinds_and_reader():
    c = JambaConfig()  # AI21-Jamba2-Mini's shape
    kinds = c.layers_block_type
    assert [i for i, k in enumerate(kinds) if k == "attention"] == [4, 12, 20, 28]
    assert c.num_mamba_layers == 28 and c.mamba_dt_rank == 256
    assert sum(n > 1 for n in c.layers_num_experts) == 16 and c.layers_num_experts[1] == 16
    v = VisualCLAConfig.from_hf_dict({"text_config": {**HF, "model_type": "jamba"}})
    assert isinstance(v.text_config, JambaConfig) and v.text_config.num_experts == 4
    again = VisualCLAConfig.from_hf_dict(v.to_hf_dict())
    assert again.text_config == v.text_config
    with pytest.raises(ValueError, match="sliding_window"):
        JambaConfig.from_hf_dict({**HF, "model_type": "jamba", "sliding_window": 4096})


@pytest.mark.parametrize("d", [{"model_type": "qwen2"}, {"model_type": "deepseek_v2"},
                               {"rope_scaling": {"type": "linear", "factor": 2.0}},
                               {"sliding_window": 4096}])
def test_llama_reader_refuses_what_it_would_drop(d):
    with pytest.raises(ValueError):
        LlamaConfig.from_hf_dict({"hidden_size": 64, **d})
    with pytest.raises(ValueError):
        VisualCLAConfig.from_hf_dict({"text_config": {"hidden_size": 64, **d}})


@pytest.mark.parametrize("d", [{}, {"model_type": "llama"}, {"model_type": "mistral"},
                               {"rope_scaling": None, "sliding_window": None}])
def test_llama_reader_takes_llama_and_mistral(d):
    assert LlamaConfig.from_hf_dict({"hidden_size": 64, **d}).hidden_size == 64


@pytest.mark.parametrize("S", [1, 5, 23])
def test_tower_forward_matches_reference(weights, S):
    ids = torch.randint(0, HF["vocab_size"], (1, S), generator=torch.Generator().manual_seed(S))
    got = port_tower(weights).forward_logits(ids)[0]
    want = ref.logits(ids[0], HF, weights)
    assert (got - want).abs().max() < TOL


def test_tower_chunks_chain_the_state(weights):
    """Three chunks of a right-padded prompt through ``forward`` (the
    admission's tower stage) equal one pass: the K/V, and the Mamba states
    at the last real token."""
    t = port_tower(weights)
    S, L = 21, 32
    ids = torch.randint(0, HF["vocab_size"], (1, L), generator=torch.Generator().manual_seed(3))
    e = t.embed(ids)
    mask = torch.zeros(1, L, dtype=torch.bool)
    mask[:, :S] = True
    one = t.init_kv_cache(1, L, torch.float32)
    h1, _ = t(e, None, one, mask, 0)
    chunks = t.init_kv_cache(1, L, torch.float32)
    hs = []
    for c0 in (0, 8, 16):
        valid = mask & (torch.arange(L) < c0 + 8)[None]
        h, _ = t(e[:, c0:c0 + 8], None, chunks, valid, c0)
        hs.append(h)
    h2 = torch.cat(hs, 1)
    assert (h1[:, :S] - h2[:, :S]).abs().max() < 1e-5
    for name in ("conv", "ssm"):
        assert (one[name] - chunks[name]).abs().max() < 1e-5
    short = t.init_kv_cache(1, S, torch.float32)
    t(e[:, :S], None, short, mask[:, :S], 0)  # no padding at all
    for name in ("conv", "ssm"):
        assert (short[name] - chunks[name]).abs().max() < 1e-5


def test_int4_tier_matches_the_reference_on_int4_weights(weights):
    """``quantize_jamba_`` against the reference over the same weights
    rounded as the int4 tier stores them (grouped int4 layers, experts and
    head; the per-row int8 table)."""
    t = port_tower(weights)
    quantize_jamba_(t)
    tier = {}
    for name, w in weights.items():
        if name == "model.embed_tokens.weight":
            s = w.abs().amax(-1, keepdim=True) / 127.0
            tier[name] = torch.round(w / s).clamp(-127, 127) * s
        elif w.dim() == 2 and ("proj" in name or name == "lm_head.weight") and \
                "x_proj" not in name and "dt_proj" not in name:
            from visualcla_tpu_torch.ops.quantization import effective_group, quantize_grouped
            wq = quantize_grouped(w.t(), group=effective_group(w.shape[1]))
            tier[name] = dequantize_grouped(wq["q"], wq["scale"]).t()
        else:
            tier[name] = w
    ids = torch.randint(0, HF["vocab_size"], (1, 17), generator=torch.Generator().manual_seed(5))
    got = t.forward_logits(ids)[0]
    want = ref.logits(ids[0], HF, tier)
    assert (got - want).abs().max() < TOL
    assert (got - ref.logits(ids[0], HF, weights)).abs().max() > 10 * TOL  # int4 moved them


def test_routing_top2_unnormalized_and_ties():
    router = Linear(4, 4, False, dtype=torch.float32)
    with torch.no_grad():
        router.weight.copy_(torch.eye(4))
    x = torch.tensor([[3.0, 1.0, 2.0, 0.0],  # distinct: experts 0 then 2
                      [1.0, 1.0, 1.0, 1.0],  # all tied
                      [0.0, 2.0, 2.0, 0.0]])  # a tie for the top
    w, idx = route(router, x, 2)
    p = torch.softmax(x, -1)
    want_w, want_idx = torch.topk(p, 2, dim=-1)
    assert torch.equal(idx, want_idx) and torch.equal(w, want_w)
    assert idx[0].tolist() == [0, 2]
    assert abs(float(w[0].sum()) - float(p[0, 0] + p[0, 2])) < 1e-7 and float(w[0].sum()) < 0.95
    order, offsets, counts = dispatch(idx, 4)
    flat = idx.reshape(-1)
    assert offsets.tolist() == [0] + torch.cumsum(torch.bincount(flat, minlength=4), 0).tolist()
    assert flat[order].tolist() == sorted(flat.tolist())
    for e in range(4):  # stable: each expert's assignments in token order
        seg = order[offsets[e]:offsets[e + 1]].tolist()
        assert seg == sorted(seg)


def test_moe_computes_routed_tokens_only(weights, monkeypatch):
    """Each expert's product sees exactly the tokens routed to it."""
    t = port_tower(weights)
    seen = []
    orig = jamba.Experts.forward

    def spy(self, x, offsets, max_rows):
        seen.append(offsets.clone())
        return orig(self, x, offsets, max_rows)

    monkeypatch.setattr(jamba.Experts, "forward", spy)
    T = 11
    x = torch.randn(1, T, HF["hidden_size"], generator=torch.Generator().manual_seed(2))
    moe = t.layers[1].moe
    moe(x)
    assert len(seen) == 2 and int(seen[0][-1]) == T * 2  # gate/up and down, T k rows


def test_moe_routes_no_token_a_request_does_not_need(weights, monkeypatch):
    """Tokens outside ``live`` (a chunk's padding, rows that do not run) go to
    no expert: the experts' ranges hold the live tokens' assignments alone,
    the tally counts only them, their outputs are 0, and the live tokens'
    outputs are those of the unmasked pass."""
    t = port_tower(weights)
    seen = []
    orig = jamba.Experts.forward

    def spy(self, x, offsets, max_rows):
        seen.append(offsets.clone())
        return orig(self, x, offsets, max_rows)

    monkeypatch.setattr(jamba.Experts, "forward", spy)
    x = torch.randn(2, 7, HF["hidden_size"], generator=torch.Generator().manual_seed(6))
    live = torch.zeros(2, 7, dtype=torch.bool)
    live[0, :5] = True
    live[1, :2] = True
    moe = t.layers[1].moe
    full = moe(x)
    tally = (torch.zeros(HF["num_experts"], dtype=torch.int64), torch.zeros((), dtype=torch.int64))
    got = moe(x, tally, live)
    n = int(live.sum())
    assert [int(o[-1]) for o in seen[2:]] == [2 * n, 2 * n]  # gate/up and down
    assert int(tally[0].sum()) == 2 * n and int(tally[1]) == int((tally[0] > 0).sum())
    assert (got[live] - full[live]).abs().max() < 1e-6
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))


def test_streaming_loader_equals_a_whole_load(weights):
    """A mapping whose values are produced on access (and never held)
    loads the same tower as a dict, at both tiers."""
    from collections.abc import Mapping

    class Produced(Mapping):
        def __init__(self, src):
            self.src, self.reads = src, 0

        def __getitem__(self, k):
            self.reads += 1
            return self.src[k].clone()

        def __iter__(self):
            return iter(self.src)

        def __len__(self):
            return len(self.src)

    for tier in ("none", "int4"):
        a = Jamba(port_config(), dtype=torch.float32, quant=tier)
        load_text_(a, dict(weights))
        b = Jamba(port_config(), dtype=torch.float32, quant=tier)
        lazy = Produced(weights)
        load_text_(b, lazy)
        assert lazy.reads == len(weights)
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(KeyError, match="lacks"):
        load_text_(Jamba(port_config(), dtype=torch.float32),
                   {k: v for k, v in weights.items() if "experts.3.down" not in k})


# -- the VisualCLA model over a Jamba tower, served by the paged pool ----------------------


def visualcla_jamba(weights, quant="none"):
    cfg = dataclasses.replace(tiny_visualcla_config(vocab_size=HF["vocab_size"],
                                                    hidden_size=HF["hidden_size"]),
                              text_config=port_config())
    model = VisualCLAModel(cfg, dtype=torch.float32)
    init_random_(model, torch.Generator().manual_seed(11))
    load_text_(model.text, dict(weights))
    if quant == "int4":
        quantize_text_tower_(model, 4)
    return model, cfg


class Recorder:
    """The logits each admission and decode step sampled from, by row."""

    def __init__(self, eng, monkeypatch):
        self.eng, self.rows = eng, {}
        self.admitting = None
        orig_finish, orig_sample = eng._finish_step, paged.sample_step_rowwise

        def finish(run, lens, logits, flags):
            for r in np.flatnonzero(run.numpy()):
                self.rows[int(r)].append(logits[r].clone())
            return orig_finish(run, lens, logits, flags)

        def sample(logits, *a, **k):
            if logits.shape[0] == 1 and self.admitting is not None:
                self.rows[self.admitting] = [logits[0].clone()]
            return orig_sample(logits, *a, **k)

        eng._finish_step = finish
        monkeypatch.setattr(paged, "sample_step_rowwise", sample)


def serve(eng, rec, prompts, chunk):
    """Admit ``prompts`` (row, ids) one at a time, chunked, with decode steps
    for the live rows between chunks; decode 6 more steps; -> {row: ids}."""
    for row, ids in prompts:
        rec.admitting = row
        pending = eng.begin_prefill(row, ids, None, None, 40, chunk=chunk)
        while not pending.step():
            if eng._host_active.any():
                rec.admitting = None
                eng.step()
                rec.admitting = row
        rec.admitting = None
    for _ in range(6):
        eng.step()
    snap = eng.snapshot()
    return {row: snap["gen_ids"][row, :snap["gen_len"][row]] for row, _ in prompts}


def check_rows(weights, rec, prompts, out, tol=TOL):
    worst = 0.0
    for row, ids in prompts:
        seq = list(ids) + out[row].tolist()[:-1]
        want = ref.logits(torch.as_tensor(seq), HF, weights)[len(ids) - 1:]
        got = torch.stack(rec.rows[row])
        assert got.shape[0] == len(out[row]) == want.shape[0]
        worst = max(worst, float((got - want).abs().max()))
    return worst


def _engine(model, cfg, rows=3):
    return PagedServingEngine(model, cfg, eos_token_id=HF["vocab_size"] + 5, pad_token_id=0,
                              pool_size=rows, block_size=16, num_blocks=64, max_seq_len=128,
                              prompt_buckets=(32, 64), sampling=SamplingConfig.greedy(40))


def _prompts(n_rows=3, lens=(37, 21, 50)):
    g = np.random.default_rng(4)
    return [(r, g.integers(1, HF["vocab_size"], lens[r]).astype(np.int64)) for r in range(n_rows)]


def test_paged_pool_matches_reference(weights, monkeypatch):
    """Chunked admissions of right-padded prompts (16-token chunks, lengths
    that are not multiples), rows admitted while others decode, then a row
    released, parked through decode steps, and re-admitted into its slot:
    every logit the pool sampled from equals the reference's full forward."""
    model, cfg = visualcla_jamba(weights)
    eng = _engine(model, cfg)
    rec = Recorder(eng, monkeypatch)
    prompts = _prompts()
    out = serve(eng, rec, prompts, chunk=16)
    assert check_rows(weights, rec, prompts, out) < TOL
    assert eng.counts["ssm_state_writes"] == 3 * cfg.text_config.num_mamba_layers
    eng.release_rows([1])
    for _ in range(3):  # row 1 parked while 0 and 2 decode
        eng.step()
    again = [(1, np.random.default_rng(9).integers(1, HF["vocab_size"], 26).astype(np.int64))]
    out2 = serve(eng, rec, again, chunk=16)
    assert check_rows(weights, rec, again, out2) < TOL
    tokens = np.asarray(eng.counts["moe_expert_tokens"]).reshape(2, 4)
    assert tokens.sum() > 0 and eng.counts["moe_experts_hit"] > 0


def test_paged_pool_one_shot_admission(weights, monkeypatch):
    model, cfg = visualcla_jamba(weights)
    eng = _engine(model, cfg, rows=2)
    rec = Recorder(eng, monkeypatch)
    prompts = _prompts(2, (45, 9))
    for row, ids in prompts:
        rec.admitting = row
        eng.prefill_row(row, ids, None, None, 40)
    rec.admitting = None
    for _ in range(5):
        eng.step()
    snap = eng.snapshot()
    out = {row: snap["gen_ids"][row, :snap["gen_len"][row]] for row, _ in prompts}
    assert check_rows(weights, rec, prompts, out) < TOL
    # each MoE layer routed the prompts' real tokens and the 2 x 5 decoded
    # ones, top 2: not the buckets' padding (64 + 32 slots) nor idle rows
    tokens = np.asarray(eng.counts["moe_expert_tokens"]).reshape(2, HF["num_experts"])
    assert tokens.sum(-1).tolist() == [2 * (45 + 9 + 2 * 5)] * 2


def _drop_state_at_chunks(monkeypatch):
    orig = Jamba.forward

    def forward(self, e, pos, cache, valid, c0, **kw):
        for name in ("conv", "ssm", "conv_saved", "ssm_saved"):
            cache[name].zero_()
        return orig(self, e, pos, cache, valid, c0, **kw)

    monkeypatch.setattr(Jamba, "forward", forward)


def _padding_decays_the_state(monkeypatch):
    conv, scan = b8.conv_chunk, b8.scan_chunk

    def full(lens, x):
        return torch.full_like(lens, x.shape[1])

    monkeypatch.setattr(b8, "conv_chunk", lambda x, w, b, s, lens: conv(x, w, b, s, full(lens, x)))
    monkeypatch.setattr(b8, "scan_chunk", lambda u, dt, bias, A, B, C, D, z, s, lens:
                        scan(u, dt, bias, A, B, C, D, z, s, full(lens, u)))


@pytest.mark.parametrize("fault", [_drop_state_at_chunks, _padding_decays_the_state])
def test_a_broken_state_path_fails_the_comparison(weights, monkeypatch, fault):
    model, cfg = visualcla_jamba(weights)
    eng = _engine(model, cfg)
    rec = Recorder(eng, monkeypatch)
    fault(monkeypatch)
    prompts = _prompts()
    out = serve(eng, rec, prompts, chunk=16)
    assert check_rows(weights, rec, prompts, out) > 100 * TOL


def test_paged_pool_int4_tier(weights, monkeypatch):
    """The int4 tier served (B7's and B3's plain versions): its logits against
    the reference's at f32 on the same weights stay within the int4
    rounding's reach, and the engine computes the same as the tier's own
    full forward."""
    model, cfg = visualcla_jamba(weights, quant="int4")
    eng = _engine(model, cfg, rows=2)
    rec = Recorder(eng, monkeypatch)
    prompts = _prompts(2, (37, 21))
    out = serve(eng, rec, prompts, chunk=16)
    for row, ids in prompts:
        seq = torch.as_tensor(list(ids) + out[row].tolist()[:-1])[None]
        want = model.text.forward_logits(seq)[0, len(ids) - 1:]
        assert (torch.stack(rec.rows[row]) - want).abs().max() < TOL


# -- what refuses the tower -------------------------------------------------------------


def test_unsupported_paths_raise(weights):
    from visualcla_tpu_torch.engine.beam import beam_generate
    from visualcla_tpu_torch.engine.generate import Engine
    from visualcla_tpu_torch.engine.server import ServingEngine
    from visualcla_tpu_torch.engine.speculative import SpeculativeDecoder
    from visualcla_tpu_torch.parallel.sharding import shard_params
    from visualcla_tpu_torch.train.trainer import make_train_step

    model, cfg = visualcla_jamba(weights)
    eng = Engine(model, cfg, eos_token_id=2, max_seq_len=128)  # the bundle builds one
    with pytest.raises(NotImplementedError, match="Jamba"):
        eng.generate(np.ones((1, 5), np.int64), sampling=SamplingConfig.greedy(2))
    with pytest.raises(NotImplementedError, match="Jamba"):
        SpeculativeDecoder(eng)
    with pytest.raises(NotImplementedError, match="Jamba"):
        beam_generate(model, cfg, np.ones((1, 5), np.int64), None, None, num_beams=2,
                      max_new_tokens=2, eos_token_id=2)
    with pytest.raises(NotImplementedError, match="Jamba"):
        ServingEngine(model, cfg, eos_token_id=2, pad_token_id=0)
    with pytest.raises(NotImplementedError, match="Jamba"):
        PagedServingEngine(model, cfg, eos_token_id=2, pad_token_id=0, spec_k=3)
    with pytest.raises(NotImplementedError, match="Jamba"):
        shard_params(model, None)
    with pytest.raises(NotImplementedError, match="Jamba"):
        make_train_step(model, cfg, None)
    with pytest.raises(NotImplementedError, match="int4"):
        quantize_text_tower_(model, 8)


def test_stages_run_twice_at_first_use_as_a_capture_does(weights, monkeypatch):
    """A graph's capture first runs its step once (the decode step gated off,
    an admission stage as it is): the pool's admissions and decode still
    match the reference when every key's first use runs twice (a tower
    chunk starts from its saved state, not from what its first run left)."""
    from visualcla_tpu_torch.engine import graphs

    seen = set()
    orig = graphs.Graphs.run

    def run(self, key, fn, device, **kw):
        if (kw.get("space"), key) not in seen:
            seen.add((kw.get("space"), key))
            enable = self.enable(device)
            enable.fill_(False)
            fn()
            enable.fill_(True)
        return orig(self, key, fn, device, **kw)

    monkeypatch.setattr(graphs.Graphs, "run", run)
    model, cfg = visualcla_jamba(weights)
    eng = _engine(model, cfg)
    rec = Recorder(eng, monkeypatch)
    prompts = _prompts()
    out = serve(eng, rec, prompts, chunk=16)
    assert check_rows(weights, rec, prompts, out) < TOL
