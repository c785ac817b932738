"""The Jamba cell's harness on the CPU: the weights drawn again by name bit
for bit, the operation and parameter counts against the configuration's
published totals, the metric readers on a synthetic record, and whole runs
of ``drivers/serve_open_loop_jamba.py`` at a tiny size, the program served
on the CPU: a sound run reads ``correct``, and three faults planted under
the served path (the Mamba state dropped at a chunk boundary, the right
padding decaying it, a token altered where it is produced) read above the
limit."""
from __future__ import annotations

import copy
import os
import types

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import counts, counts_jamba, weights_jamba
from benchmark.harness.readings import bucket
from benchmark.tools import readings_jamba
from benchmark.tests.tiny import tiny_config

CELL = "jamba2mini-int4-serve-poisson"
# the widest-gap limit at this size: on the CPU the harness serves the tiny
# tower in float32, whose sound runs read 0 (the reference's own choices),
# while the faults read 0.034-0.2 (a state dropped at a chunk boundary the
# least) and a token altered ~1.4
TINY_MAX_GAP = 0.01


def tiny_jamba(weights: str = "int4") -> dict:
    """The cell's configuration at a size the CPU runs in seconds: 4 layers
    (one attention, layer 1; MoE in layers 1 and 3 over 4 experts, top 2),
    widths the int4 group of 128 divides."""
    cfg = tiny_config(weights=weights, kv_cache="int8")
    text = dict(model_type="jamba", hidden_size=128, intermediate_size=256, num_hidden_layers=4,
                num_attention_heads=4, num_key_value_heads=2, vocab_size=22000,
                max_position_embeddings=4096, rms_norm_eps=1e-6, hidden_act="silu",
                tie_word_embeddings=False, attn_layer_period=4, attn_layer_offset=1,
                expert_layer_period=2, expert_layer_offset=1, num_experts=4,
                num_experts_per_tok=2, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
                mamba_dt_rank=8, mamba_conv_bias=True, mamba_proj_bias=False,
                sliding_window=None)
    cfg.update(text, name="tiny-jamba", control={"weights": "int4", "kv": "int8",
                                                 "ssm_state": "bf16"})
    cfg["text_config"] = {k: text[k] for k in run.TEXT_KEYS if k in text}
    cfg["pool"].update(rows=2, prefill_chunk=64)
    return cfg


def test_weights_are_drawn_again_by_name_bit_for_bit():
    cfg = tiny_jamba()
    a = weights_jamba.make(cfg, 2 ** 31 + 3, torch.device("cpu"))
    b = weights_jamba.make(cfg, 2 ** 31 + 3, torch.device("cpu"))
    c = weights_jamba.make(cfg, 5, torch.device("cpu"))
    assert len(a["text"]) == len(weights_jamba.text_spec(cfg))
    for name in ("model.layers.1.feed_forward.experts.3.down_proj.weight",
                 "model.layers.2.mamba.A_log", "model.layers.0.mamba.dt_proj.bias",
                 "model.layers.1.self_attn.k_proj.weight", "lm_head.weight"):
        x = a["text"][name]
        assert torch.equal(x, a["text"][name]) and torch.equal(x, b["text"][name])
        assert not torch.equal(x, c["text"][name])
    assert all(torch.equal(a[t][n], b[t][n]) for t in ("vision", "resampler", "projection")
               for n in a[t])
    A = a["text"]["model.layers.0.mamba.A_log"].float()
    assert (A - torch.log(torch.arange(1.0, 17.0))).abs().max() < 0.6
    dt = torch.nn.functional.softplus(a["text"]["model.layers.0.mamba.dt_proj.bias"].float())
    assert 0.9e-3 < float(dt.min()) and float(dt.max()) < 0.11


def test_counts_match_the_published_totals():
    """51.6B parameters, 11.8B active a token; an expert's int4 bytes."""
    cfg = run.load_config("jamba2-mini-vl-int4")
    p = counts_jamba.param_counts(cfg)
    assert p["experts"] == 16 * 16 * 3 * 4096 * 14336
    assert p["attention"] == 4 * (2 * 4096 * 4096 + 2 * 4096 * 1024)
    assert p["mamba"] == 28 * (4096 * 16384 + 8192 * 288 + 256 * 8192 + 8192 * 4096
                               + 8192 * 4 + 8192 + 8192 * 16 + 2 * 8192 + 256 + 32)
    assert sum(p.values()) == pytest.approx(51.6e9, rel=2e-3)
    assert counts_jamba.active_matmul_params(cfg) == pytest.approx(11.8e9, rel=5e-3)
    assert counts_jamba.expert_bytes(cfg) == (3 * 4096 * 14336 // 2 + 32 * 28672 * 4
                                              + 112 * 4096 * 4)
    one = counts_jamba.decode_ops(cfg, 1)
    assert counts_jamba.prefill_ops(cfg, 1) == pytest.approx(
        counts_jamba.encode_ops(cfg) + one, rel=1e-6)


def _record(cfg, hit=30, tokens=(4, 0, 8, 4), trace=True):
    """One request admitted in the slice (a 40-token prompt) and 3 decoded
    tokens after it; the counters moved by ``hit`` experts and ``tokens``."""
    r = types.SimpleNamespace(prompt_ids=np.zeros(40), times=[1.1, 1.2, 1.3, 1.4],
                              final=np.zeros(4), error=None, due=1.0)
    c0 = {"counts": {"moe_experts_hit": 10, "moe_expert_tokens": (1, 1, 1, 1, 0, 0, 0, 0),
                     "decode_passes": 5}, "stats": {}}
    c1 = {"counts": {"moe_experts_hit": 10 + hit,
                     "moe_expert_tokens": tuple([1 + t for t in tokens] + [0, 2, 2, 0]),
                     "decode_passes": 8}, "stats": {}}
    sl = {"t0": 1.0, "t1": 2.0, "c0": c0, "c1": c1, "busy_s": 0.5, "window_s": 1.0,
          "kernels": {"void moe_int4_grouped_kernel<1, 1>": 2e-3,
                      "void selective_scan_kernel<true>": 1e-3,
                      "void selective_conv_step_kernel": 1e-4, "int4_decode_kernel": 5.0,
                      "void paged_verify_mma_kernel<2>": 1e-3}}
    return {"cfg": cfg, "requests": [r], "slice": sl if trace else None, "c0": c0, "c1": c1,
            "t0": 1.0, "t1": 2.0, "cell": {"drain_s": 60}}


def _read(name, rec):
    mod = run.load_module(os.path.join(run.BENCH, "metrics", name + ".py"),
                          "bench_metric_test_" + name.replace(".", "_"))
    return mod.read(rec)


def test_readers_on_a_synthetic_record():
    cfg = run.load_config("jamba2-mini-vl-int4")
    rec = _record(cfg)
    b7 = counts_jamba.b7_bound_s(cfg, 30, 16 + 4)
    assert _read("b7_roofline", rec) == pytest.approx(100 * b7 / 2e-3)
    b8 = counts_jamba.b8_bound_s(cfg, 40, 3)
    assert _read("b8_roofline", rec) == pytest.approx(100 * b8 / 1.1e-3)
    ops = counts_jamba.prefill_ops(cfg, 40) + sum(counts_jamba.decode_ops(cfg, 40 + j)
                                                  for j in (1, 2, 3))
    assert _read("mfu.jamba", rec) == pytest.approx(100 * ops / (0.5 * 989e12))
    # B3 over the tower's int4 products: 3 decode passes of 32 rows, the
    # admission at its bucket; B4 over the 4 attention layers alone
    b3 = 3 * counts_jamba.int4_pass_bound_s(cfg, 32, 32) + counts_jamba.int4_pass_bound_s(
        cfg, bucket(40), 1)
    assert _read("b3_roofline.jamba", rec) == pytest.approx(100 * b3 / 5.0)
    assert len(counts_jamba.int4_matmuls(cfg)) == 4 * 4 + 28 * 2 + 16 * 3
    b4 = [counts_jamba.b4_token_bound(cfg, 40 + j - 1) for j in (1, 2, 3)]
    assert b4[0][0] == 4 * counts.paged_append_bytes(cfg, 40)
    assert _read("b4_roofline.jamba", rec) == pytest.approx(
        100 * counts_jamba.bound_s(sum(b for b, _ in b4), sum(o for _, o in b4)) / 1e-3)
    # 4 experts: layer 0 (4, 0, 8, 4) over a mean of 4 -> 2; layer 1 (0, 2, 2, 0) -> 2
    assert _read("moe.expert_skew", {**rec, "cfg": {**cfg, "num_experts": 4}}) == 4.0
    # a LLaMA record (no MoE counters, no Jamba keys): every new reader is silent
    llama = _record(tiny_config(weights="int4"))
    for c in (llama["c0"], llama["c1"], llama["slice"]["c0"], llama["slice"]["c1"]):
        c["counts"] = {"decode_passes": 0}
    for name in ("b7_roofline", "b8_roofline", "mfu.jamba", "moe.expert_skew",
                 "b3_roofline.jamba", "b4_roofline.jamba"):
        assert _read(name, llama) is None
    assert _read("b7_roofline", _record(cfg, trace=False)) is None


# -- whole runs of the cell on the CPU -----------------------------------------------------


def _cell():
    cell = copy.deepcopy(run.load_json(run.BENCH, "workloads", CELL + ".json"))
    cell.update(rate_per_s=6.0, max_new_tokens={"median": 10, "sigma": 0.4, "min": 4, "max": 16},
                instruction_tokens={"median": 40, "sigma": 0.5, "min": 20, "max": 60},
                limits={"max_gap": TINY_MAX_GAP, "mean_gap": TINY_MAX_GAP})
    return cell


def _run(seed=2 ** 31 + 11):
    return run.run_cell(CELL, seed, 2.0, False, device=torch.device("cpu"), cfg=tiny_jamba(),
                        cell=_cell())


def _drop_state_at_chunks(monkeypatch):
    readings_jamba.drop_state_at_chunks(monkeypatch.setattr)


def _padding_decays_the_state(monkeypatch):
    readings_jamba.padding_decays_the_state(monkeypatch.setattr)


def _alter_tokens(monkeypatch):
    from visualcla_tpu_torch.engine import paged

    orig = paged.sample_step_rowwise

    def altered(logits, *a, **k):
        tok, mu = orig(logits, *a, **k)
        return (tok + 1) % logits.shape[-1], mu

    monkeypatch.setattr(paged, "sample_step_rowwise", altered)


def test_a_sound_jamba_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 12
    assert res["checks"]["max_gap"]["value"] < TINY_MAX_GAP / 3, res["checks"]


@pytest.mark.parametrize("fault", [_drop_state_at_chunks, _padding_decays_the_state,
                                   _alter_tokens])
def test_a_broken_jamba_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]


def test_the_readings_tool_reads_the_program_and_a_fault():
    """The readings the limit is set from, at the tiny size: the program
    under the limit and a token altered far above it.  (The control, the
    reference with its SSM state in bf16, is read here too; where it lies
    against the limit is a reading of the cell's own size on the card.)"""
    cell = _cell()
    driver = run.load_module(os.path.join(run.BENCH, "drivers", cell["driver"] + ".py"),
                             "benchmark_driver_" + cell["driver"])
    ctx = types.SimpleNamespace(cfg=tiny_jamba(), cell=cell, seed=2 ** 31 + 5, seconds=2.0,
                                trace=False, device=torch.device("cpu"), log=lambda m: None)
    r = driver.readings(driver.run(ctx), ctx)
    assert r["program"] < TINY_MAX_GAP <= r["fault_token_altered"] / 3, r
    assert r["control"] >= 0 and r["tokens"] > 0, r


def test_a_port_without_the_tower_fails_at_once(monkeypatch):
    """The parent commit has no Jamba tower: the cell ends with exit code 1
    before any weight is drawn or kernel built."""
    from benchmark.harness import program_jamba

    monkeypatch.setattr(program_jamba, "has_jamba", lambda: False)
    monkeypatch.setattr(program_jamba, "prebuild",
                        lambda log: pytest.fail("built kernels for a port without the tower"))
    with pytest.raises(SystemExit) as e:
        run.run_cell(CELL, 1, 1.0, False, device=torch.device("cpu"), cfg=tiny_jamba(),
                     cell=_cell())
    assert e.value.code == 1
