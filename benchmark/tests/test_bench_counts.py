"""The operation and byte counts behind ``mfu``, ``b3_roofline`` and
``b4_roofline`` against hand counts, and the metric readers on a synthetic
record."""
from __future__ import annotations

import os
import types

import numpy as np
import pytest

from benchmark import run
from benchmark.harness import counts
from benchmark.tests.tiny import tiny_config

# tiny: H 128, I 256, L 2, V 22000, N 4, Nkv 2, hd 32
LAYER_PARAMS = 128 * 128 + 2 * 128 * 64 + 128 * 128 + 3 * 128 * 256


def _cfg(**kw):
    cfg = tiny_config(**kw)
    return cfg


def test_layer_params_and_decode_ops():
    cfg = _cfg()
    assert counts.layer_params(cfg) == LAYER_PARAMS == 147456
    # 2 x layers x params, attention 4 x N x hd x context a layer, the head
    assert counts.decode_ops(cfg, 10) == 2 * 2 * 147456 + 2 * 4 * 4 * 32 * 10 + 2 * 128 * 22000


def test_encode_and_prefill_ops():
    cfg = _cfg()
    # ViT: 5 tokens (4 patches + class), 2 layers of width 32, MLP 64, and the
    # patch products; resampler: 4 queries over 4 + 5 tokens; projection 32 -> 128
    vit = 2 * (2 * (4 * 32 * 32 + 2 * 32 * 64) * 5 + 4 * 5 * 5 * 32) + 2 * 4 * 3 * 196 * 32
    res = 2 * 2 * (2 * 4 * 32 * 32 + 2 * 9 * 32 * 32 + 2 * 4 * 32 * 64 + 2 * 4 * 9 * 32)
    assert counts.encode_ops(cfg) == vit + res + 2 * 4 * 32 * 128 == 534784
    # 3 tokens: causal attention covers 1 + 2 + 3 positions, 4 x hd x N a layer
    attn = 2 * 4 * 32 * 4 * (1 + 2 + 3)
    assert counts.prefill_ops(cfg, 3) == 534784 + 2 * 2 * 147456 * 3 + attn + 2 * 128 * 22000


def test_int4_call_and_pass_bound():
    nbytes, ops = counts.int4_call(2, 256, 128, 128)
    # carrier 256 x 128 / 2, f32 scales (2 groups x 128), x and y in bf16
    assert nbytes == 16384 + 1024 + 1024 + 512
    assert ops == 2 * 2 * 256 * 128
    cfg = _cfg(weights="int4")
    one = sum(counts.bound_s(*counts.int4_call(4, i, o, 128))
              for i, o in [(128, 128), (128, 64), (128, 64), (128, 128), (128, 256), (128, 256),
                           (256, 128)])
    head = counts.bound_s(*counts.int4_call(1, 128, 22000, 128, out_bytes=4))
    assert counts.int4_pass_bound_s(cfg, 4, 1) == pytest.approx(2 * one + head)


def test_paged_append_bytes():
    # q and output (4 heads x 32 bf16 each way), the new K/V, 10 cached, 1 written
    assert counts.paged_append_bytes(_cfg(), 10) == 2 * 4 * 32 * 2 + 12 * (2 * 2 * 32 * 2)
    # int8 pool: 32 int8 values and an f32 scale per head, K and V
    assert counts.paged_append_bytes(_cfg(kv_cache="int8"), 10) == 512 + 12 * (2 * 2 * 36)


def _record(cfg, with_slice=True, kernels=None):
    """Two requests of a 100-token prompt: A gets 3 tokens at 1.0, 1.1, 1.2;
    B 2 tokens at 2.5, 3.5; the window [0, 3), the slice [1.05, 2.6)."""
    def req(times):
        return types.SimpleNamespace(times=times, final=np.arange(len(times)), error=None,
                                     prompt_ids=np.zeros(100), due=0.0,
                                     plan=types.SimpleNamespace(sampled=False))

    stats = {"t_prefill": 0.0, "t_snapshot": 0.0, "t_stream": 0.0, "prefills": 0,
             "chunked_admissions": 0}
    c0 = {"stats": stats, "counts": {"decode_passes": 10}}
    c1 = {"stats": {**stats, "t_prefill": 0.6, "t_snapshot": 0.3, "t_stream": 0.15},
          "counts": {"decode_passes": 13}}
    rec = {"requests": [req([1.0, 1.1, 1.2]), req([2.5, 3.5])], "t0": 0.0, "t1": 3.0,
           "c0": c0, "c1": c1, "cfg": cfg, "cell": {"drain_s": 60}, "setup_s": 12.5,
           "slice": None}
    if with_slice:
        rec["slice"] = {"t0": 1.05, "t1": 2.6, "busy_s": 1.2, "window_s": 1.55,
                        "kernels": kernels if kernels is not None else
                        {"void paged_verify_mma_kernel<bf16>": 2e-6, "ampere_gemm": 1.0,
                         "void int4_decode_kernel<true>": 3e-3},
                        "c0": {"counts": {"decode_passes": 11}},
                        "c1": {"counts": {"decode_passes": 12}}}
    return rec


def _read(name, rec):
    path = os.path.join(run.BENCH, "metrics", name + ".py")
    return run.load_module(path, "t_" + name.replace(".", "_")).read(rec)


def test_readers_on_a_synthetic_record():
    cfg = _cfg()
    rec = _record(cfg)
    assert _read("ttft_p50_ms", rec) == pytest.approx(2500.0)  # higher of {1.0, 2.5}
    assert _read("output_tok_s", rec) == pytest.approx(4 / 3)
    assert _read("tail.ttft_p95_ms", rec) == pytest.approx(2500.0)
    assert _read("tail.tpot_p95_ms", rec) == pytest.approx(1000.0)
    assert _read("setup_s", rec) == 12.5
    assert _read("sched.admit_share", rec) == pytest.approx(20.0)
    assert _read("sched.stream_share", rec) == pytest.approx(15.0)
    # decoded tokens in the window: A's 2nd and 3rd; 3 passes
    assert _read("pool.rows_per_pass", rec) == pytest.approx(2 / 3)
    # the slice's work (A's tokens 1 and 2, B's first) over its 1.2 busy seconds
    want = (counts.prefill_ops(cfg, 100) + counts.decode_ops(cfg, 101)
            + counts.decode_ops(cfg, 102)) / (1.2 * counts.BF16_OPS_PER_S) * 100
    assert _read("mfu", rec) == pytest.approx(want)
    # in the slice: A's tokens 1 (cached 100) and 2 (cached 101); B's first
    nbytes = 2 * (counts.paged_append_bytes(cfg, 100) + counts.paged_append_bytes(cfg, 101))
    assert _read("b4_roofline", rec) == pytest.approx(
        100 * counts.bound_s(nbytes, 2 * (counts.paged_append_ops(cfg, 100)
                                          + counts.paged_append_ops(cfg, 101))) / 2e-6)
    assert _read("device_idle_share.serve", rec) == pytest.approx(100 * (1 - 1.2 / 1.55))
    assert _read("b3_roofline", rec) is None  # a bf16 tower
    cfg4 = _cfg(weights="int4", kv_cache="int8")
    rec4 = _record(cfg4)
    want = 100 * (counts.int4_pass_bound_s(cfg4, 4, 4)
                  + counts.int4_pass_bound_s(cfg4, 128, 1)) / 3e-3
    assert _read("b3_roofline", rec4) == pytest.approx(want)


def test_readers_without_a_trace_or_a_listed_kernel():
    cfg = _cfg(weights="int4", kv_cache="int8")
    for rec in (_record(cfg, with_slice=False), _record(cfg, kernels={"ampere_gemm": 1.0})):
        assert _read("b4_roofline", rec) is None
        assert _read("b3_roofline", rec) is None
    assert _read("device_idle_share.serve", _record(cfg, with_slice=False)) is None
    assert _read("mfu", _record(cfg, with_slice=False)) is None
