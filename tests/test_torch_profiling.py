"""``visualcla_tpu_torch.utils.profiling`` against the JAX package's
``utils/profiling.py``: the JAX module's own cases run against the port's,
and the engines' phase timer and counters (the JAX ``Engine`` times
"prefill" and "decode" and counts tokens and requests; its speculative
decoder counts chunks too) move as the JAX engines' do on one tiny fp32
checkpoint on the CPU."""
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu.engine.speculative import SpeculativeDecoder as JSpec
from visualcla_tpu.utils import profiling as j_prof
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.engine.speculative import SpeculativeDecoder as TSpec
from visualcla_tpu_torch.text import encoding_text
from visualcla_tpu_torch.utils import profiling as t_prof
from visualcla_tpu_torch.utils.profiling import Counters, PhaseTimer, trace

# -- tests/test_profiling.py's cases, against the port's module --------------


def test_phase_timer_accumulates():
    t = PhaseTimer()
    for _ in range(3):
        with t.phase("work"):
            time.sleep(0.01)
    s = t.summary()
    assert s["work"]["count"] == 3
    assert s["work"]["total_s"] >= 0.03
    assert s["work"]["p50_ms"] >= 10
    t.reset()
    assert t.summary() == {}


def test_phase_timer_sync_on_device_value():
    t = PhaseTimer()
    with t.phase("op", sync_on=torch.ones(4) * 2):
        pass
    with t.phase("op") as p:  # the tensor named inside the block
        p["sync_on"] = torch.ones(4) * 3
    assert t.summary()["op"]["count"] == 2


def test_counters_thread_safe():
    c = Counters()

    def bump():
        for _ in range(1000):
            c.add("tokens")

    ts = [threading.Thread(target=bump) for _ in range(4)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts)
    assert c.get("tokens") == 4000
    assert c.snapshot() == {"tokens": 4000}


def test_summary_keys_equal_the_jax_module_s():
    j, t = j_prof.PhaseTimer(), PhaseTimer()
    for timer in (j, t):
        with timer.phase("a"):
            pass
    assert j.summary().keys() == t.summary().keys()
    assert j.summary()["a"].keys() == t.summary()["a"].keys()
    assert isinstance(t_prof.GLOBAL_COUNTERS, Counters)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


# -- F6: the engines' timer and counters against the JAX engines' ------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ckpt, cfg = make_native_ckpt(str(tmp_path_factory.mktemp("prof")))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    s = cfg.vision_config.image_size
    pv = np.random.default_rng(5).standard_normal((1, 3, s, s)).astype(np.float32)
    ids = encoding_text([], "ab你好 ab你好", tm.num_patch, tm.tokenizer)["input_ids"]
    img = tm._img_positions(ids, pv)
    return jm, tm, ids, pv, img


def _deltas(counters, before):
    after = counters.snapshot()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ("generated_tokens", "requests", "spec_chunks")}


def _run(engine, decoder, gen_kw, ids, pv, img, counters):
    """One greedy generate and one speculative generate on a fresh timer:
    -> (ids, speculative ids, the timer's summary, the counters' deltas)."""
    engine.timer.reset()
    before = counters.snapshot()
    out = engine.generate(ids, pv, img, gen_kw)
    spec = decoder.generate(ids, pv, img, gen_kw)
    return np.asarray(out), np.asarray(spec), engine.timer.summary(), _deltas(counters, before)


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "text_only"])
def test_engine_timer_and_counters_match_jax(both, with_image):
    jm, tm, ids, pv, img = both
    pv = pv if with_image else None
    img = img if with_image else None
    j_out, j_spec, j_sum, j_d = _run(jm.engine, JSpec(jm.engine, spec_k=4, max_ngram=3),
                                     j_samp.SamplingConfig.greedy(max_new_tokens=12),
                                     ids, pv, img, j_prof.GLOBAL_COUNTERS)
    t_dec = TSpec(tm.engine, spec_k=4, max_ngram=3)
    t_out, t_spec, t_sum, t_d = _run(tm.engine, t_dec,
                                     t_samp.SamplingConfig.greedy(max_new_tokens=12),
                                     ids, pv, img, t_prof.GLOBAL_COUNTERS)
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_spec, j_spec)
    assert {k: v["count"] for k, v in t_sum.items()} == {"prefill": 2, "decode": 2}
    assert {k: v["count"] for k, v in t_sum.items()} == {k: v["count"] for k, v in j_sum.items()}
    assert t_d == j_d
    assert t_d["requests"] == 2
    assert t_d["spec_chunks"] == t_dec.last_stats["chunks"] >= 1


def test_batched_generate_counts_every_row(both):
    """B=2: ``generated_tokens`` is gen_len x B and ``requests`` B, as in JAX."""
    _, tm, ids, _, _ = both
    before = t_prof.GLOBAL_COUNTERS.snapshot()
    out = tm.engine.generate(np.concatenate([ids, ids]), None, None,
                             t_samp.SamplingConfig.greedy(max_new_tokens=6))
    d = _deltas(t_prof.GLOBAL_COUNTERS, before)
    assert d == {"generated_tokens": out.shape[1] * 2, "requests": 2, "spec_chunks": 0}


def test_stream_stays_untimed(both):
    """JAX times ``generate`` only, and so does the port."""
    _, tm, ids, _, _ = both
    tm.engine.timer.reset()
    before = t_prof.GLOBAL_COUNTERS.snapshot()
    toks = list(tm.engine.stream(ids, None, None, t_samp.SamplingConfig.greedy(4)))
    assert toks and tm.engine.timer.summary() == {}
    assert _deltas(t_prof.GLOBAL_COUNTERS, before)["requests"] == 0


def test_trace_around_a_generate(both, tmp_path):
    """``trace`` around a CPU generate names the model's ops in its file."""
    _, tm, ids, _, _ = both
    with trace(str(tmp_path / "t")):
        tm.engine.generate(ids, None, None, t_samp.SamplingConfig.greedy(3))
    with open(os.path.join(tmp_path, "t", "trace.json")) as f:
        names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    assert any("linear" in n or "mm" in n for n in names)
