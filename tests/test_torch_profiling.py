"""``visualcla_tpu_torch.utils.profiling`` against the JAX package's
``utils/profiling.py``: the JAX module's own cases run against the port's,
and the engines' phase timer and counters (the JAX ``Engine`` times
"prefill" and "decode" and counts tokens and requests; its speculative
decoder counts chunks too) move as the JAX engines' do on one tiny fp32
checkpoint on the CPU."""
import json
import os
import sys
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


# -- spans: the recorder ------------------------------------------------------


def _names(spans):
    return [d["name"] for d in spans]


def test_span_off_records_nothing_and_returns_the_shared_no_op():
    rec = t_prof.SpanRecorder()
    assert not rec.recording()
    a, b = rec.span("x"), rec.span("y", rid=3, k=1)
    assert a is b is t_prof._NO_SPAN
    with a:
        pass
    rec.add("z", 1, 2)
    assert rec.take() == []


def test_spans_nest_per_thread_and_carry_rid():
    """A span's parent is the innermost span of its own thread that encloses
    it; a span without a rid takes its parent's; two threads' spans never
    parent each other."""
    rec = t_prof.SpanRecorder()
    rec.record(True)
    go = threading.Barrier(2, timeout=60)

    def work(rid):
        go.wait()
        with rec.span("outer", rid=rid):
            with rec.span("mid", k=rid):
                with rec.span("inner"):
                    time.sleep(0.002)
            with rec.span("sibling"):
                pass
        with rec.span("after"):
            pass

    ts = [threading.Thread(target=work, args=(r,)) for r in (1, 2)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts)
    rec.record(False)
    spans = rec.take()
    assert len(spans) == 10 and len({d["tid"] for d in spans}) == 2
    by_id = {d["id"]: d for d in spans}
    for d in spans:
        p = by_id.get(d["parent"])
        want = {"outer": None, "mid": "outer", "inner": "mid", "sibling": "outer",
                "after": None}[d["name"]]
        assert (p and p["name"]) == want
        if p:
            assert p["tid"] == d["tid"] and p["start_ns"] <= d["start_ns"] <= d["end_ns"] \
                <= p["end_ns"]
    rid = {d["tid"]: d["rid"] for d in spans if d["name"] == "outer"}
    assert sorted(rid.values()) == [1, 2]
    for d in spans:
        assert d["rid"] == (None if d["name"] == "after" else rid[d["tid"]])
    assert all(d["attrs"] == {"k": d["rid"]} for d in spans if d["name"] == "mid")
    assert [d["start_ns"] for d in spans] == sorted(d["start_ns"] for d in spans)
    # add(): the caller's own times and thread
    rec.record(True)
    rec.add("timed", 10, 20, rid=7, tid=12345, end="done")
    got = [d for d in rec.take(0, 11)]
    assert got == [{"id": got[0]["id"], "name": "timed", "start_ns": 10, "end_ns": 20,
                    "tid": 12345, "parent": None, "rid": 7, "attrs": {"end": "done"}}]


def test_span_buffer_is_bounded():
    rec = t_prof.SpanRecorder(capacity=8)
    rec.record(True)
    for i in range(20):
        rec.add(f"s{i}", i, i + 1)
    assert _names(rec.take()) == [f"s{i}" for i in range(12, 20)]
    assert t_prof.SPANS._spans.maxlen == t_prof.SPAN_CAPACITY


def test_spans_are_thread_safe():
    """Eight threads record while another takes: every span kept once."""
    rec = t_prof.SpanRecorder()
    rec.record(True)
    n, per = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def bump(k):
            for i in range(per):
                with rec.span("s", rid=k):
                    pass

        ts = [threading.Thread(target=bump, args=(k,)) for k in range(n)]
        [t.start() for t in ts]
        while any(t.is_alive() for t in ts):
            rec.take()
        [t.join(timeout=60) for t in ts]
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    spans = rec.take()
    assert len(spans) == n * per == len({d["id"] for d in spans})
    assert all(np.bincount([d["rid"] for d in spans]) == per)


def test_spans_follow_the_profiler_and_the_phase_timer():
    """A running torch.profiler turns recording on (and off after it);
    ``PhaseTimer.phase`` opens a span of its phase's name."""
    t = PhaseTimer()
    t0 = time.time_ns()
    with t.phase("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert t_prof.SPANS.recording()
        with t.phase("prefill"):
            with t_prof.span("inside"):
                pass
    assert not t_prof.SPANS.recording()
    with t.phase("after"):
        pass
    spans = t_prof.take_spans(t0)
    assert _names(spans) == ["prefill", "inside"]
    assert spans[1]["parent"] == spans[0]["id"]
    assert t.summary().keys() == {"before", "prefill", "after"}


def test_trace_writes_spans_on_the_profiler_clock(tmp_path):
    """Inside ``trace``, an ``aten::mm`` run under a span lies within that
    span in the written trace.json."""
    a = torch.randn(256, 256)
    with trace(str(tmp_path)):
        with t_prof.span("matmul", rid=5):
            time.sleep(0.001)
            a @ a
            time.sleep(0.001)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    sp = [e for e in events if e.get("cat") == "span" and e["name"] == "matmul"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert len(sp) == 1 and mm
    assert sp[0]["args"]["rid"] == 5 and sp[0]["pid"] == os.getpid()
    for e in mm:
        assert sp[0]["ts"] <= e["ts"] and e["ts"] + e["dur"] <= sp[0]["ts"] + sp[0]["dur"]


# -- spans and counters of the served path ------------------------------------

ADMIT_CHILDREN = ["admit.host", "admit.encode", "admit.tower", "admit.scatter",
                  "admit.first_token"]


@pytest.fixture(scope="module")
def served(both):
    """Three requests through the Scheduler over the paged pool, spans on:
    one of one token alone (a one-shot admission; its chunk is one gated
    replay), the image chat (one-shot), and, once the chat streams, a
    45-token prompt admitted in 16-token chunks beside it.  No EOS (the
    rows stop at their caps).  The pool's gate is spied on: every decode
    pass's ``go``."""
    from visualcla_tpu_torch.engine import paged, server

    _, tm, _, pv, _ = both
    tok = tm.tokenizer
    eng = paged.PagedServingEngine(
        tm.model, tm.config, eos_token_id=-1, pad_token_id=tok.pad_token_id, pool_size=3,
        block_size=16, num_blocks=40, max_seq_len=256, max_new_tokens_cap=64,
        prompt_buckets=(32, 64, 128, 256), sampling=t_samp.SamplingConfig.greedy(64))
    gates, gate = [], eng._gate

    def spy():
        run, go = gate()
        gates.append(bool(go))
        return run, go

    eng._gate = spy
    chat = encoding_text([], "ab你好", tm.num_patch, tok)["input_ids"][0]
    img = int(np.flatnonzero(chat == tok.img_start_token_id)[0])
    t0 = time.time_ns()
    t_prof.record_spans(True)
    sched = server.Scheduler(eng, prefill_chunk=16)
    stats0, streaming, outs = sched.stats(), threading.Event(), {}
    try:
        outs[1] = server.generate_sync(sched, np.arange(4, 13), max_new_tokens=1, timeout=120)

        def chat_stream():
            for kind, x in server.generate_stream(sched, chat, pv, img, max_new_tokens=40,
                                                  timeout=120):
                streaming.set()
                outs[2] = x

        th = threading.Thread(target=chat_stream)
        th.start()
        assert streaming.wait(120)
        outs[3] = server.generate_sync(sched, np.arange(5, 50) % 17 + 3, max_new_tokens=8,
                                       timeout=120)
        th.join(timeout=120)
        assert not th.is_alive()
    finally:
        sched.stop()
        t_prof.record_spans(False)
    spans = t_prof.take_spans(t0)
    return {"eng": eng, "sched": sched, "stats0": stats0, "stats": sched.stats(),
            "gates": gates, "spans": spans, "outs": outs,
            "by_id": {d["id"]: d for d in spans}}


def _children(sv, parent):
    return [d for d in sv["spans"] if d["parent"] == parent["id"]]


def _request_spans(sv, rid, *names):
    return [d for d in sv["spans"] if d["rid"] == rid and d["name"] in names]


@pytest.mark.parametrize("rid,form", [(1, "one_shot"), (2, "one_shot"), (3, "chunked")])
def test_every_admission_has_its_queue_wait_and_children(served, rid, form):
    sv = served
    assert [len(sv["outs"][k]) for k in (1, 2, 3)] == [1, 40, 8]
    (req,) = _request_spans(sv, rid, "request")
    (wait,) = _request_spans(sv, rid, "sched.queue_wait")
    assert req["attrs"]["end"] == "done" and wait["parent"] == req["id"]
    assert wait["tid"] == req["tid"] and wait["start_ns"] == req["start_ns"]
    if form == "one_shot":
        assert not _request_spans(sv, rid, "sched.admit_begin", "sched.admit_stage")
        (admit,) = _request_spans(sv, rid, "sched.admit")
        assert _names(_children(sv, admit)) == ADMIT_CHILDREN
        assert wait["end_ns"] == admit["start_ns"]
    else:
        assert not _request_spans(sv, rid, "sched.admit")
        (begin,) = _request_spans(sv, rid, "sched.admit_begin")
        assert _names(_children(sv, begin)) == ["admit.host"]
        assert wait["end_ns"] == begin["start_ns"]
        stages = _request_spans(sv, rid, "sched.admit_stage")
        # stage 0 the encode, then one a 16-token chunk (45 tokens: 3); the
        # last scatters and samples the first token
        assert [(d["attrs"]["stage"], d["attrs"]["done"]) for d in stages] == [
            (0, False), (1, False), (2, False), (3, True)]
        assert [_names(_children(sv, d)) for d in stages] == [
            ["admit.encode"], ["admit.tower"], ["admit.tower"],
            ["admit.tower", "admit.scatter", "admit.first_token"]]
    sched_tid = {d["tid"] for d in sv["spans"] if d["name"].startswith("sched.")
                 and d["name"] != "sched.queue_wait"}
    assert len(sched_tid) == 1 and req["tid"] not in sched_tid


@pytest.mark.parametrize("rid", [1, 2, 3])
def test_submit_to_first_token_is_tiled_by_the_scheduler_spans(served, rid):
    """From submit to the first token's put: the queue wait, then the
    Scheduler thread's top-level spans, with only the loop's own bookkeeping
    between them; the put lies in a ``sched.stream``."""
    sv = served
    (req,) = _request_spans(sv, rid, "request")
    a, b = req["start_ns"], req["attrs"]["first_token_ns"]
    assert a < b < req["end_ns"]
    (wait,) = _request_spans(sv, rid, "sched.queue_wait")
    tops = [d for d in sv["spans"] if d["parent"] is None and d["name"].startswith("sched.")
            and d["name"] != "sched.queue_wait" and d["end_ns"] > wait["end_ns"]
            and d["start_ns"] < b]
    assert tops[0]["start_ns"] == wait["end_ns"] and tops[-1]["name"] == "sched.stream"
    assert tops[-1]["start_ns"] <= b <= tops[-1]["end_ns"]
    covered = wait["end_ns"] - a + sum(min(d["end_ns"], b) - d["start_ns"] for d in tops)
    gaps = [n["start_ns"] - p["end_ns"] for p, n in zip(tops, tops[1:])]
    assert min(gaps) >= 0 and covered >= 0.9 * (b - a)


def test_queue_wait_and_live_pass_counters(served):
    """Σ ``sched.queue_wait`` is Δ``t_queue_wait``, over as many admissions
    as started; the decode passes less the live ones are the gated replays
    the chunks ran (the gate's own ``go``)."""
    sv = served
    waits = [d for d in sv["spans"] if d["name"] == "sched.queue_wait"]
    s0, s1 = sv["stats0"], sv["stats"]
    assert len(waits) == 3 == (s1["prefills"] + s1["chunked_admissions"]
                               - s0["prefills"] - s0["chunked_admissions"])
    assert sum(d["end_ns"] - d["start_ns"] for d in waits) * 1e-9 == pytest.approx(
        s1["t_queue_wait"] - s0["t_queue_wait"], rel=1e-9)
    assert not {"iterations", "single_steps", "collects", "t_step", "t_collect"} & set(s1)
    counts, gates = sv["eng"].counts, sv["gates"]
    assert counts["decode_passes"] == len(gates)
    assert counts["decode_passes"] - counts["live_decode_passes"] == gates.count(False) >= 1
    assert counts["live_decode_passes"] == sv["eng"].decode_steps
    decodes = [d for d in sv["spans"] if d["name"] == "sched.decode"]
    assert all(_names(_children(sv, d)) == ["decode.launch", "decode.readback"]
               for d in decodes)


def test_contiguous_pool_admission_is_one_replay_and_counts_live_passes(both):
    """The contiguous pool's captured admission shows as one ``admit.replay``
    under ``sched.admit``; its live passes are counted at each snapshot."""
    from visualcla_tpu_torch.engine import server

    _, tm, _, _, _ = both
    tok = tm.tokenizer
    eng = server.ServingEngine(tm.model, tm.config, eos_token_id=-1,
                               pad_token_id=tok.pad_token_id, pool_size=2, max_seq_len=256,
                               max_new_tokens_cap=16, prompt_buckets=(32, 64, 128),
                               sampling=t_samp.SamplingConfig.greedy(16))
    t0 = time.time_ns()
    t_prof.record_spans(True)
    sched = server.Scheduler(eng)
    try:
        out = server.generate_sync(sched, np.arange(4, 13), max_new_tokens=6, timeout=120)
    finally:
        sched.stop()
        t_prof.record_spans(False)
    spans = t_prof.take_spans(t0)
    (admit,) = [d for d in spans if d["name"] == "sched.admit"]
    assert [d["name"] for d in spans if d["parent"] == admit["id"]] == ["admit.replay"]
    assert len(out) == 6 and eng.counts["live_decode_passes"] == eng.decode_steps == 5
