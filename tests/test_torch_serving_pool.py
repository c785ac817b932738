"""The port's contiguous serving pool (``engine.server.ServingEngine``) against
the JAX package's, on the CPU in fp32 on the tiny native checkpoint; mirrors
``tests/test_serving.py``.  On CPU tensors the pool runs the same gated step
and admission functions that the card replays from captured CUDA graphs.

Tolerances: greedy ids token for token; the pool's K/V cache (the text
tower's states) within 1e-4 of the JAX pool's (fp32, another summation
order); a row's decode logits within 1e-4 of the JAX forward's."""
import base64
import dataclasses
import io
import json
import queue
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu.engine import server as j_server
from visualcla_tpu.models import llama as j_llama
from visualcla_tpu.text.prompt import all_img_marker_positions
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.engine import server as t_server
from visualcla_tpu_torch.text import encoding_text

POOL_KW = dict(pool_size=3, max_seq_len=96, max_new_tokens_cap=16, prompt_buckets=(32,))
TOL = 1e-4


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ckpt, _ = make_native_ckpt(str(tmp_path_factory.mktemp("pool")))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    return jm, tm, ckpt


def pools(both, max_new=16, **kw):
    """The JAX and the port's pools, greedy engine-wide (no penalty, top-k 0)."""
    jm, tm, _ = both
    tok = tm.tokenizer
    common = dict(POOL_KW, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
    common.update(kw)
    je = j_server.ServingEngine(jm.params, jm.config, dtype=jnp.float32,
                                sampling=j_samp.SamplingConfig.greedy(max_new), **common)
    te = t_server.ServingEngine(tm.model, tm.config,
                                sampling=t_samp.SamplingConfig.greedy(max_new), **common)
    return je, te


def prompts(tm, n=3, seed=7):
    rng = np.random.default_rng(seed)
    hi = tm.tokenizer.pad_token_id  # the sentencepiece ids lie below the added tokens
    return [rng.integers(3, hi, int(rng.integers(6, 20))) for _ in range(n)]


def trim(x, eos):
    x = [int(t) for t in np.asarray(x)]
    return x[:x.index(eos) + 1] if eos in x else x


def snapshots_equal(je, te):
    want, got = je.snapshot(), te.snapshot()
    for key in ("last_token", "gen_len", "active", "finished", "gen_ids"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    return got


def caches_close(je, te, rows):
    """The pool's K/V (L, B, Nkv, S, hd) against the JAX pool's, on the valid
    slots of ``rows``."""
    valid = np.asarray(je._state.kv_valid)
    np.testing.assert_array_equal(te._state.kv_valid.numpy(), valid)
    for name in ("k", "v"):
        want = np.asarray(je._state.cache[name])
        got = te._state.cache[name].numpy()
        for r in rows:
            m = valid[r]
            np.testing.assert_allclose(got[:, r][:, :, m], want[:, r][:, :, m], atol=TOL,
                                       rtol=TOL)


def run_jax_scheduler(je, reqs, max_new):
    sched = j_server.Scheduler(je)
    try:
        return [list(j_server.generate_sync(sched, p, v, i, max_new_tokens=max_new,
                                            timeout=300)) for p, v, i in reqs]
    finally:
        sched.stop()


def test_pool_matches_single_stream(both):
    """Requests through the Scheduler on the port's pool equal the port's
    single-stream ``Engine.generate`` (trimmed at EOS) and the JAX pool under
    the JAX Scheduler, token for token."""
    _, tm, _ = both
    je, te = pools(both)
    eos = tm.tokenizer.eos_token_id
    reqs = [(p, None, None) for p in prompts(tm)]
    singles = [tm.engine.generate(p[None], None, None, t_samp.SamplingConfig.greedy(10))[0]
               for p, _, _ in reqs]
    sched = t_server.Scheduler(te)
    got = [None] * len(reqs)
    try:
        def run(k):
            got[k] = list(t_server.generate_sync(sched, reqs[k][0], max_new_tokens=10,
                                                 timeout=300))
        threads = [threading.Thread(target=run, args=(k,)) for k in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sched.stop()
    assert [trim(g, eos) for g in got] == [trim(s, eos) for s in singles]
    assert got == run_jax_scheduler(je, reqs, 10)
    assert te.num_active() == 0 and te.counts["prefill_passes"] == 3


def test_batched_uneven_prompts_match_single_rows(both):
    """Uneven prompts admitted together decode like their single-row runs and
    like the JAX pool's rows; the cache's valid slots agree within 1e-4."""
    _, tm, _ = both
    je, te = pools(both)
    ps = prompts(tm, 3, seed=3)
    for row, p in enumerate(ps):
        je.prefill_row(row, p, None, None, 12)
        te.prefill_row(row, p, None, None, 12)
    caches_close(je, te, range(3))
    for _ in range(16):
        if snapshots_equal(je, te)["finished"].all():
            break
        je.step_n(4)
        te.step_n(4)
    snap = snapshots_equal(je, te)
    caches_close(je, te, range(3))
    eos = tm.tokenizer.eos_token_id
    for row, p in enumerate(ps):
        solo = tm.engine.generate(p[None], None, None, t_samp.SamplingConfig.greedy(12))[0]
        assert trim(snap["gen_ids"][row][:snap["gen_len"][row]], eos)[:12] == trim(solo, eos)


def test_decode_logits_match_jax_forward(both):
    """One row's decode logits through the pool's forward (B1's plain version
    over the stacked cache, at per-row write slots) against the JAX forward
    on the JAX pool's state."""
    jm, tm, _ = both
    je, te = pools(both)
    ps = prompts(tm, 2, seed=5)
    for row, p in enumerate(ps):
        je.prefill_row(row, p, None, None, 8)
        te.prefill_row(row, p, None, None, 8)
    s = te._state
    text = tm.model.text
    with torch.no_grad():
        valid = s.kv_valid.clone()
        valid[te._rows, s.cur_slot] = s.active
        cache = {k: v.clone() for k, v in s.cache.items()}
        hidden, _ = text(text.embed(s.last_token[:, None]), s.positions[:, None], cache, valid,
                         s.cur_slot)
        got = text.logits(hidden)[:, 0].numpy()
    js = je._state
    jvalid = js.kv_valid.at[jnp.arange(3), js.cur_slot].max(js.active)
    jh, _ = j_llama.forward(jm.params["text"], jm.config.text_config,
                            j_llama.embed(jm.params["text"], js.last_token[:, None]),
                            js.positions[:, None], js.cache, jvalid, js.cur_slot)
    want = np.asarray(j_llama.logits(jm.params["text"], jh))[:, 0]
    np.testing.assert_allclose(got[:2], want[:2], atol=TOL, rtol=TOL)


def test_step_n_matches_single_steps(both):
    """``step_n(4)`` chunks give the tokens of single steps (a chunk stops
    where a row finishes), and each equals the JAX pool's."""
    _, tm, _ = both
    ps = prompts(tm, 2)

    def run(eng, chunk):
        for r, p in enumerate(ps):
            eng.prefill_row(r, p, None, None, 12)
        for _ in range(12):
            eng.step_n(4) if chunk else eng.step()
        snap = eng.snapshot()
        return [list(snap["gen_ids"][r][:snap["gen_len"][r]]) for r in range(2)]

    kw = dict(pool_size=2, max_new_tokens_cap=12, prompt_buckets=(128, 256, 512, 1024))
    je, te = pools(both, max_new=12, **kw)
    single = run(te, False)
    assert run(pools(both, max_new=12, **kw)[1], True) == single
    assert run(je, True) == single


def test_chunks_stop_where_jax_stops(both):
    """Rows of different limits finish inside chunks of 4: after every chunk
    the snapshot equals the JAX pool's; a retired row's successor (with an
    image) joins mid-way."""
    _, tm, _ = both
    je, te = pools(both, max_seq_len=256, prompt_buckets=(32, 64, 128))
    s = tm.config.vision_config.image_size
    pix = np.random.default_rng(1).standard_normal((1, 3, s, s)).astype(np.float32)
    chat = encoding_text([], "ab你好", tm.num_patch, tm.tokenizer)["input_ids"][0]
    img = int(np.flatnonzero(chat == tm.tokenizer.img_start_token_id)[0])
    for row, (p, n) in enumerate(zip(prompts(tm, 3, seed=9), (5, 11, 16))):
        je.prefill_row(row, p, None, None, n)
        te.prefill_row(row, p, None, None, n)
    admitted = False
    for _ in range(40):
        snap = snapshots_equal(je, te)
        if snap["finished"].all():
            break
        if snap["finished"][0] and not admitted:
            for eng in (je, te):
                eng.release_rows([0])
                eng.prefill_row(0, chat, pix, img, 7)
            admitted = True
            continue
        je.step_n(4)
        te.step_n(4)
    assert admitted and te.snapshot()["finished"].all()
    caches_close(je, te, range(3))
    assert 0 < te.decode_steps <= te.counts["decode_passes"]


def test_release_rows_batched_matches_sequential(both):
    """The batched release clears exactly the released rows' flags and
    validity and leaves the others untouched."""
    _, tm, _ = both

    def released(batched):
        _, te = pools(both)
        for r, p in enumerate(prompts(tm)):
            te.prefill_row(r, p, None, None, 4)
        te._state.finished.fill_(True)
        if batched:
            te.release_rows([0, 2])
        else:
            te.release_row(0)
            te.release_row(2)
        s = te._state
        return {k: getattr(s, k).clone() for k in ("active", "finished", "kv_valid")}

    a, b = released(True), released(False)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert a["active"].tolist() == [False, True, False]
    assert bool(a["kv_valid"][1].any()) and not bool(a["kv_valid"][0].any())


def test_per_request_top_k_ngram_and_greedy_overrides(both):
    """Rows carry their own knobs: a greedy row beside a hot sampled one
    equals the single-stream greedy run; an n-gram override equals the
    static n-gram processor; top-k 1 sampling equals greedy; the same
    overrides give the JAX pool's ids."""
    _, tm, _ = both
    eos = tm.tokenizer.eos_token_id
    ps = prompts(tm)
    greedy = t_samp.SamplingConfig.greedy(8)
    want_greedy = tm.engine.generate(ps[1][None], None, None, greedy)[0]
    want_ngram = tm.engine.generate(
        ps[0][None], None, None, dataclasses.replace(greedy, no_repeat_ngram_size=2))[0]
    overrides = [{"do_sample": False, "no_repeat_ngram_size": 2},
                 {"do_sample": True, "top_k": 1, "temperature": 1.0, "top_p": 1.0,
                  "repetition_penalty": 1.0},
                 {"do_sample": True, "temperature": 1.5, "top_p": 1.0}]
    je, te = pools(both)
    got = {}
    for name, eng, server in (("jax", je, j_server), ("port", te, t_server)):
        sched = server.Scheduler(eng)
        try:
            qs = []
            for p, ov in zip(ps, overrides):
                q = queue.Queue()
                sched.submit(server.Request(input_ids=p, pixel_values=None, img_start_pos=None,
                                            max_new_tokens=8, out=q, sampling_overrides=ov))
                qs.append(q)
            outs = []
            for q in qs:
                while True:
                    kind, payload = q.get(timeout=300)
                    assert kind != "error", payload
                    if kind == "done":
                        outs.append([int(t) for t in payload])
                        break
            got[name] = outs
        finally:
            sched.stop()
    ngram, topk, hot = got["port"]
    assert trim(ngram, eos) == trim(want_ngram, eos)
    assert trim(topk, eos) == trim(want_greedy, eos)
    assert 1 <= len(hot) <= 8
    assert got["port"][:2] == got["jax"][:2]


def test_scheduler_streams_every_token_including_first(both):
    _, tm, _ = both
    _, te = pools(both)
    sched = t_server.Scheduler(te, poll_interval=0.001)
    try:
        q: queue.Queue = queue.Queue()
        sched.submit(t_server.Request(input_ids=prompts(tm, 1)[0], pixel_values=None,
                                      img_start_pos=None, max_new_tokens=8, out=q))
        streamed, done = [], None
        while done is None:
            kind, payload = q.get(timeout=120)
            if kind == "token":
                streamed.append(int(payload))
            elif kind == "done":
                done = [int(t) for t in payload]
            else:
                raise AssertionError(payload)
        assert streamed == done and 1 <= len(done) <= 8
    finally:
        sched.stop()


def test_scheduler_isolates_bad_requests(both):
    """An overlong prompt errors its own request; the pool keeps serving."""
    _, tm, _ = both
    _, te = pools(both)
    sched = t_server.Scheduler(te)
    try:
        with pytest.raises(RuntimeError, match="exceeds"):
            t_server.generate_sync(sched, np.full(200, 5), max_new_tokens=4, timeout=120)
        out = t_server.generate_sync(sched, prompts(tm, 1)[0], max_new_tokens=4, timeout=300)
        assert 1 <= len(out) <= 4
    finally:
        sched.stop()


def test_overflow_bucket_path(both):
    """A prompt past the largest bucket but inside the cache pads to a
    32-quantized length (< Smax), as the JAX pool's does; one past Smax - 1
    is refused."""
    _, tm, _ = both
    je, te = pools(both)
    p = np.random.default_rng(4).integers(3, tm.tokenizer.pad_token_id, 40)
    assert te.bucket_len(40) == je.bucket_len(40) == 64
    assert te.bucket_len(95) == je.bucket_len(95) == 95
    with pytest.raises(ValueError):
        te.bucket_len(96)
    for eng in (je, te):
        eng.prefill_row(1, p, None, None, 10)
        for _ in range(4):
            eng.step_n(4)
    snap = snapshots_equal(je, te)
    assert snap["gen_len"][1] >= 2
    caches_close(je, te, [1])


def test_multi_image_admission_matches_engine(both):
    """A two-image prompt admitted into the pool (K markers, (1, K, 3, H, W)
    pixels) equals ``Engine.generate`` on the same prompt and the JAX pool."""
    jm, tm, _ = both
    tok = tm.tokenizer
    cfg = tm.config
    s = cfg.vision_config.image_size
    rng = np.random.default_rng(6)
    pix = rng.standard_normal((1, 2, 3, s, s)).astype(np.float32)
    T = cfg.num_image_tokens
    marker = [tok.img_start_token_id] + [tok.img_token_id] * T + [tok.img_end_token_id]
    ids = np.array([3] + marker + [4, 5] + marker + [6], np.int64)[None]
    pos = all_img_marker_positions(ids, tok.img_start_token_id)
    want = tm.engine.generate(ids, pix, pos, t_samp.SamplingConfig.greedy(6))[0]
    je, te = pools(both, max_seq_len=256, prompt_buckets=(160,))
    for eng in (je, te):
        eng.prefill_row(0, ids[0], pix[0], [int(p) for p in pos[0]], 6)
        for _ in range(8):
            eng.step()
    snap = snapshots_equal(je, te)
    got = snap["gen_ids"][0][:snap["gen_len"][0]]
    np.testing.assert_array_equal(got[:len(want)], want)


def _two_image_prompt(tm, n_text, seed):
    """A prompt of ``n_text`` text tokens around two image markers: (ids,
    markers, (K, 3, H, W) pixels)."""
    tok, cfg = tm.tokenizer, tm.config
    rng = np.random.default_rng(seed)
    marker = [tok.img_start_token_id] + [tok.img_token_id] * cfg.num_image_tokens + [
        tok.img_end_token_id]
    text = rng.integers(3, tok.pad_token_id, n_text).tolist()
    a, b = n_text // 3, 2 * n_text // 3
    ids = np.array(text[:a] + marker + text[a:b] + marker + text[b:], np.int64)
    pos = [int(p) for p in all_img_marker_positions(ids[None], tok.img_start_token_id)[0]]
    s = cfg.vision_config.image_size
    return ids, pos, rng.standard_normal((2, 3, s, s)).astype(np.float32)


def test_paged_admissions_match_jax(both):
    """The paged pool's one admission path (a one-shot admission is one
    chunk as wide as the bucket; on the card each stage a graph replay)
    against the JAX paged pool, in fp32, equal snapshots after every call:
    uneven prompts in one 160-slot bucket, text-only and with two images;
    chunked admissions whose 48-token chunks stop short of the bucket's end
    (slots 144-159 never written), a one-shot admission while a chunked one
    is part way, a sampled (top-k 1) row, a re-admitted row; ``abort()``
    part way returns every block."""
    from visualcla_tpu.engine.paged import PagedServingEngine as JPaged
    from visualcla_tpu_torch.engine.paged import PagedServingEngine as TPaged

    jm, tm, _ = both
    tok = tm.tokenizer
    kw = dict(eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, pool_size=3,
              block_size=16, num_blocks=40, max_seq_len=256, max_new_tokens_cap=12,
              prompt_buckets=(160,))
    je = JPaged(jm.params, jm.config, dtype=jnp.float32,
                sampling=j_samp.SamplingConfig.greedy(12), **kw)
    te = TPaged(tm.model, tm.config, sampling=t_samp.SamplingConfig.greedy(12), **kw)
    rng = np.random.default_rng(13)
    text_a = rng.integers(3, tok.pad_token_id, 140)
    text_c = rng.integers(3, tok.pad_token_id, 100)
    ids_b, pos_b, pix_b = _two_image_prompt(tm, 40, 1)
    ids_d, pos_d, pix_d = _two_image_prompt(tm, 110, 2)
    sampled = {"do_sample": True, "top_k": 1, "temperature": 0.7, "repetition_penalty": 1.2}
    free0 = sorted(te._free)

    def chunked(eng, row, prompt, one_shot=None):
        """A chunked admission (encode, 3 chunks: the JAX pool finishes in a
        stage of its own, the port with the last chunk), a decode step after
        each of the first three stages, ``one_shot`` after the first chunk."""
        pending = eng.begin_prefill(row, *prompt, 10, chunk=48)
        stage = 0
        while not pending.step():
            if stage == 1 and one_shot is not None:
                one_shot(eng)
            if stage <= 2:
                eng.step()
            stage += 1

    def run(eng):
        chunked(eng, 0, (text_a, None, None),
                lambda e: e.prefill_row(1, ids_b, pix_b, pos_b, 10))
        eng.step_n(3)
        yield "a"
        eng.prefill_row(2, text_c, None, None, 10, overrides=sampled)
        eng.step_n(3)
        yield "c"
        eng.release_rows([0])
        yield sorted(eng._free)
        pending = eng.begin_prefill(0, ids_d, pix_d, pos_d, 10, chunk=48)
        pending.step()
        pending.step()
        pending.abort()
        yield sorted(eng._free)
        chunked(eng, 0, (ids_d, pix_d, pos_d))
        for _ in range(6):
            eng.step_n(3)
            yield "d"

    for got, want in zip(run(te), run(je)):
        assert got == want
        live = ~snapshots_equal(je, te)["finished"]  # (the JAX host mirror runs on past an end)
        np.testing.assert_array_equal(te.ctx_len[live], np.asarray(je.ctx_len)[live])
    # stages: A and D 6 each (encode, 3 chunks, scatter, first token), B and
    # C 4 each, the aborted admission 2; tower passes 3 + 1 + 1 + 1 + 3
    assert te.counts["admit_stages"] == 6 + 6 + 4 + 4 + 2
    assert te.counts["prefill_passes"] == 9 and te.counts["admit_replays"] == 0
    te.release_rows(range(3))
    assert sorted(te._free) == free0 and te.num_active() == 0


def test_kv_int8_needs_the_paged_pool(both):
    from visualcla_tpu_torch.apps.serve import PoolWorker

    _, tm, _ = both
    with pytest.raises(ValueError, match="--paged"):
        PoolWorker(tm, pool_size=2, kv_quant="int8")


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _serve(worker, make_handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _post(server, path, body):
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        raw = r.read().decode()
    return json.loads(raw) if path == "/chat" else [json.loads(x) for x in raw.splitlines()]


def test_http_contiguous_pool_matches_jax(both):
    """``PoolWorker(paged=False)``, the default, over HTTP: /chat and
    /chat_stream equal the JAX contiguous pool's replies."""
    from PIL import Image

    from visualcla_tpu.apps import serve as j_serve
    from visualcla_tpu_torch.apps import serve as t_serve

    jm, tm, _ = both
    s = tm.config.vision_config.image_size
    img = np.random.default_rng(3).integers(0, 256, (s + 5, s + 9, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    png = base64.b64encode(buf.getvalue()).decode()
    gc = {"do_sample": False, "max_new_tokens": 8}
    jw = j_serve.PoolWorker(jm, pool_size=2)
    tw = t_serve.PoolWorker(tm, pool_size=2)
    assert isinstance(tw.engine, t_server.ServingEngine)
    js, ts = _serve(jw, j_serve.make_handler), _serve(tw, t_serve.make_handler)
    try:
        for body in ({"text": "ab你好", "image_b64": png, "generation_config": gc},
                     {"text": "cd", "generation_config": gc}):
            want = _post(js, "/chat", body)
            assert _post(ts, "/chat", body) == want
            stream = _post(ts, "/chat_stream", body)
            assert stream[-1] == want
            assert all("partial" in x for x in stream[:-1])
    finally:
        for server in (js, ts):
            server.shutdown()
            server.server_close()
        jw.scheduler.stop()
        tw.close()
