"""Paged serving in the PyTorch port against the JAX package, on the CPU:
the row-wise and remaining samplers, the plain version of kernel B4, the
paged engine under the scheduler, and the HTTP pool.

Tolerances: sampler masks exact, values 1e-6 (the same fp32 ops); B4's plain
version within 1e-5 of the Pallas kernel run in interpret mode (fp32, another
summation order; the int8 pool rounds to bf16 at the same points in both),
pools bitwise; engines token for token in fp32.  Draws come from different
generators, so they are compared by distribution."""
import ast
import base64
import inspect
import io
import json
import textwrap
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu.engine.paged import PagedServingEngine as JPaged
from visualcla_tpu.ops.pallas.paged_attention import paged_append_attention as j_b4
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.engine import pool as t_pool
from visualcla_tpu_torch.engine import server as t_server
from visualcla_tpu_torch.engine.paged import PagedServingEngine as TPaged
from visualcla_tpu_torch.fixtures import paged_case
from visualcla_tpu_torch.ops.cuda import paged_attention as pa
from visualcla_tpu_torch.parallel import serving as t_serving
from visualcla_tpu_torch.text import encoding_text

V = 97


def logits_batch(seed, B=6, V=V, ties=True):
    x = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3
    if ties:
        x[0, :8] = x[0, 0]  # a tied top set
        x[1, 5:] = -40.0  # a heavy tail of zero-probability tokens
    return x


def same(got: torch.Tensor, want, atol=1e-6):
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(got == t_samp.NEG_INF, want == j_samp.NEG_INF)
    live = want != j_samp.NEG_INF
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=atol)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def test_static_tfs_and_top_a_match_jax():
    x = logits_batch(0)
    for tfs in (0.5, 0.9, 0.99, 1.0):
        same(t_samp.warp_tfs(torch.from_numpy(x), tfs), j_samp.warp_tfs(jnp.asarray(x), tfs))
    for a in (0.0, 0.1, 0.5):
        same(t_samp.warp_top_a(torch.from_numpy(x), a), j_samp.warp_top_a(jnp.asarray(x), a))


def test_rowwise_warpers_match_jax():
    x = logits_batch(1)
    B = x.shape[0]
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    temp = np.array([1.0, 0.5, 0.7, 2.0, 1e-8, 1.3], np.float32)
    p = np.array([1.0, 0.9, 0.5, 0.95, 0.1, 0.999], np.float32)
    tfs = np.array([1.0, 0.9, 0.5, 0.95, 0.99, 1.0], np.float32)
    top_a = np.array([0.0, 0.1, 0.5, 0.2, 0.0, 0.9], np.float32)
    k = np.array([0, 1, 5, 40, 8, 0], np.int32)
    pen = np.array([1.0, 1.1, 1.5, 0.8, 1.0, 2.0], np.float32)
    t = {n: torch.from_numpy(a) for n, a in (("temp", temp), ("p", p), ("tfs", tfs),
                                              ("a", top_a), ("k", k), ("pen", pen))}
    same(t_samp.warp_temperature_rowwise(tx, t["temp"]),
         j_samp.warp_temperature_rowwise(jx, jnp.asarray(temp)))
    same(t_samp.warp_top_p_rowwise(tx, t["p"]), j_samp.warp_top_p_rowwise(jx, jnp.asarray(p)))
    same(t_samp.warp_tfs_rowwise(tx, t["tfs"]), j_samp.warp_tfs_rowwise(jx, jnp.asarray(tfs)))
    same(t_samp.warp_top_a_rowwise(tx, t["a"]),
         j_samp.warp_top_a_rowwise(jx, jnp.asarray(top_a)))
    same(t_samp.warp_top_k_rowwise(tx, t["k"]), j_samp.warp_top_k_rowwise(jx, jnp.asarray(k)))
    # a k past the cap takes the full-sort branch in both
    big = np.array([0, 60, 5, 90, 8, 1], np.int32)
    same(t_samp.warp_top_k_rowwise(tx, torch.from_numpy(big), k_cap=50),
         j_samp.warp_top_k_rowwise(jx, jnp.asarray(big), k_cap=50))
    gen = np.random.default_rng(2).integers(0, V, (B, 12))
    gen_len = np.array([0, 3, 12, 7, 1, 5])
    valid = np.arange(12)[None] < gen_len[:, None]
    same(t_samp.apply_repetition_penalty_rowwise(tx, torch.from_numpy(gen),
                                                 torch.from_numpy(valid), t["pen"]),
         j_samp.apply_repetition_penalty_rowwise(jx, jnp.asarray(gen), jnp.asarray(valid),
                                                 jnp.asarray(pen)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rowwise_ngram_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, T = 8, 16
    gen = rng.integers(0, 4, (B, T))  # a small alphabet: many repeated n-grams
    gen_len = rng.integers(0, T + 1, B)
    n = np.array([0, 1, 2, 3, 4, 15, 2, 3])
    x = logits_batch(seed + 10, B=B, V=8, ties=False)
    got = t_samp.apply_no_repeat_ngram_rowwise(torch.from_numpy(x), torch.from_numpy(gen),
                                               torch.from_numpy(gen_len), torch.from_numpy(n))
    want = j_samp.apply_no_repeat_ngram_rowwise(jnp.asarray(x), jnp.asarray(gen),
                                                jnp.asarray(gen_len), jnp.asarray(n))
    same(got, want)
    assert bool((got == t_samp.NEG_INF).any())


def _knobs(B, rng, greedy=False):
    return dict(
        temperature=rng.uniform(0.3, 1.5, B).astype(np.float32),
        top_p=rng.choice([1.0, 0.9, 0.5], B).astype(np.float32),
        repetition_penalty=rng.choice([1.0, 1.1, 1.3], B).astype(np.float32),
        do_sample=np.zeros(B, bool) if greedy else rng.random(B) < 0.5,
        tfs=rng.choice([1.0, 0.9], B).astype(np.float32),
        top_a=rng.choice([0.0, 0.2], B).astype(np.float32),
        mirostat=rng.random(B) < 0.3,
        miro_tau=np.full(B, 5.0, np.float32), miro_eta=np.full(B, 0.1, np.float32),
        top_k=rng.choice([0, 5, 40], B).astype(np.int32),
        ngram=rng.choice([0, 2, 3], B).astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_step_rowwise_greedy_matches_jax(seed):
    """Greedy rows: the argmax of the processed logits, as the JAX sampler."""
    rng = np.random.default_rng(seed)
    B, T = 8, 10
    x = logits_batch(seed + 20, B=B, ties=False)
    gen = rng.integers(0, V, (B, T))
    gen_len = rng.integers(0, T, B)
    kn = _knobs(B, rng, greedy=True)
    cfg = t_samp.SamplingConfig()
    tok, mu = t_samp.sample_step_rowwise(
        torch.from_numpy(x), torch.from_numpy(gen), torch.from_numpy(gen_len),
        torch.Generator().manual_seed(0), cfg, **{k: torch.from_numpy(v) for k, v in kn.items()})
    jtok, jmu = j_samp.sample_step_rowwise(
        jnp.asarray(x), jnp.asarray(gen), jnp.asarray(gen_len), jax.random.PRNGKey(0),
        j_samp.SamplingConfig(), **{k: jnp.asarray(v) for k, v in kn.items()})
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu))
    # host flags that skip every unused branch give the same tokens
    flags = t_samp.rowwise_flags(**kn)
    assert not flags["sample"]
    tok2, _ = t_samp.sample_step_rowwise(
        torch.from_numpy(x), torch.from_numpy(gen), torch.from_numpy(gen_len),
        torch.Generator().manual_seed(0), cfg, flags=flags,
        **{k: torch.from_numpy(v) for k, v in kn.items()})
    assert torch.equal(tok, tok2)


def test_mirostat_truncation_and_mu_match_jax():
    """For the token JAX picked: the same kept set and the same mu update."""
    x = logits_batch(3, B=16)
    mu = np.linspace(1.0, 9.0, 16).astype(np.float32)
    tau, eta = np.float32(5.0), np.float32(0.1)
    for key in range(3):
        jtok, jmu = j_samp.mirostat_step(jnp.asarray(x), jnp.asarray(mu),
                                         jax.random.PRNGKey(key), tau, eta)
        order, trunc = t_samp.mirostat_truncate(torch.from_numpy(x), torch.from_numpy(mu))
        # the JAX kept set, from its own ops
        jorder = jnp.argsort(-jnp.asarray(x), axis=-1)
        jsorted = jnp.take_along_axis(jnp.asarray(x), jorder, axis=-1)
        jprobs = jax.nn.softmax(jsorted, axis=-1)
        jkeep = (-jnp.log2(jnp.maximum(jprobs, 1e-30)) <= jnp.asarray(mu)[:, None])
        jkeep = np.asarray(jkeep.at[:, 0].set(True))
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(trunc.numpy() != t_samp.NEG_INF, jkeep)
        pick = (order == torch.from_numpy(np.asarray(jtok, np.int64))[:, None]).int().argmax(-1)
        got = t_samp.mirostat_mu(trunc, pick, torch.from_numpy(mu), float(tau), float(eta))
        np.testing.assert_allclose(got.numpy(), np.asarray(jmu), atol=1e-5, rtol=1e-6)


def _frequencies(tokens: torch.Tensor, V: int) -> np.ndarray:
    return np.bincount(tokens.numpy(), minlength=V) / tokens.numel()


def _close_in_distribution(freq, probs, n):
    sd = np.sqrt(probs * (1 - probs) / n)
    assert np.all(np.abs(freq - probs) <= 6 * sd + 2e-3), (freq, probs)
    assert np.all(freq[probs == 0] == 0)


def test_sampled_draws_follow_the_jax_distribution():
    """One logits row repeated n times: the port's draws against the softmax
    of the JAX warpers' output (temperature, top-k, top-p, tfs, top-a)."""
    n, Vs = 20000, 12
    row = np.random.default_rng(4).standard_normal(Vs).astype(np.float32) * 2
    x = np.tile(row, (n, 1))
    kn = dict(temperature=0.8, top_p=0.9, tfs=0.95, top_a=0.05, top_k=6)
    tkn = {k: torch.full((n,), v) for k, v in kn.items()}
    tkn["top_k"] = tkn["top_k"].long()
    tok, _ = t_samp.sample_step_rowwise(
        torch.from_numpy(x), torch.zeros(n, 4, dtype=torch.int64), torch.zeros(n, dtype=torch.int64),
        torch.Generator().manual_seed(1), t_samp.SamplingConfig(),
        repetition_penalty=torch.ones(n), do_sample=torch.ones(n, dtype=torch.bool),
        ngram=torch.zeros(n, dtype=torch.int64), **tkn)
    w = jnp.asarray(row[None]) / kn["temperature"]
    w = j_samp.warp_top_k_rowwise(w, jnp.asarray([kn["top_k"]]))
    w = j_samp.warp_top_p_rowwise(w, jnp.asarray([kn["top_p"]], jnp.float32))
    w = j_samp.warp_tfs_rowwise(w, jnp.asarray([kn["tfs"]], jnp.float32))
    w = j_samp.warp_top_a_rowwise(w, jnp.asarray([kn["top_a"]], jnp.float32))
    probs = np.asarray(jax.nn.softmax(w, axis=-1))[0]
    _close_in_distribution(_frequencies(tok, Vs), probs, n)


def test_mirostat_draws_follow_the_truncated_distribution():
    n, Vs = 20000, 10
    row = np.random.default_rng(5).standard_normal(Vs).astype(np.float32) * 2
    x = torch.from_numpy(np.tile(row, (n, 1)))
    mu = torch.full((n,), 3.0)
    tok, _ = t_samp.mirostat_step(x, mu, torch.Generator().manual_seed(2), 5.0, 0.1)
    order, trunc = t_samp.mirostat_truncate(x[:1], mu[:1])
    probs = np.zeros(Vs)
    probs[order[0].numpy()] = torch.softmax(trunc[0], -1).numpy()
    _close_in_distribution(_frequencies(tok, Vs), probs, n)


@pytest.mark.parametrize("kw", [dict(tfs=0.9), dict(top_a=0.3), dict(tfs=0.8, top_a=0.1),
                                dict(top_k=0, top_p=1.0, tfs=0.9)],
                         ids=["tfs", "top_a", "both", "tfs_alone"])
def test_engine_wide_warped_logits_match_jax(kw):
    x = logits_batch(6)
    B, T = x.shape[0], 8
    gen = np.random.default_rng(7).integers(0, V, (B, T))
    gen_len = np.full(B, 5)
    got = t_samp.warped_logits(torch.from_numpy(x), torch.from_numpy(gen),
                               torch.from_numpy(gen_len), t_samp.SamplingConfig(**kw))
    want = j_samp.warped_logits(jnp.asarray(x), jnp.asarray(gen), jnp.asarray(gen_len),
                                j_samp.SamplingConfig(**kw))
    same(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# B4's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32_pool", "int8_pool"])
@pytest.mark.parametrize("N,Nkv", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("BS", [8, 16])
def test_b4_plain_matches_pallas_interpret(kv_int8, N, Nkv, BS):
    # a parked row, offsets 0 and BS-1, an empty context, a few blocks
    ctx = [2 * BS, -1, 3 * BS - 1, 0, 4 * BS + 3]
    case = paged_case(ctx, N, Nkv, hd=32, block_size=BS, L=3, layer=2,
                      dtype=torch.float32, kv_int8=kv_int8, seed=BS * 7 + N + Nkv)
    j = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
         for k, v in case.items()}
    jo, jkp, jvp, jks, jvs = j_b4(
        j["q"], j["k_new"], j["v_new"], j["k_pool"], j["v_pool"], j["tables"], j["lens"],
        j["blk"], j["off"], jnp.int32(case["layer"]), j.get("k_new_scales"),
        j.get("v_new_scales"), j.get("k_scales"), j.get("v_scales"), interpret=True)
    pa.reset_launch_counts()
    out = pa.paged_append_attention(**case)  # CPU tensors: the plain version
    assert not any(pa.LAUNCHES.values())
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for name, want in (("k_pool", jkp), ("v_pool", jvp), ("k_scales", jks), ("v_scales", jvs)):
        if want is not None:
            np.testing.assert_array_equal(case[name].numpy(), np.asarray(want), err_msg=name)


def test_b4_rejects_mismatched_inputs():
    case = paged_case([3, 9], 4, 2, hd=16, block_size=8)
    with pytest.raises(TypeError):
        pa.paged_append_attention(**{**case, "k_new": case["k_new"].double()})
    with pytest.raises(ValueError, match="multiple"):
        pa.paged_append_attention(**{**case, "q": torch.zeros(2, 3, 16)})
    with pytest.raises(ValueError, match="layer"):
        pa.paged_append_attention(**{**case, "layer": 5})
    kv8 = paged_case([3, 9], 4, 2, hd=16, block_size=8, kv_int8=True)
    with pytest.raises(TypeError, match="scale"):
        pa.paged_append_attention(**{**kv8, "k_scales": None})


# ---------------------------------------------------------------------------
# the paged engine under the scheduler
# ---------------------------------------------------------------------------

TIERS = {"fp32": {}, "kv8": {"kv_quant": "int8"}, "int4": {"load_in_4bit": True}}
ENGINE_KW = dict(pool_size=3, block_size=16, num_blocks=40, max_seq_len=256,
                 max_new_tokens_cap=12, prompt_buckets=(32, 64, 128, 256))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_native_ckpt(str(tmp_path_factory.mktemp("serving")))


@pytest.fixture(scope="module")
def models(ckpt):
    path, _ = ckpt
    out = {}
    for name in ("fp32", "int4"):
        kw = {"load_in_4bit": True} if name == "int4" else {}
        jm, _, _ = vj.get_model_and_tokenizer_and_processor(
            visualcla_model=path, dtype=jnp.float32, max_seq_len=256, **kw)
        tm, _, _ = vt.get_model_and_tokenizer_and_processor(
            visualcla_model=path, dtype=torch.float32, device="cpu", max_seq_len=256, **kw)
        out[name] = (jm, tm)
    return out


def engines(models, tier, **kw):
    jm, tm = models["int4" if tier == "int4" else "fp32"]
    kv = TIERS[tier].get("kv_quant", "none")
    tok = tm.tokenizer
    common = dict(ENGINE_KW, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                  kv_quant=kv, **kw)
    je = JPaged(jm.params, jm.config, dtype=jnp.float32,
                sampling=j_samp.SamplingConfig.greedy(12), **common)
    te = TPaged(tm.model, tm.config, sampling=t_samp.SamplingConfig.greedy(12), **common)
    return je, te


def requests(tm, pixel_seed=1):
    """Three prompts: two of random ids (one short, one over the chunk
    size), and the chat prompt with an image."""
    rng = np.random.default_rng(11)
    s = tm.config.vision_config.image_size
    pix = np.random.default_rng(pixel_seed).standard_normal((1, 3, s, s)).astype(np.float32)
    chat = encoding_text([], "ab你好", tm.num_patch, tm.tokenizer)["input_ids"][0]
    img = int(np.flatnonzero(chat == tm.tokenizer.img_start_token_id)[0])
    return [(rng.integers(4, 20, 9), None, None),
            (rng.integers(4, 20, 45), None, None),
            (chat, pix, img)]


def drive(eng, reqs, max_new=10, chunk=16):
    """A fixed schedule through the engine's own API: row 0 one-shot, row 1
    chunked with decode steps between its chunks, row 2 one-shot later."""
    (p0, v0, i0), (p1, v1, i1), (p2, v2, i2) = reqs
    eng.prefill_row(0, p0, v0, i0, max_new)
    pending = eng.begin_prefill(1, p1, v1, i1, max_new, chunk=chunk)
    while not pending.step():
        eng.step()
        eng.snapshot()
    eng.step()
    eng.prefill_row(2, p2, v2, i2, max_new)
    for _ in range(4 * max_new):
        snap = eng.snapshot()
        if all(snap["finished"][r] for r in range(3)):
            break
        eng.step_n(3)
    return [list(np.asarray(eng.collect_row(r))) for r in range(3)]


@pytest.mark.parametrize("tier", list(TIERS))
def test_paged_engine_matches_jax(models, tier):
    """One-shot and chunked admissions through both engines: token for token;
    every block back on the free list."""
    je, te = engines(models, tier)
    free0 = list(te._free)
    reqs = requests(models["fp32"][1])
    with torch.no_grad():
        got = drive(te, reqs)
    want = drive(je, reqs)
    assert got == want
    assert all(1 <= len(g) <= 10 for g in got)
    assert sorted(te._free) == sorted(free0) and te.num_active() == 0
    assert te.pool_bytes() == sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in (
        je._state.k_pool, je._state.v_pool) + ((je._state.k_scales, je._state.v_scales)
                                                if tier == "kv8" else ()))


@pytest.mark.parametrize("tier", ["fp32", "int4"])
def test_scheduler_matches_single_stream(models, tier):
    """Concurrent greedy requests through the Scheduler (4 on 3 rows, so some
    wait, and the long one may admit in chunks) equal the port's
    single-stream Engine, token for token."""
    _, tm = models["int4" if tier == "int4" else "fp32"]
    _, te = engines(models, tier)
    reqs = requests(tm) + [(np.arange(5, 30) % 17 + 3, None, None)]
    gc = t_samp.SamplingConfig.greedy(10)
    want = [list(tm.engine.generate(np.asarray(p)[None], v, None if i is None else np.array([i]),
                                    gc)[0]) for p, v, i in reqs]
    sched = t_server.Scheduler(te, prefill_chunk=16)
    got = [None] * len(reqs)
    try:
        def run(k):
            p, v, i = reqs[k]
            got[k] = list(t_server.generate_sync(sched, p, v, i, max_new_tokens=10,
                                                 timeout=300))
        threads = [threading.Thread(target=run, args=(k,)) for k in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sched.stop()
    assert got == want
    assert len(te._free) == te.NB - 1 and te.num_active() == 0


def test_deferral_recycling_and_sampled_rows(models):
    """A pool with blocks for one request at a time: requests wait on
    ``can_admit``, every one completes, every block comes back.  Sampled rows
    (default, TFS, top-a, mirostat-2) run beside greedy ones."""
    _, tm = models["fp32"]
    tok = tm.tokenizer
    te = TPaged(tm.model, tm.config, eos_token_id=tok.eos_token_id,
                pad_token_id=tok.pad_token_id, **{**ENGINE_KW, "num_blocks": 8})
    sched = t_server.Scheduler(te)
    overrides = [None, {"do_sample": False}, {"tfs": 0.9}, {"top_a": 0.2},
                 {"mirostat_mode": 2}, {"do_sample": False, "no_repeat_ngram_size": 2}]
    outs = [None] * len(overrides)
    try:
        def run(k):
            outs[k] = t_server.generate_sync(sched, np.arange(4, 30) % 13 + 3,
                                             max_new_tokens=8, sampling_overrides=overrides[k],
                                             timeout=300)
        threads = [threading.Thread(target=run, args=(k,)) for k in range(len(overrides))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sched.stop()
    for o in outs:
        assert o is not None and 1 <= len(o) <= 8 and int(o.max()) < tm.config.text_config.vocab_size
    assert len(te._free) == 7 and te.num_active() == 0
    # the one-token request finishes at admission
    te.prefill_row(0, np.arange(4, 12), None, None, 1)
    assert te.snapshot()["finished"][0]
    assert len(te.collect_row(0)) == 1


def test_unported_serving_options_raise(models):
    _, tm = models["fp32"]
    kw = dict(eos_token_id=2, pad_token_id=0)
    # the pool is served over a mesh now (tests/test_torch_mesh_serving.py);
    # one that is not a torch DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        TPaged(tm.model, tm.config, mesh=object(), **kw)
    with pytest.raises(ValueError, match="mirostat"):
        t_server.sampling_knobs(t_samp.SamplingConfig(), {"mirostat_mode": 1})


def _scheduler_calls() -> set:
    """The members ``Scheduler`` calls on its engine, read from its source."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(t_server.Scheduler)))
    calls = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            owner = node.func.value
            if ((isinstance(owner, ast.Name) and owner.id == "eng")
                    or (isinstance(owner, ast.Attribute) and owner.attr == "engine")):
                calls.add(node.func.attr)
    return calls


@pytest.mark.parametrize("klass", [t_server.ServingEngine, TPaged, t_serving.Leader],
                         ids=lambda k: k.__name__)
def test_scheduler_contract(klass):
    """Every member the Scheduler calls on its engine is defined on the
    pool's class itself or on ``RowPool``: none is reached through
    ``__getattr__`` (``Leader`` forwards only attributes it reads)."""
    calls = _scheduler_calls()
    assert {"prefill_row", "begin_prefill", "step_n", "step", "spec_step_n", "snapshot",
            "release_rows", "can_admit", "spec_ready", "idle", "release_followers"} <= calls
    for name in sorted(calls):
        owner = next((k for k in klass.__mro__ if name in vars(k)), None)
        assert owner in (klass, t_pool.RowPool), (name, owner)
        member = vars(owner)[name]
        assert callable(member) and member.__name__ == name, name


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


def test_http_pool_matches_jax(models, ckpt):
    from PIL import Image

    from visualcla_tpu.apps import serve as j_serve
    from visualcla_tpu_torch.apps import serve as t_serve

    jm, tm = models["fp32"]
    s = ckpt[1].vision_config.image_size
    img = np.random.default_rng(3).integers(0, 256, (s + 5, s + 9, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    png = base64.b64encode(buf.getvalue()).decode()
    buf = io.BytesIO()
    np.save(buf, img)
    npy = base64.b64encode(buf.getvalue()).decode()
    gc = {"do_sample": False, "max_new_tokens": 8}
    jw = j_serve.PoolWorker(jm, pool_size=2, paged=True, block_size=64)
    tw = t_serve.PoolWorker(tm, pool_size=2, paged=True, block_size=64)
    js, ts = _serve(jw, j_serve.make_handler), _serve(tw, t_serve.make_handler)
    try:
        for body in ({"text": "ab你好", "image_b64": png, "generation_config": gc},
                     {"text": "cd", "generation_config": gc}):
            want = _post(js, "/chat", body)
            assert _post(ts, "/chat", body) == want
            stream = _post(ts, "/chat_stream", body)
            assert stream[-1] == _post(js, "/chat_stream", body)[-1] == want
            assert all("partial" in x for x in stream[:-1])
        # the same pixels as a .npy payload, no Pillow needed
        body = {"text": "ab你好", "image_b64": npy, "generation_config": gc}
        assert _post(ts, "/chat", body) == _post(ts, "/chat", {**body, "image_b64": png})
        url = f"http://127.0.0.1:{ts.server_address[1]}/health"
        with urllib.request.urlopen(url, timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    finally:
        for server in (js, ts):
            server.shutdown()
            server.server_close()
        jw.scheduler.stop()
        tw.close()
