"""The PyTorch port's device-resident decode loops against the JAX package's
fused loops, on the CPU in fp32: ``Engine.generate`` and ``stream``, the
paged pool's ``step_n`` and ``spec_step_n``, ``SpeculativeDecoder`` and
``beam_generate_fused``.  On CPU tensors the port runs the same chunks of
gated step functions that the card replays from captured CUDA graphs, so
each case holds those chunks (a stop inside a chunk, a length that is not a
multiple of the chunk, the end of the cache) token for token against the
JAX ``lax.while_loop``.  A guard makes every read of a tensor back to the
host raise while a step function runs: the captured steps read nothing.

Tolerance: none; token for token (fp32, the same arithmetic)."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.engine import beam as j_beam
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu.engine.generate import Engine as JEngine
from visualcla_tpu.engine.paged import PagedServingEngine as JPaged
from visualcla_tpu.engine.speculative import SpeculativeDecoder as JSpec
from visualcla_tpu_torch.engine import beam as t_beam
from visualcla_tpu_torch.engine import generate as t_gen
from visualcla_tpu_torch.engine import graphs as t_graphs
from visualcla_tpu_torch.engine import paged as t_paged
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.engine import speculative as t_spec
from visualcla_tpu_torch.text import encoding_text

MAX_SEQ = 256


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ckpt, cfg = make_native_ckpt(str(tmp_path_factory.mktemp("graphs")))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=MAX_SEQ)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=MAX_SEQ)
    s = cfg.vision_config.image_size
    pix = np.random.default_rng(1).standard_normal((1, 3, s, s)).astype(np.float32)
    ids = encoding_text([], "ab你好", tm.num_patch, tm.tokenizer)["input_ids"]
    img = np.flatnonzero(ids[0] == tm.tokenizer.img_start_token_id)[:1]
    return jm, tm, cfg, ids, pix, img


def engines(both, eos):
    jm, tm = both[:2]
    kw = dict(eos_token_id=eos, pad_token_id=tm.tokenizer.pad_token_id, max_seq_len=MAX_SEQ)
    return (JEngine(jm.params, jm.config, dtype=jnp.float32, **kw),
            t_gen.Engine(tm.model, tm.config, **kw))


LOOPING = np.array([5, 6, 7, 8, 9, 10] * 3)  # a text prompt: its answer loops later


def answer(both, text=False, n=24):
    """The greedy answer's tokens (to the chat prompt, or to ``LOOPING``)
    with an EOS that never comes."""
    _, tm, _, ids, pix, img = both
    _, te = engines(both, eos=10 ** 6)
    prompt = (LOOPING[None], None, None) if text else (ids, pix, img)
    return te.generate(*prompt, t_samp.SamplingConfig.greedy(n))[0]


GREEDY = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
              no_repeat_ngram_size=0)
# do_sample with top-k 1: the draw is deterministic, so both packages' draws
# agree while the sampled path (penalties, temperature, top-k / top-p,
# the exponential race) runs
SAMPLED = dict(do_sample=True, temperature=0.7, top_k=1, top_p=0.9, repetition_penalty=1.2,
               no_repeat_ngram_size=3)
# (sampling kwargs, EOS: "none" never, "eos" the tokenizer's, k: the text
#  answer's k-th token, which first occurs there: the generation ends inside
#  the first captured chunk)
GEN_CASES = {
    "greedy": (dict(GREEDY, max_new_tokens=12), "eos"),
    "sampled_processors": (dict(SAMPLED, max_new_tokens=12, min_new_tokens=3), "none"),
    "eos_inside_chunk": (dict(GREEDY, max_new_tokens=20), 4),
    "length_not_chunk_multiple": (dict(GREEDY, max_new_tokens=13), "none"),
    # the text prompt's 128-token bucket and 128 new tokens fill the
    # 256-slot cache exactly
    "cache_end": (dict(GREEDY, max_new_tokens=MAX_SEQ - 128), "none", "text"),
}


def case_eos(both, eos):
    if eos == "eos":
        return both[1].tokenizer.eos_token_id
    if eos == "none":
        return 10 ** 6
    ans = answer(both, text=True)
    assert ans[eos] not in ans[:eos]
    return int(ans[eos])


def case_prompt(both, eos, kind="chat"):
    """The text prompt where the EOS is one of its answer's tokens, else the chat."""
    _, _, _, ids, pix, img = both
    text = isinstance(eos, int) or kind == "text"
    return (LOOPING[None], None, None) if text else (ids, pix, img)


@pytest.mark.parametrize("name", list(GEN_CASES))
def test_generate_matches_jax(both, name):
    kw, eos, *kind = GEN_CASES[name]
    je, te = engines(both, case_eos(both, eos))
    prompt = case_prompt(both, eos, *kind)
    want = np.asarray(je.generate(*prompt, j_samp.SamplingConfig(**kw)))
    got = te.generate(*prompt, t_samp.SamplingConfig(**kw))
    assert got.tolist() == want.tolist()
    if name == "cache_end":
        assert got.shape[1] == kw["max_new_tokens"]
        ws, = te._workspaces.values()
        assert ws.key == (1, MAX_SEQ)
        assert int(ws.cur_slot[0]) == MAX_SEQ - 1 and bool(ws.kv_valid[0, -2])
    if eos not in ("none", "eos"):
        assert got.shape[1] == eos + 1 < t_gen.DECODE_CHUNK


def test_generate_batch_matches_jax(both):
    """Two uneven rows (one left-padded): every row's tokens, pads after EOS."""
    _, tm, _, ids, _, _ = both
    rng = np.random.default_rng(3)
    batch = rng.integers(3, 20, (2, 10))
    batch[1, :3] = tm.tokenizer.pad_token_id
    je, te = engines(both, int(answer(both, text=True)[5]))
    kw = dict(GREEDY, max_new_tokens=11)
    want = np.asarray(je.generate(batch, None, None, j_samp.SamplingConfig(**kw)))
    assert te.generate(batch, None, None, t_samp.SamplingConfig(**kw)).tolist() == want.tolist()


@pytest.mark.parametrize("chunk_size", [1, 4])
@pytest.mark.parametrize("name", ["eos_inside_chunk", "length_not_chunk_multiple"])
def test_stream_matches_jax(both, name, chunk_size):
    kw, eos = GEN_CASES[name]
    je, te = engines(both, case_eos(both, eos))
    prompt = case_prompt(both, eos)
    want = [np.asarray(t).tolist() for t in je.stream(
        *prompt, j_samp.SamplingConfig(**kw), chunk_size=chunk_size)]
    got = [t.tolist() for t in te.stream(*prompt, t_samp.SamplingConfig(**kw),
                                         chunk_size=chunk_size)]
    assert got == want
    assert [t[0] for t in got] == te.generate(*prompt, t_samp.SamplingConfig(**kw))[0].tolist()


def test_workspace_reused_and_private_while_busy(both):
    """A second request of the same shape reuses the workspace (its buffers,
    so a graph's addresses); a request while a stream is open gets a private
    one; every workspace's state equals a fresh engine's."""
    _, tm, _, ids, pix, img = both
    _, te = engines(both, 10 ** 6)
    cfg = t_samp.SamplingConfig.greedy(6)
    first = te.generate(ids, pix, img, cfg)
    ws, = te._workspaces.values()
    stream = te.stream(ids, pix, img, cfg)
    next(stream)
    assert te.workspace(*ws.key) is not ws  # busy: a private one
    assert te.generate(ids, pix, img, cfg).tolist() == first.tolist()
    assert [int(t[0]) for t in stream] == first[0, 1:].tolist()
    assert te.workspace(*ws.key) is ws and len(te._workspaces) == 1


# ---------------------------------------------------------------------------
# the paged pool
# ---------------------------------------------------------------------------

POOL_KW = dict(pool_size=3, block_size=16, num_blocks=48, max_seq_len=256,
               max_new_tokens_cap=24, prompt_buckets=(32, 64, 128, 256))


def pools(both, spec_k=0, eos=None):
    jm, tm = both[:2]
    tok = tm.tokenizer
    kw = dict(POOL_KW, eos_token_id=tok.eos_token_id if eos is None else eos,
              pad_token_id=tok.pad_token_id, spec_k=spec_k, spec_max_active=3)
    return (JPaged(jm.params, jm.config, dtype=jnp.float32,
                   sampling=j_samp.SamplingConfig.greedy(24), **kw),
            t_paged.PagedServingEngine(tm.model, tm.config,
                                       sampling=t_samp.SamplingConfig.greedy(24), **kw))


def same_snapshot(je, te):
    want, got = je.snapshot(), te.snapshot()
    for key in ("last_token", "gen_len", "active", "finished", "gen_ids"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(te.ctx_len, np.asarray(je.ctx_len))
    return got


@pytest.mark.parametrize("spec_k", [0, 3], ids=["step_n", "spec_step_n"])
def test_pool_chunks_match_jax(both, spec_k):
    """Rows of different lengths finish inside chunks of 4: each chunk stops
    at the JAX loop's step (the first finish), the snapshots and the host
    context lengths equal the JAX pool's after every call; a retired row's
    successor (with an image) joins mid-way."""
    _, tm, _, ids, pix, img = both
    eos = int(answer(both, text=True)[6])
    je, te = pools(both, spec_k=spec_k, eos=eos)
    rng = np.random.default_rng(5)
    reqs = [(LOOPING, None, None, 5), (rng.integers(3, 20, 9), None, None, 11),
            (rng.integers(3, 20, 40), None, None, 17)]
    for row, (p, v, i, n) in enumerate(reqs):
        je.prefill_row(row, p, v, i, n)
        te.prefill_row(row, p, v, i, n)
    same_snapshot(je, te)
    admitted = False
    for _ in range(40):
        snap = same_snapshot(je, te)
        if snap["finished"].all():
            break
        if snap["finished"][0] and not admitted:
            for eng in (je, te):
                eng.release_rows([0])
                eng.prefill_row(0, ids[0], pix, int(img[0]), 7)
            admitted = True
            continue
        for eng in (je, te):
            (eng.spec_step_n if spec_k else eng.step_n)(4)
    assert admitted and te.snapshot()["finished"].all()
    if spec_k:
        assert te.spec_steps > 0


# ---------------------------------------------------------------------------
# single-stream speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,eos_at,spec_k,max_new", [
    ("repetitive", "none", 4, 22), ("eos_inside", 5, 3, 16), ("processors", "eos", 4, 12),
])
def test_speculative_matches_jax(both, name, eos_at, spec_k, max_new):
    _, tm, _, ids, pix, img = both
    je, te = engines(both, case_eos(both, eos_at))
    kw = dict(GREEDY, max_new_tokens=max_new)
    if name == "processors":
        kw.update(repetition_penalty=1.3, no_repeat_ngram_size=3, min_new_tokens=4)
    prompt = (ids, pix, img) if name == "processors" else (LOOPING[None], None, None)
    jdec, tdec = JSpec(je, spec_k=spec_k, max_ngram=3), t_spec.SpeculativeDecoder(te, spec_k, 3)
    want = np.asarray(jdec.generate(*prompt, j_samp.SamplingConfig(**kw)))
    got = tdec.generate(*prompt, t_samp.SamplingConfig(**kw))
    assert got.tolist() == want.tolist()
    assert tdec.last_stats == pytest.approx(jdec.last_stats)
    want_s = [np.asarray(t).tolist() for t in jdec.stream(*prompt, j_samp.SamplingConfig(**kw))]
    assert [t.tolist() for t in tdec.stream(*prompt, t_samp.SamplingConfig(**kw))] == want_s
    if name == "repetitive":
        assert tdec.last_stats["tokens_per_chunk"] > 1.0


# ---------------------------------------------------------------------------
# the fused beam search
# ---------------------------------------------------------------------------

BEAM_CASES = {
    "nb2": dict(num_beams=2),
    "nb4_length_penalty_2": dict(num_beams=4, length_penalty=2.0),
    "early_stopping": dict(num_beams=3, early_stopping=True, eos=3),
    "eos_heavy": dict(num_beams=3, eos=2),
    "cache_cap": dict(num_beams=3, cap=4),
    "text_only": dict(num_beams=2, text_only=True, max_new_tokens=9),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_fused_matches_jax_and_host(both, case):
    """``beam_generate_fused`` equals the JAX ``beam_generate_fused`` and the
    port's host ``beam_generate`` (mirrors the JAX package's fused-beam
    tests: matches host, EOS-heavy, the cache cap)."""
    jm, tm, cfg, ids, pix, pos = both
    kw = dict(BEAM_CASES[case])
    eos = tm.tokenizer.eos_token_id
    if "eos" in kw:  # one of the answer's tokens: EOS candidates on most steps
        eos = int(answer(both)[kw.pop("eos")])
    cap = kw.pop("cap", None)
    if kw.pop("text_only", False):
        ids, pix, pos = LOOPING[None], None, np.full((1,), -1, np.int32)
    common = dict(max_new_tokens=10, eos_token_id=eos, pad_token_id=tm.tokenizer.pad_token_id,
                  max_seq_len=None if cap is None else ids.shape[1] + cap)
    common.update(kw)
    want = np.asarray(j_beam.beam_generate_fused(jm.params, cfg, ids, pix, pos,
                                                 dtype=jnp.float32, **common))
    stats = {}
    got = t_beam.beam_generate_fused(tm.model, tm.config, ids, pix, pos, stats=stats, **common)
    host = t_beam.beam_generate(tm.model, tm.config, ids, pix, pos, **common)
    assert got.tolist() == want.tolist() == host.tolist()
    assert stats["steps"] >= 0 and stats["passes"] % t_beam.BEAM_CHUNK == 0
    if cap is not None:  # the prefill's token, then one a slot up to the cap
        assert len(got) <= cap + 1


def test_beam_fused_reuses_its_workspace(both):
    jm, tm, cfg, ids, pix, pos = both
    kw = dict(num_beams=2, max_new_tokens=6, eos_token_id=tm.tokenizer.eos_token_id)
    a = t_beam.beam_generate_fused(tm.model, tm.config, ids, pix, pos, **kw)
    ws = t_beam._FUSED[tm.model][(2, 256, 6, "none")]
    b = t_beam.beam_generate_fused(tm.model, tm.config, ids, pix, pos, **kw)
    assert a.tolist() == b.tolist() and t_beam._FUSED[tm.model][(2, 256, 6, "none")] is ws


@pytest.mark.parametrize("env,nrs,fn", [(None, 1, "beam_generate_fused"),
                                        ("host", 1, "beam_generate"),
                                        (None, 2, "beam_generate")])
def test_api_beam_dispatch(both, monkeypatch, env, nrs, fn):
    """Greedy beams with one hypothesis take the fused form, as the JAX
    package's ``api``; ``VISUALCLA_BEAM=host`` and ``num_return_sequences >
    1`` the host scorer; both give the same best hypothesis."""
    from visualcla_tpu_torch import api as t_api

    _, tm, _, ids, pix, _ = both
    if env is None:
        monkeypatch.delenv("VISUALCLA_BEAM", raising=False)
    else:
        monkeypatch.setenv("VISUALCLA_BEAM", env)
    calls = []
    for name in ("beam_generate", "beam_generate_fused"):
        orig = getattr(t_api, name)
        monkeypatch.setattr(t_api, name,
                            lambda *a, _o=orig, _n=name, **k: calls.append(_n) or _o(*a, **k))
    cfg = t_samp.SamplingConfig(num_beams=3, do_sample=False, max_new_tokens=8,
                                num_return_sequences=nrs)
    out = tm.generate(ids, pixel_values=pix, generation_config=cfg)
    assert calls == [fn]
    monkeypatch.setenv("VISUALCLA_BEAM", "host")
    ref = tm.generate(ids, pixel_values=pix, generation_config=cfg)
    assert out.tolist() == ref.tolist()


# ---------------------------------------------------------------------------
# the guard: a captured step reads nothing back
# ---------------------------------------------------------------------------

READS = ("item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__")


@pytest.fixture
def guard(monkeypatch):
    """-> wrap(owner, name): while ``owner.name`` runs, every read of a
    tensor back to the host raises; -> the number of guarded calls."""
    active = [False]
    calls = [0]

    def refuse(name, orig):
        def method(self, *a, **k):
            if active[0]:
                raise AssertionError(f"a captured step read a tensor back ({name})")
            return orig(self, *a, **k)
        return method

    for name in READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name, getattr(torch.Tensor, name)))

    def wrap(owner, name):
        orig = getattr(owner, name)

        def guarded(*a, **k):
            active[0] = True
            calls[0] += 1
            try:
                return orig(*a, **k)
            finally:
                active[0] = False
        monkeypatch.setattr(owner, name, guarded)

    wrap.calls = calls
    return wrap


@pytest.mark.parametrize("loop", ["generate", "stream", "step_n", "spec_step_n",
                                  "speculative", "beam"])
def test_captured_steps_read_nothing_back(both, guard, loop):
    _, tm, _, ids, pix, img = both
    sampled = t_samp.SamplingConfig(**dict(SAMPLED, max_new_tokens=9, top_k=5))
    if loop in ("generate", "stream"):
        guard(t_gen.Engine, "step")
        _, te = engines(both, case_eos(both, 4))
        if loop == "generate":
            te.generate(ids, pix, img, sampled)
        else:
            list(te.stream(ids, pix, img, sampled, chunk_size=3))
    elif loop in ("step_n", "spec_step_n"):
        guard(t_paged.PagedServingEngine, "_spec_step" if loop == "spec_step_n" else "_decode_step")
        _, te = pools(both, spec_k=3 if loop == "spec_step_n" else 0)
        te.prefill_row(0, LOOPING, None, None, 9)
        te.prefill_row(1, ids[0], pix, int(img[0]), 9,
                       overrides={"do_sample": True, "top_k": 300, "repetition_penalty": 1.2})
        for _ in range(4):
            (te.spec_step_n if loop == "spec_step_n" else te.step_n)(3)
    elif loop == "speculative":
        guard(t_spec, "spec_chunk")
        _, te = engines(both, case_eos(both, 5))
        t_spec.SpeculativeDecoder(te, 3, 3).generate(LOOPING[None], None, None, sampled)
    else:
        guard(t_beam._FusedBeam, "step")
        t_beam.beam_generate_fused(tm.model, tm.config, ids, pix, img, num_beams=3,
                                   max_new_tokens=8, eos_token_id=tm.tokenizer.eos_token_id)
    assert guard.calls[0] > 0


def test_eager_context_is_the_same_chunks(both):
    """``graphs.eager()`` (the card's by-name eager run) changes nothing on
    the CPU, where the chunks always run eagerly."""
    _, tm, _, ids, pix, img = both
    _, te = engines(both, 10 ** 6)
    cfg = t_samp.SamplingConfig(**dict(SAMPLED, max_new_tokens=9, top_k=5))
    out = te.generate(ids, pix, img, cfg, seed=3)
    with t_graphs.eager():
        assert te.generate(ids, pix, img, cfg, seed=3).tolist() == out.tolist()
    assert te.graphs.captures == 0
