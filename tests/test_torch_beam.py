"""Beam search in the PyTorch port against the JAX package, on the CPU in
fp32: ``_reorder_tail``, ``BeamHypotheses``, ``beam_generate`` token for
token over beam counts, length penalties, early stopping, an EOS-heavy
search, the cache cap and ``num_return_sequences``; batched rows against
per-row runs; beam sampling's candidate draw on the same Gumbel noise; the
API's dispatch and refusals; ``chat(num_beams=2)`` across both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.engine import beam as j_beam
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu_torch.engine import beam as t_beam
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.text import encoding_text


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ckpt, cfg = make_native_ckpt(str(tmp_path_factory.mktemp("beam")))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    s = cfg.vision_config.image_size
    pix = np.random.default_rng(1).standard_normal((1, 3, s, s)).astype(np.float32)
    ids = encoding_text([], "ab你好", tm.num_patch, tm.tokenizer)["input_ids"]
    pos = np.asarray(tm._img_positions(ids, pix))
    return jm, tm, cfg, ids, pix, pos


def _frequent_token(jm, tm, ids, pix):
    """The token the greedy answer repeats most: as EOS it ends many beams."""
    out = np.asarray(tm.generate(ids, pixel_values=pix,
                                 generation_config=t_samp.SamplingConfig.greedy(12)))[0]
    vals, counts = np.unique(out, return_counts=True)
    return int(vals[np.argmax(counts)])


CASES = {
    "nb2": dict(num_beams=2),
    "nb3": dict(num_beams=3),
    "nb4": dict(num_beams=4),
    "length_penalty_0.5": dict(num_beams=3, length_penalty=0.5),
    "length_penalty_2": dict(num_beams=2, length_penalty=2.0),
    "early_stopping": dict(num_beams=3, early_stopping=True, eos="frequent"),
    "eos_heavy": dict(num_beams=4, eos="frequent"),
    "cache_cap": dict(num_beams=2, cap=5),
    "return_3": dict(num_beams=4, num_return_sequences=3),
    "return_2_eos_heavy": dict(num_beams=3, num_return_sequences=2, eos="frequent"),
    "text_only": dict(num_beams=3, text_only=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_generate_matches_jax(both, case):
    jm, tm, cfg, ids, pix, pos = both
    kw = dict(CASES[case])
    eos = tm.tokenizer.eos_token_id
    if kw.pop("eos", None) == "frequent":
        eos = _frequent_token(jm, tm, ids, pix)
    cap = kw.pop("cap", None)
    if kw.pop("text_only", False):
        pix = None
        pos = np.full((1,), -1, np.int32)
    common = dict(max_new_tokens=10, eos_token_id=eos, pad_token_id=tm.tokenizer.pad_token_id,
                  max_seq_len=None if cap is None else ids.shape[1] + cap, **kw)
    want = j_beam.beam_generate(jm.params, cfg, ids, pix, pos, dtype=jnp.float32, **common)
    stats = {}
    got = t_beam.beam_generate(tm.model, tm.config, ids, pix, pos, stats=stats, **common)
    if kw.get("num_return_sequences", 1) > 1:
        assert isinstance(got, list) and len(got) == len(want) == kw["num_return_sequences"]
        assert [g.tolist() for g in got] == [np.asarray(w).tolist() for w in want]
        assert stats["scores"] == sorted(stats["scores"], reverse=True)
    else:
        assert got.tolist() == np.asarray(want).tolist()
    if cap is not None:  # cap slots written, then the token chosen from the last
        assert len(got) == cap + 1
    assert 0 <= stats["steps"] <= common["max_new_tokens"] - 1


@pytest.mark.parametrize("scales", [False, True], ids=["bf16_cache", "int8_cache"])
def test_reorder_tail_matches_a_full_gather(scales):
    """Every beam shares the prefill (slots [0, P) equal across the beam axis)
    and slots from the write slot W on are zeros, so gathering the live
    window alone equals gathering the whole cache."""
    g = torch.Generator().manual_seed(0)
    L, nb, Nkv, S, hd, P, W = 2, 3, 2, 12, 4, 4, 8

    def leaf(*shape, dtype=torch.float32):
        v = torch.randn(*shape, generator=g)
        v[:] = v[:, :1].clone()
        v[:, :, :, P:W] = torch.randn(*shape, generator=g)[:, :, :, P:W]
        v[:, :, :, W:] = 0
        return v.to(dtype)

    if scales:
        cache = {"k": (leaf(L, nb, Nkv, S, hd) * 20).to(torch.int8),
                 "v": (leaf(L, nb, Nkv, S, hd) * 20).to(torch.int8),
                 "k_scale": leaf(L, nb, Nkv, S), "v_scale": leaf(L, nb, Nkv, S)}
    else:
        cache = {"k": leaf(L, nb, Nkv, S, hd, dtype=torch.bfloat16),
                 "v": leaf(L, nb, Nkv, S, hd, dtype=torch.bfloat16)}
    idx = torch.tensor([2, 0, 0])
    want = {k: v[:, idx].clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    got = t_beam._reorder_tail(cache, idx, P, W)
    for k in cache:
        assert torch.equal(got[k], want[k]), k
        assert got[k].data_ptr() == ptrs[k]  # in place
    # an empty window (the first step) leaves the cache as it is
    before = {k: v.clone() for k, v in cache.items()}
    t_beam._reorder_tail(cache, torch.tensor([1, 1, 1]), P, P)
    assert all(torch.equal(cache[k], before[k]) for k in cache)


@pytest.mark.parametrize("lp,early", [(1.0, False), (0.7, False), (2.0, True)])
def test_beam_hypotheses_match_jax(lp, early):
    rng = np.random.default_rng(int(lp * 10) + early)
    jh = j_beam.BeamHypotheses(3, lp, early)
    th = t_beam.BeamHypotheses(3, lp, early)
    for i in range(40):
        ids = rng.integers(0, 50, rng.integers(1, 9))
        score = float(rng.normal(-5.0, 2.0))
        jh.add(ids, score)
        th.add(ids, score)
        assert th.worst_score == jh.worst_score
        assert [(h.ids.tolist(), h.score) for h in th.hyps] == [
            (h.ids.tolist(), h.score) for h in jh.hyps]
        for best, cur in ((score, i % 7 + 1), (-1.0, 3), (-20.0, 9)):
            assert th.is_done(best, cur) == jh.is_done(best, cur)
    assert th.best().tolist() == jh.best().tolist()
    assert [h.tolist() for h in th.best_n(2)] == [h.tolist() for h in jh.best_n(2)]


@pytest.mark.parametrize("nrs", [1, 2])
def test_batched_beam_matches_per_row(both, nrs):
    """The port's form of the reference harness's batched-beam test: every
    row its own search, right-padded to the longest, n rows a prompt."""
    _, tm, _, _, _, _ = both
    gc = dataclasses.replace(t_samp.SamplingConfig.greedy(max_new_tokens=6), num_beams=3,
                             num_return_sequences=nrs)
    ids = np.random.default_rng(2).integers(4, 80, (2, 9))
    batched = tm.generate(ids, generation_config=gc)
    assert batched.shape[0] == 2 * nrs
    pad = tm.tokenizer.pad_token_id
    for b in range(2):
        rows = tm.generate(ids[b:b + 1], generation_config=gc)
        for j in range(nrs):
            one = rows[j][:np.max(np.nonzero(rows[j] != pad)[0], initial=-1) + 1] \
                if nrs > 1 else rows[0]
            got = batched[b * nrs + j]
            assert got[:len(one)].tolist() == one.tolist()
            assert (got[len(one):] == pad).all()


def _jax_noises(seed, n, shape):
    """The Gumbel noise JAX's beam_sample_generate draws: one split of its
    key for the prefill's draw, one a step."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, shape, jnp.float32)))
    return out


SAMPLED = {
    "warped": dict(temperature=0.7, top_k=5, top_p=0.9, repetition_penalty=1.2,
                   no_repeat_ngram_size=3),
    "plain": dict(temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
                  no_repeat_ngram_size=0),
    "top_k_1": dict(temperature=0.5, top_k=1, top_p=0.5, repetition_penalty=1.1,
                    no_repeat_ngram_size=2),
}


@pytest.mark.parametrize("name", list(SAMPLED))
def test_beam_sample_matches_jax_on_the_same_gumbel_noise(both, name, monkeypatch):
    """JAX's own Gumbel draws take the place of the generator's."""
    jm, tm, cfg, ids, pix, pos = both
    fields = dict(num_beams=3, do_sample=True, max_new_tokens=8, **SAMPLED[name])
    jc, tc = j_samp.SamplingConfig(**fields), t_samp.SamplingConfig(**fields)
    common = dict(eos_token_id=tm.tokenizer.eos_token_id,
                  pad_token_id=tm.tokenizer.pad_token_id)
    want = j_beam.beam_sample_generate(jm.params, cfg, ids, pix, pos, jc, seed=7,
                                       dtype=jnp.float32, **common)
    V = cfg.text_config.vocab_size
    noise = iter(_jax_noises(7, fields["max_new_tokens"], (1, 3 * V)))

    def jax_gumbel(generator, shape, device):
        draw = torch.tensor(next(noise), device=device)
        assert tuple(draw.shape) == tuple(shape)
        return draw

    monkeypatch.setattr(t_beam, "gumbel_noise", jax_gumbel)
    got = t_beam.beam_sample_generate(tm.model, tm.config, ids, pix, pos, tc, **common)
    assert got.tolist() == np.asarray(want).tolist()


def test_sample_candidates_keep_two_tokens_a_beam():
    """HF's ``min_tokens_to_keep=2`` under beams: even top-k 1 and a tiny
    top-p leave two candidates a beam, so the 2nb draw finds finite scores."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 50, generator=g)
    cfg = t_samp.SamplingConfig(num_beams=3, top_k=1, top_p=0.01, temperature=0.5,
                                repetition_penalty=1.0, no_repeat_ngram_size=0)
    gumbel = -torch.empty(1, 150).exponential_(generator=g).log()
    scores, idx = t_beam.sample_candidates(logits, torch.zeros(3), torch.zeros(3, 4,
                                           dtype=torch.int64), torch.zeros(3, dtype=torch.int64),
                                           cfg, gumbel)
    assert torch.isfinite(scores).all() and len(set((idx // 50).tolist())) == 3
    assert (scores[:-1] >= scores[1:]).all()


def test_sampled_beams_through_the_api_are_seeded(both):
    _, tm, _, ids, pix, _ = both
    gc = t_samp.SamplingConfig(num_beams=3, do_sample=True, max_new_tokens=8)
    a = tm.generate(ids, pixel_values=pix, generation_config=gc, seed=3)
    b = tm.generate(ids, pixel_values=pix, generation_config=gc, seed=3)
    assert a.tolist() == b.tolist()
    assert a.min() >= 0 and a.max() < tm.config.text_config.vocab_size
    batch = tm.generate(np.concatenate([ids, ids]), pixel_values=np.concatenate([pix, pix]),
                        generation_config=gc, seed=3)
    assert batch[0, :a.shape[1]].tolist() == a[0].tolist()  # row b samples with seed + b


def test_beam_api_refusals(both):
    jm, tm, cfg, ids, pix, _ = both
    beams = t_samp.SamplingConfig(num_beams=2, do_sample=False, max_new_tokens=4)
    multi = np.stack([pix, pix], axis=1)  # (1, 2, 3, H, W)
    with pytest.raises(NotImplementedError, match="multi-image"):
        tm.generate(ids, pixel_values=multi, generation_config=beams)
    with pytest.raises(NotImplementedError, match="multi-image"):
        jm.generate(ids, pixel_values=multi, generation_config=j_samp.SamplingConfig(
            num_beams=2, do_sample=False, max_new_tokens=4))
    with pytest.raises(ValueError, match="smaller or equal to num_beams"):
        tm.generate(ids, generation_config=dataclasses.replace(beams, num_return_sequences=3))
    with pytest.raises(ValueError, match="Greedy methods"):
        tm.generate(ids, generation_config=t_samp.SamplingConfig(
            do_sample=False, num_return_sequences=2))
    with pytest.raises(ValueError, match="beam search"):
        next(iter(tm.stream_generate(ids, pix, beams)))
    with pytest.raises(ValueError, match="batch size 1"):
        t_beam.beam_generate(tm.model, cfg, np.concatenate([ids, ids]), None, None,
                             num_beams=2, max_new_tokens=2, eos_token_id=2)


@pytest.mark.parametrize("nb", [2, 3])
def test_chat_with_beams_matches_jax(both, nb):
    jm, tm, cfg, _, pix, _ = both
    jc = j_samp.SamplingConfig(num_beams=nb, do_sample=False, max_new_tokens=10)
    tc = t_samp.SamplingConfig(num_beams=nb, do_sample=False, max_new_tokens=10)
    j_resp, j_hist = vj.chat(jm, pix, "ab你好", [], jc, verbose=False)
    t_resp, t_hist = vt.chat(tm, pix, "ab你好", [], tc, verbose=False)
    assert t_resp == j_resp and t_hist == j_hist


def test_beams_on_the_int8_kv_cache(both, tmp_path):
    """With ``kv_quant="int8"`` the beams' cache is int8 with its scales, and
    the reorder moves the scales with the values."""
    _, tm, _, ids, pix, _ = both
    gc = t_samp.SamplingConfig(num_beams=3, do_sample=False, max_new_tokens=6)
    q = vt.VisualCLA(tm.model, tm.config, tm.tokenizer, tm.image_processor, max_seq_len=256,
                     kv_quant="int8")
    state = t_beam._BeamState(q.model, q.config, ids, pix, None, 3, 6, None, 256, "int8")
    assert state.cache["k"].dtype == torch.int8 and "k_scale" in state.cache
    out = q.generate(ids, pixel_values=pix, generation_config=gc)
    assert out.shape[0] == 1 and 1 <= out.shape[1] <= 6
    assert out.min() >= 0 and out.max() < tm.config.text_config.vocab_size
