"""Single-stream speculative decoding in the PyTorch port against the JAX
package, on the CPU in fp32: the n-gram drafter bit for bit, the decoder
token for token against the JAX ``SpeculativeDecoder`` and against the port's
own plain ``Engine.generate`` (which is what speculation must never change),
streaming, the refusals, speculative sampling by distribution, and the chat
API.  One tiny native checkpoint goes through both factories."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu.engine.generate import Engine as JEngine
from visualcla_tpu.engine.speculative import SpeculativeDecoder as JSpec
from visualcla_tpu.engine.speculative import ngram_draft as j_draft
from visualcla_tpu_torch.api import chat as t_chat
from visualcla_tpu_torch.api import chat_in_stream as t_chat_in_stream
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.engine import speculative as t_spec
from visualcla_tpu_torch.engine.generate import Engine as TEngine
from visualcla_tpu_torch.ops.cuda import flash_attention as fa
from visualcla_tpu_torch.text import encoding_text


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------

def _j_drafts(ctx, start, end, k, max_ngram):
    return np.stack([np.asarray(j_draft(jnp.asarray(c, jnp.int32), jnp.int32(s), jnp.int32(e),
                                        k, max_ngram))
                     for c, s, e in zip(ctx, start, end)])


def _t_drafts(ctx, start, end, k, max_ngram):
    return t_spec.ngram_draft(torch.as_tensor(ctx), torch.as_tensor(start),
                              torch.as_tensor(end), k, max_ngram).numpy()


@pytest.mark.parametrize("ctx,start,end,k,max_ngram,want", [
    ([3, 4, 5, 6, 7, 8, 9, 4, 5, 0, 0, 0], 0, 9, 3, 3, [6, 7, 8]),  # the last bigram's continuation
    ([1, 2, 3, 9, 8, 3, 7, 1, 2, 3, 0, 0, 0], 0, 10, 1, 3, [9]),  # the trigram beats the unigram
    ([1, 2, 3, 4, 5, 0, 0], 0, 5, 2, 3, [5, 5]),  # no match: the last token
    ([4, 9, 1, 2, 4, 0, 0], 2, 5, 1, 1, [4]),  # the match sits before start
    ([5, 6, 7, 5, 6], 0, 5, 4, 3, [7, 5, 6, 0]),  # the continuation runs past the buffer
], ids=["bigram", "larger_n_wins", "fallback", "start_boundary", "past_the_end"])
def test_ngram_draft_cases(ctx, start, end, k, max_ngram, want):
    got = _t_drafts([ctx], [start], [end], k, max_ngram)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got, _j_drafts([ctx], [start], [end], k, max_ngram))


@pytest.mark.parametrize("alphabet", [3, 6, 50], ids=["repetitive", "mixed", "random"])
def test_ngram_draft_bit_equal_to_jax(alphabet):
    """Random buffers, starts and ends (the boundaries included): every row's
    drafts equal the JAX function's."""
    rng = np.random.default_rng(alphabet)
    B, C = 24, 20
    ctx = rng.integers(0, alphabet, (B, C))
    start = rng.integers(0, 6, B)
    end = np.clip(start + rng.integers(0, C, B), 0, C)
    end[:3] = [C, 0, start[2]]  # a full buffer, an empty one, an empty context
    for k, max_ngram in ((4, 3), (2, 1), (8, 5)):
        np.testing.assert_array_equal(_t_drafts(ctx, start, end, k, max_ngram),
                                      _j_drafts(ctx, start, end, k, max_ngram))


# ---------------------------------------------------------------------------
# the decoder against the JAX package and the port's plain engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ckpt, cfg = make_native_ckpt(str(tmp_path_factory.mktemp("spec")))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    return jm, tm, cfg


def engines(both, eos=None, kv_quant="none"):
    jm, tm, _ = both
    kw = dict(eos_token_id=tm.tokenizer.eos_token_id if eos is None else eos,
              pad_token_id=tm.tokenizer.pad_token_id, max_seq_len=256, kv_quant=kv_quant)
    return JEngine(jm.params, jm.config, dtype=jnp.float32, **kw), TEngine(tm.model, tm.config, **kw)


def pixels(cfg, seed):
    s = cfg.vision_config.image_size
    return np.random.default_rng(seed).standard_normal((1, 3, s, s)).astype(np.float32)


def chat_prompt(tm, text="ab你好"):
    ids = encoding_text([], text, tm.num_patch, tm.tokenizer)["input_ids"]
    return ids, np.flatnonzero(ids[0] == tm.tokenizer.img_start_token_id)[:1]


def trimmed(out, pad):
    return [list(r[r != pad]) for r in np.asarray(out)]


GREEDY = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
              no_repeat_ngram_size=0)
PROCESSORS = dict(GREEDY, repetition_penalty=1.3, no_repeat_ngram_size=3, min_new_tokens=4)


def _case(both, name):
    """(input ids, pixel values, marker positions, sampling kwargs, spec_k)."""
    _, tm, cfg = both
    rng = np.random.default_rng(len(name))
    V = cfg.text_config.vocab_size - 4  # the plain pieces, no specials
    if name == "multimodal":
        ids, img = chat_prompt(tm)
        return ids, pixels(cfg, 1), img, dict(GREEDY, max_new_tokens=12), 4
    if name == "text_only":
        return rng.integers(3, V, (1, 10)), None, None, dict(GREEDY, max_new_tokens=16), 5
    if name == "batch2":
        ids = rng.integers(3, V, (2, 10))
        ids[1, :3] = tm.tokenizer.pad_token_id  # a left-padded row
        return ids, None, None, dict(GREEDY, max_new_tokens=10), 3
    if name == "processors":
        return rng.integers(3, V, (1, 10)), None, None, dict(PROCESSORS, max_new_tokens=12), 4
    if name == "repetitive":
        return np.array([[12, 13, 14, 15, 16] * 3]), None, None, dict(GREEDY, max_new_tokens=24), 6
    raise KeyError(name)


CASES = ["multimodal", "text_only", "batch2", "processors", "repetitive"]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("name", CASES)
def test_generate_matches_jax_and_plain(both, name, kv_quant):
    ids, pv, img, kw, k = _case(both, name)
    je, te = engines(both, kv_quant=kv_quant)
    pad = te.pad_token_id
    t_cfg, j_cfg = t_samp.SamplingConfig(**kw), j_samp.SamplingConfig(**kw)
    dec = t_spec.SpeculativeDecoder(te, spec_k=k, max_ngram=3)
    fa.reset_launch_counts()
    got = dec.generate(ids, pv, img, t_cfg)
    assert not any(fa.LAUNCHES.values())  # CPU tensors: the plain versions
    jdec = JSpec(je, spec_k=k, max_ngram=3)
    want = jdec.generate(ids, pv, img, j_cfg)
    plain = te.generate(ids, pv, img, t_cfg)
    assert trimmed(got, pad) == trimmed(want, pad) == trimmed(plain, pad)
    # the same drafts: the same chunks and acceptance
    assert dec.last_stats == pytest.approx(jdec.last_stats)
    assert dec.last_stats["chunks"] >= 1
    assert dec.last_stats["emitted"] == sum(len(r) for r in trimmed(got, pad))
    if name == "repetitive":  # a looping context must accept drafts
        assert dec.last_stats["tokens_per_chunk"] > 1.0
        assert 0 < dec.last_stats["acceptance"] <= 1


def test_eos_cut_is_exact(both):
    """With the 5th greedy token taken as EOS, both decoders stop right after
    it, as the plain engine does: no draft echo past EOS."""
    ids, _, _, kw, _ = _case(both, "text_only")
    _, te = engines(both)
    plain = te.generate(ids, None, None, t_samp.SamplingConfig(**kw))[0]
    eos = int(plain[4])
    je, te = engines(both, eos=eos)
    got = t_spec.SpeculativeDecoder(te, spec_k=4).generate(ids, None, None,
                                                           t_samp.SamplingConfig(**kw))
    want = JSpec(je, spec_k=4).generate(ids, None, None, j_samp.SamplingConfig(**kw))
    cut = list(plain[:list(plain).index(eos) + 1])
    assert list(got[0]) == list(np.asarray(want)[0]) == cut


@pytest.mark.parametrize("name", ["multimodal", "processors"])
def test_stream_matches_generate(both, name):
    ids, pv, img, kw, k = _case(both, name)
    _, te = engines(both)
    cfg = t_samp.SamplingConfig(**kw)
    dec = t_spec.SpeculativeDecoder(te, spec_k=k)
    blocking = [t for t in dec.generate(ids, pv, img, cfg)[0] if t != te.pad_token_id]
    streamed = [int(t[0]) for t in dec.stream(ids, pv, img, cfg)]
    assert streamed == blocking


def test_refusals(both):
    _, te = engines(both)
    dec = t_spec.SpeculativeDecoder(te)
    with pytest.raises(ValueError, match="mirostat"):
        dec.generate(np.ones((1, 4), np.int64), None, None,
                     t_samp.SamplingConfig(do_sample=True, mirostat_mode=2))
    with pytest.raises(ValueError, match="batch size 1"):
        list(dec.stream(np.ones((2, 4), np.int64), None, None, t_samp.SamplingConfig.greedy(4)))
    with pytest.raises(ValueError, match="spec_k"):
        t_spec.SpeculativeDecoder(te, spec_k=0)


# ---------------------------------------------------------------------------
# speculative sampling
# ---------------------------------------------------------------------------

def test_verify_sampled_marginal_matches_distribution():
    """Accept the draft with probability p(d), else draw from p without d:
    every position's marginal is p.  n rows of the same logits, K = 2; the
    draft is token 1 (p = .30) at position 0, and at position 1 a token of
    p = .10, so both the accept and the resample branch carry mass."""
    n = 20000
    p = np.asarray([0.45, 0.30, 0.15, 0.10], np.float32)
    logits = torch.from_numpy(np.log(p)).expand(n, 3, 4).contiguous()
    drafts = torch.tensor([[1, 3]]).expand(n, 2)
    cfg = t_samp.SamplingConfig(do_sample=True, temperature=1.0, top_k=0, top_p=1.0,
                                repetition_penalty=1.0, no_repeat_ngram_size=0)
    preds = t_spec._verify_sampled(logits, torch.zeros(n, 8, dtype=torch.int64),
                                   torch.zeros(n, dtype=torch.int64), drafts,
                                   torch.Generator().manual_seed(0), cfg)
    for j in range(3):  # position 2 is the bonus draw from the full p
        freq = np.bincount(preds[:, j].numpy(), minlength=4) / n
        sd = np.sqrt(p * (1 - p) / n)
        assert np.all(np.abs(freq - p) <= 5 * sd), (j, freq, p)  # 5 sigma, per token


def test_topk1_sampling_collapses_to_greedy(both):
    """top_k=1 leaves one token with mass: sampled speculation is greedy."""
    ids, _, _, kw, _ = _case(both, "text_only")
    _, te = engines(both)
    greedy = te.generate(ids, None, None, t_samp.SamplingConfig(**kw))
    sampled = t_spec.SpeculativeDecoder(te, spec_k=3).generate(
        ids, None, None, t_samp.SamplingConfig(**dict(kw, do_sample=True, top_k=1)), seed=123)
    assert trimmed(sampled, te.pad_token_id) == trimmed(greedy, te.pad_token_id)


def test_sampled_default_config_is_seeded(both):
    ids, _, _, _, _ = _case(both, "text_only")
    _, te = engines(both)
    dec = t_spec.SpeculativeDecoder(te, spec_k=4)
    cfg = t_samp.SamplingConfig(max_new_tokens=10)  # the reference's sampled default
    out1, out2 = (dec.generate(ids, None, None, cfg, seed=3) for _ in range(2))
    np.testing.assert_array_equal(out1, out2)
    assert 1 <= out1.shape[1] <= 10


# ---------------------------------------------------------------------------
# the chat API
# ---------------------------------------------------------------------------

def test_chat_speculative_matches_blocking(both):
    jm, tm, cfg = both
    pix = pixels(cfg, 5)
    gc = t_samp.SamplingConfig.greedy(max_new_tokens=8)
    plain, _ = t_chat(tm, pix, "ab", [], gc, verbose=False)
    spec, hist = t_chat(tm, pix, "ab", [], gc, verbose=False, speculative=True)
    assert spec == plain
    assert hist[-1] == {"type": "response", "value": spec}
    j_spec, _ = vj.api.chat(jm, pix, "ab", [], j_samp.SamplingConfig.greedy(max_new_tokens=8),
                            verbose=False, speculative=True)
    assert spec == j_spec
    last = ""
    for last, _ in t_chat_in_stream(tm, pix, "ab", [], gc, verbose=False, speculative=True):
        pass
    assert last.lstrip(" ") == plain.lstrip(" ")
    assert tm.speculative_decoder() is tm.speculative_decoder(8, 3)
    # mirostat-2 takes the plain engine, as in the JAX package
    miro = t_samp.SamplingConfig(max_new_tokens=4, mirostat_mode=2)
    assert tm._decoder(miro, True, 8) is tm.engine
