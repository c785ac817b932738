"""The plain reference against the port, at a tiny size on the CPU: the same
seeded weights and inputs through both, in float32.  The port is imported
here only; ``benchmark/reference`` never imports it."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import program, vocab, weights
from benchmark.reference import model as ref_model
from benchmark.reference.preprocess import preprocess
from benchmark.reference.tokenize import Tokenizer
from benchmark.tests.tiny import tiny_config

# float32 on both sides: another summation order only
F32_TOL = 1e-4


def _image(seed):
    return np.random.default_rng(seed).integers(0, 256, (480, 640, 3), dtype=np.uint8)


def _setup(cfg, seed=3):
    w = weights.make(cfg, seed, "cpu", dtype=torch.float32)
    ref = ref_model.Reference(cfg, w)
    model, pcfg = program.build_model(cfg, weights.make(cfg, seed, "cpu", dtype=torch.float32),
                                      "cpu", dtype=torch.float32)
    return ref, model, pcfg


def _prompt(cfg, n_instr, seed):
    V = cfg["text_config"]["vocab_size"]
    alphabet = vocab.instruction_alphabet(V)
    rng = np.random.default_rng(seed)
    text = "".join(rng.choice(alphabet, n_instr))
    tok = Tokenizer(V)
    ids = tok.chat_prompt(text, cfg["visual_resampler_config"]["num_query_tokens"])
    return text, ids, tok.img_start(ids)


@pytest.mark.parametrize("tier", ["bf16", "int4"])
def test_prefill_logits_match_the_port(tier):
    """Teacher-forced logits over a prompt and some tokens: the port's
    ``prefill_forward`` (its int4 tier through ``quantize_text_tower_``)
    against the reference's derivation of the same tier."""
    from visualcla_tpu_torch.models import llama, visualcla

    cfg = tiny_config(weights=tier)
    ref, model, pcfg = _setup(cfg)
    _, ids, img = _prompt(cfg, 20, 0)
    extra = [5, 300, 17, 4000, 9]
    full = ids + extra
    px = preprocess(_image(1), cfg["vision_config"]["image_size"])
    want = ref.logits([{"ids": full, "prompt_len": len(ids), "img_start": img,
                        "pixels": px}])[0]
    S = len(full)
    cache = llama.init_kv_cache(pcfg.text_config, 1, S, torch.float32, device="cpu")
    got, _ = visualcla.prefill_forward(model, pcfg, torch.as_tensor([full]),
                                       torch.ones(1, S, dtype=torch.int64), np.asarray([img]),
                                       torch.as_tensor(px)[None], cache)
    got = got[0, len(ids) - 1:]
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= F32_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_paged_pool_tokens_are_the_references_argmax(kv):
    """Greedy tokens of the port's paged pool (one-shot admission, decode
    through the pool, the int8 pool too) are the reference's argmax at every
    position, with the reference rounding the cache as the pool stores it."""
    from visualcla_tpu_torch.engine.paged import PagedServingEngine

    cfg = tiny_config(kv_cache=kv)
    ref, model, pcfg = _setup(cfg)
    tok = vocab.program_tokenizer(cfg["text_config"]["vocab_size"])
    _, ids, img = _prompt(cfg, 30, 1)
    px = preprocess(_image(2), cfg["vision_config"]["image_size"])
    eng = PagedServingEngine(model, pcfg, eos_token_id=-1, pad_token_id=tok.pad_token_id,
                             pool_size=2, block_size=64, num_blocks=16, max_seq_len=1024,
                             kv_quant="int8" if kv == "int8" else "none")
    n = 12
    eng.prefill_row(0, np.asarray(ids), px[None], img, n,
                    overrides={"do_sample": False, "repetition_penalty": 1.0, "top_k": 0,
                               "top_p": 1.0, "no_repeat_ngram_size": 0, "temperature": 1.0})
    while not eng.snapshot()["finished"][0]:
        eng.step_n(4)
    served = eng.snapshot()["gen_ids"][0][:n].tolist()
    logits = ref.logits([{"ids": ids + served[:-1], "prompt_len": len(ids), "img_start": img,
                          "pixels": px}])[0]
    assert logits.argmax(-1).tolist() == served
    gaps = logits.max(-1).values - logits.gather(1, torch.as_tensor(served)[:, None])[:, 0]
    assert gaps.max().item() <= F32_TOL


def test_quantized_derivations_match_the_ports():
    """int4 grouped weights, the per-row int8 table and the int8 KV rounding:
    the reference's own derivations equal the port's bit for bit."""
    from visualcla_tpu_torch.ops import quantization as q

    g = torch.Generator().manual_seed(0)
    w = torch.randn(384, 256, generator=g) * 0.02
    port = q.dequantize_grouped(**q.quantize_grouped(w.t(), group=128)).t()
    assert torch.equal(ref_model.int4_grouped(w, 128), port)
    d = q.quantize(w, axis=-1)
    assert torch.equal(ref_model.int8_rows(w), d["q"].float() * d["scale"])
    x = torch.randn(3, 5, 4, 128, generator=g)
    xq, s = q.quantize_kv(x)
    assert torch.equal(ref_model.kv_round(x, "int8"), xq.float() * s[..., None])


def test_preprocessing_is_within_one_level_of_the_ports():
    from visualcla_tpu_torch.processor import ImageProcessor

    proc = ImageProcessor(image_size=224)
    for seed in range(3):
        img = _image(seed)
        got = proc(img)["pixel_values"][0]
        want = preprocess(img, 224)
        # one 8-bit level over CLIP's smallest deviation
        assert np.abs(got - want).max() <= 1.0001 / 255 / 0.26130258
        assert (np.abs(got - want) > 1e-5).mean() < 1e-3


def test_prompt_ids_match_the_ports():
    from visualcla_tpu_torch.text.prompt import encoding_text

    for V in (102400, 32768):
        tok = vocab.program_tokenizer(V)
        ref = Tokenizer(V)
        alphabet = vocab.instruction_alphabet(V)
        rng = np.random.default_rng(V)
        for n in (8, 48, 256):
            text = "".join(rng.choice(alphabet, n))
            want = encoding_text([], text, 64, tok)["input_ids"][0].tolist()
            assert ref.chat_prompt(text, 64) == want
        mixed = "Abc 图片里 " + "".join(chr(0x4E00 + i) for i in range(12)) + " é!"
        assert ref.encode(mixed) == tok.encode(mixed)


def _port_processed(logits, generated, config):
    """The port's own processors, one position at a time, over the tokens
    generated before it."""
    from visualcla_tpu_torch.engine import sampling as ps

    rows = []
    for i in range(len(logits)):
        gen = torch.as_tensor([generated[:i] + [0] * (len(generated) - i)])
        x = logits[i:i + 1]
        valid = torch.arange(gen.shape[1])[None] < i
        x = ps.apply_repetition_penalty(x, gen, valid, config["repetition_penalty"])
        x = ps.apply_no_repeat_ngram(x, gen, torch.tensor([i]), config["no_repeat_ngram_size"])
        rows.append(x)
    x = torch.cat(rows)
    return x.masked_fill(x <= torch.finfo(x.dtype).min, float("-inf"))  # its ban's fill


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_sampler_reference_keeps_what_the_port_s_sampler_may_draw(seed):
    """Penalty and n-gram ban as the port applies them, on a generated run
    that repeats itself (so that the ban has work); the kept set that of the
    port's temperature, top-k and top-p warpers; a greedy request keeps its
    best token alone."""
    from benchmark.reference import sampling as rs
    from visualcla_tpu_torch.engine import sampling as ps

    g = torch.Generator().manual_seed(seed)
    n, V = 40, 300
    logits = torch.randn(n, V, generator=g) * 2
    base = torch.randint(0, V, (8,), generator=g).tolist()
    generated = (base * 6)[:n]
    config = {"do_sample": True, "temperature": 0.5, "top_k": 40, "top_p": 0.9,
              "repetition_penalty": 1.1, "no_repeat_ngram_size": 5}
    proc = rs.processed(logits, generated, config)
    assert torch.equal(proc, _port_processed(logits, generated, config))
    assert bool(torch.isinf(proc).any())  # the ban bit
    warped = ps.warp_top_p(ps.warp_top_k(ps.warp_temperature(proc, 0.5), 40), 0.9)
    want = warped > torch.finfo(warped.dtype).min  # the port masks with the least float
    assert 1 <= int(want.sum(-1).min()) and int(want.sum(-1).max()) <= 40
    assert torch.equal(rs.kept(proc, config), want)
    greedy = {"do_sample": False, "repetition_penalty": 1.0, "no_repeat_ngram_size": 0}
    assert torch.equal(rs.processed(logits, generated, greedy), logits)
    best = rs.kept(logits, greedy)
    assert torch.equal(best.sum(-1), torch.ones(n, dtype=torch.long))
    assert torch.equal(best.float().argmax(-1), logits.argmax(-1))


def test_ngram_repeats():
    from benchmark.reference.sampling import ngram_repeats

    assert ngram_repeats([1, 2, 3, 1, 2, 4], 2) == 1
    assert ngram_repeats([1, 2, 3, 1, 2, 4], 3) == 0
    assert ngram_repeats([5] * 20, 15) == 5
    assert ngram_repeats([1, 2, 1, 2], 0) == 0
