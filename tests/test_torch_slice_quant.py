"""The quantized chat tiers end to end in both packages on one tiny native
checkpoint, in fp32 on the CPU: ``load_in_8bit``, ``load_in_4bit`` and
``load_in_4bit`` + ``kv_quant="int8"`` (and the int8 cache alone) through
both factories; greedy outputs must be token-identical, and the weights the
two loaders quantize must be the same bytes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from tests.test_torch_host import port_config
from visualcla_tpu.api import chat as j_chat
from visualcla_tpu.checkpoint.serialize import flatten_tree
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu_torch.text import encoding_text
from visualcla_tpu_torch.api import chat as t_chat
from visualcla_tpu_torch.api import chat_in_stream as t_chat_in_stream
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.ops import linear as t_linear
from visualcla_tpu_torch.ops.cuda import flash_attention as fa
from visualcla_tpu_torch.ops.cuda import int4_matmul as i4

TIERS = {"int8": {"load_in_8bit": True}, "int4": {"load_in_4bit": True},
         "int4_kv8": {"load_in_4bit": True, "kv_quant": "int8"},
         "kv8": {"kv_quant": "int8"}}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return make_native_ckpt(str(tmp_path_factory.mktemp("slice_quant")))


@pytest.fixture(scope="module")
def pairs(ckpt):
    path, _ = ckpt
    out = {}
    for name, kw in TIERS.items():
        jm, _, _ = vj.get_model_and_tokenizer_and_processor(
            visualcla_model=path, dtype=jnp.float32, max_seq_len=256, **kw)
        tm, _, _ = vt.get_model_and_tokenizer_and_processor(
            visualcla_model=path, dtype=torch.float32, device="cpu", max_seq_len=256, **kw)
        out[name] = (jm, tm)
    return out


def pixels(cfg, seed):
    s = cfg.vision_config.image_size
    return np.random.default_rng(seed).standard_normal((1, 3, s, s)).astype(np.float32)


@pytest.mark.parametrize("tier", list(TIERS))
def test_quantized_greedy_chat_token_identical(pairs, ckpt, tier):
    jm, tm = pairs[tier]
    cfg = ckpt[1]
    pix = pixels(cfg, 1)
    j_gc = j_samp.SamplingConfig.greedy(max_new_tokens=10)
    t_gc = t_samp.SamplingConfig.greedy(max_new_tokens=10)
    j_resp, j_hist = j_chat(jm, pix, "ab你好", [], j_gc, verbose=False)
    t_resp, t_hist = t_chat(tm, pix, "ab你好", [], t_gc, verbose=False)
    assert t_resp == j_resp and t_hist == j_hist
    for text, p in (("ab你好", pix), ("cd图片", None)):
        ids = encoding_text([], text, tm.num_patch, tm.tokenizer)["input_ids"]
        np.testing.assert_array_equal(
            tm.generate(ids, pixel_values=p, generation_config=t_gc),
            jm.generate(ids, pixel_values=p, generation_config=j_gc))


@pytest.mark.parametrize("tier", list(TIERS))
def test_quantized_text_logits_match(pairs, ckpt, tier):
    """The text tower's logits over a left-padded batch in both packages, on
    the tier's weights and cache, atol 1e-4 (fp32 through two layers,
    another summation order)."""
    from visualcla_tpu.models import llama as j_llama

    jm, tm = pairs[tier]
    kv_quant = TIERS[tier].get("kv_quant", "none")
    cfg = ckpt[1].text_config
    ids = np.array([[1, 5, 6, 7, 8, 9, 10], [0, 0, 1, 7, 7, 3, 4]])
    mask = (np.arange(7)[None] >= np.array([[0], [2]])).astype(np.int32)
    params = jm.params["text"]
    cache = j_llama.init_kv_cache(cfg, 2, 7, jnp.float32, kv_quant=kv_quant)
    positions = np.maximum(np.cumsum(mask, -1) - 1, 0).astype(np.int32)
    h, _ = j_llama.forward(params, cfg, j_llama.embed(params, jnp.asarray(ids)),
                           jnp.asarray(positions), cache, jnp.asarray(mask, bool),
                           jnp.int32(0))
    want = np.asarray(j_llama.logits(params, h))
    got = tm.model.text.forward_logits(torch.from_numpy(ids), torch.from_numpy(mask),
                                       kv_quant=kv_quant)
    assert got.dtype == torch.float32
    # real positions only: the JAX dense path gives a fully masked (pad)
    # query the mean of V, the port's attention zeros
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], want[real], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_host_quantized_weights_are_the_jax_bytes(pairs, tier):
    """Both loaders quantize the checkpoint on the host: the port's module
    tensors hold the JAX package's quantized leaves byte for byte."""
    jm, tm = pairs[tier]
    flat = flatten_tree(jm.params)
    text = tm.model.text
    n_int4 = 0
    for l, layer in enumerate(text.layers):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                     "down_proj"):
            mod = getattr(layer, name)
            jq = np.asarray(flat[f"text/layers/{name}/q"])[l]
            js = np.asarray(flat[f"text/layers/{name}/scale"])[l]
            if isinstance(mod, t_linear.Int4Linear):
                n_int4 += 1
                np.testing.assert_array_equal(mod.q.numpy(), jq)
            else:
                assert isinstance(mod, t_linear.Int8Linear)
                np.testing.assert_array_equal(mod.q.numpy(), jq.T)
            np.testing.assert_array_equal(mod.scale.numpy(), js)
    assert (n_int4 > 0) == (tier == "int4")
    assert isinstance(text.embed_tokens, t_linear.Int8Table)
    np.testing.assert_array_equal(text.embed_tokens.q.numpy(),
                                  np.asarray(flat["text/embed_tokens/q"]))
    np.testing.assert_array_equal(text.embed_tokens.scale.numpy(),
                                  np.asarray(flat["text/embed_tokens/scale"]))
    # the rest of the model stays dense and in the requested dtype
    assert tm.model.vision.patch_embedding.weight.dtype == torch.float32
    assert text.final_norm.weight.dtype == torch.float32


def test_from_jax_round_trip_of_quantized_leaves(pairs, ckpt):
    """The JAX package's quantized parameter tree (int4 + int8 leaves) handed
    to the port's ``VisualCLA``: the same weights, the same greedy tokens."""
    jm, tm = pairs["int4_kv8"]
    flat = {k: np.asarray(v) for k, v in flatten_tree(jm.params).items()}
    bundle = vt.VisualCLA(flat, port_config(ckpt[1]), tm.tokenizer, tm.image_processor,
                          dtype=torch.float32, device="cpu", max_seq_len=256,
                          kv_quant="int8")
    assert isinstance(bundle.model.text.lm_head, t_linear.Int4Linear)
    ref_state = tm.model.state_dict()
    for name, t in bundle.model.state_dict().items():
        assert torch.equal(t, ref_state[name]), name
    gc = t_samp.SamplingConfig.greedy(max_new_tokens=6)
    ids = np.array([[1, 5, 6, 7]])
    np.testing.assert_array_equal(
        bundle.generate(ids, generation_config=gc),
        jm.generate(ids, generation_config=j_samp.SamplingConfig.greedy(max_new_tokens=6)))


def test_int4_kv8_stream_and_counters(pairs, ckpt):
    """chat_in_stream equals chat; the stream's ids equal generate's; on CPU
    tensors no kernel launch is counted; the cache is int8 with scales."""
    _, tm = pairs["int4_kv8"]
    pix = pixels(ckpt[1], 2)
    gc = t_samp.SamplingConfig.greedy(max_new_tokens=8)
    fa.reset_launch_counts()
    i4.reset_launch_counts()
    blocking, _ = t_chat(tm, pix, "ab", [], gc, verbose=False)
    final, hist = list(t_chat_in_stream(tm, pix, "ab", [], gc, verbose=False))[-1]
    assert final.lstrip(" ") == blocking.lstrip(" ") and hist[-1]["value"] == final
    ids = tm.engine.generate(np.array([[1, 5, 6, 7]]), sampling=gc)[0]
    streamed = [int(t[0]) for t in tm.engine.stream(np.array([[1, 5, 6, 7]]), sampling=gc)]
    assert streamed == ids.tolist()
    assert not any(fa.LAUNCHES.values()) and not any(i4.LAUNCHES.values())
    state = tm.engine.start(np.array([[1, 5, 6]]), None, None, gc)
    cache = state.cache
    assert cache["k"].dtype == torch.int8 and cache["v_scale"].dtype == torch.float32
    assert cache["k_scale"].shape == cache["k"].shape[:-1]
    # slots past the prompt keep their initial scale of one
    assert bool((cache["k_scale"][:, :, :, state.cur_slot:] == 1).all())
