"""The chat slice end to end in both packages on one tiny native checkpoint,
in fp32 on the CPU: the same checkpoint goes through both factories, and the
greedy outputs must be token-identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.api import chat as j_chat
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu_torch.api import chat as t_chat
from visualcla_tpu_torch.api import chat_in_stream as t_chat_in_stream
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.ops.cuda import flash_attention as fa


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    ckpt, cfg = make_native_ckpt(str(tmp_path_factory.mktemp("slice")))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    return jm, tm, cfg, ckpt


def pixels(cfg, seed):
    s = cfg.vision_config.image_size
    return np.random.default_rng(seed).standard_normal((1, 3, s, s)).astype(np.float32)


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "text_only"])
def test_greedy_chat_token_identical(both, with_image):
    jm, tm, cfg, _ = both
    pix = pixels(cfg, 1) if with_image else None
    j_gc = j_samp.SamplingConfig.greedy(max_new_tokens=10)
    t_gc = t_samp.SamplingConfig.greedy(max_new_tokens=10)
    j_resp, j_hist = j_chat(jm, pix, "ab你好", [], j_gc, verbose=False)
    t_resp, t_hist = t_chat(tm, pix, "ab你好", [], t_gc, verbose=False)
    assert t_resp == j_resp
    assert t_hist == j_hist
    # a second turn replays the history (image only in the first instruction)
    j_resp2, _ = j_chat(jm, pix, "cd", j_hist, j_gc, verbose=False)
    t_resp2, _ = t_chat(tm, pix, "cd", t_hist, t_gc, verbose=False)
    assert t_resp2 == j_resp2
    from visualcla_tpu.text import encoding_text

    ids = encoding_text([], "ab你好", tm.num_patch, tm.tokenizer)["input_ids"]
    np.testing.assert_array_equal(tm.generate(ids, pixel_values=pix, generation_config=t_gc),
                                  jm.generate(ids, pixel_values=pix, generation_config=j_gc))


def test_chat_in_stream_matches_chat(both):
    _, tm, cfg, _ = both
    pix = pixels(cfg, 2)
    gc = t_samp.SamplingConfig.greedy(max_new_tokens=8)
    blocking, _ = t_chat(tm, pix, "ab", [], gc, verbose=False)
    outs = list(t_chat_in_stream(tm, pix, "ab", [], gc, verbose=False))
    final, hist = outs[-1]
    assert final.lstrip(" ") == blocking.lstrip(" ")
    assert hist[-1]["value"] == final
    ids = tm.engine.generate(np.array([[1, 5, 6, 7]]), sampling=gc)[0]
    streamed = [int(t[0]) for t in tm.engine.stream(np.array([[1, 5, 6, 7]]), sampling=gc)]
    assert streamed == ids.tolist()


def test_batched_left_padded_generate_matches_single_rows(both):
    jm, tm, cfg, _ = both
    pad = tm.tokenizer.pad_token_id
    rows = [np.array([1, 5, 6, 7, 8, 9]), np.array([1, 7, 7])]
    batch = np.full((2, 6), pad)
    for i, r in enumerate(rows):
        batch[i, 6 - len(r):] = r
    gc = t_samp.SamplingConfig.greedy(max_new_tokens=7)
    out = tm.generate(batch, generation_config=gc)
    for i, r in enumerate(rows):
        single = tm.generate(r[None], generation_config=gc)[0]
        np.testing.assert_array_equal(out[i, :len(single)], single)
    np.testing.assert_array_equal(
        out, jm.generate(batch, generation_config=j_samp.SamplingConfig.greedy(max_new_tokens=7)))


def test_sampled_generation_is_seeded(both):
    _, tm, cfg, _ = both
    ids = np.array([[1, 5, 6, 7]])
    gc = t_samp.SamplingConfig(max_new_tokens=6)  # the default sampled config
    a = tm.generate(ids, generation_config=gc, seed=3)
    b = tm.generate(ids, generation_config=gc, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape[0] == 1 and 1 <= a.shape[1] <= 6


@pytest.mark.parametrize("cfg_name", ["default", "min_new_tokens"])
def test_processed_and_warped_logits_match_jax(cfg_name):
    rng = np.random.default_rng(11)
    B, V, T = 3, 97, 20
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    gen_ids = rng.integers(0, 12, (B, T))  # small id range: repeats and n-grams
    gen_ids[1, :8] = np.tile([3, 4], 4)
    gen_len = np.array([0, 9, 20])
    kw = {"no_repeat_ngram_size": 2} if cfg_name == "default" else {
        "min_new_tokens": 5, "no_repeat_ngram_size": 3, "top_k": 0}
    jc, tc = j_samp.SamplingConfig(**kw), t_samp.SamplingConfig(**kw)
    j_args = (jnp.asarray(logits), jnp.asarray(gen_ids, jnp.int32), jnp.asarray(gen_len, jnp.int32))
    t_args = (torch.from_numpy(logits), torch.from_numpy(gen_ids), torch.from_numpy(gen_len))
    for jf, tf in ((j_samp.processed_logits, t_samp.processed_logits),
                   (j_samp.warped_logits, t_samp.warped_logits)):
        want = np.asarray(jf(*j_args, jc), np.float32)
        got = tf(*t_args, tc).numpy()
        np.testing.assert_array_equal(got == t_samp.NEG_INF, want == j_samp.NEG_INF)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_stream_generate_rejects_extra_img_markers(both):
    _, tm, cfg, _ = both
    img = tm.tokenizer.img_start_token_id
    ids = np.array([[1, img, 5, img, 6]])
    pv = np.zeros((1, 1, 3, cfg.vision_config.image_size, cfg.vision_config.image_size),
                  np.float32)
    with pytest.raises(ValueError, match="markers"):
        tm.stream_generate(ids, pv)
    with pytest.raises(ValueError, match="markers"):
        tm.generate(ids, pixel_values=pv)


def test_slice_counts_no_kernel_launch_on_cpu(both):
    """On CPU tensors the wrappers run the plain versions: no launch counted."""
    _, tm, cfg, _ = both
    fa.reset_launch_counts()
    tm.generate(np.array([[1, 5, 6]]), generation_config=t_samp.SamplingConfig.greedy(3))
    assert fa.LAUNCHES == {"flash_decode": 0, "flash_prefill": 0}
