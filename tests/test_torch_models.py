"""Parity of the PyTorch port's models and checkpoint I/O with the JAX
package, on the same weights (``params_from_jax``), in fp32 on the CPU.
Tolerance atol 1e-4 (fp32 through a few layers, another summation order)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcla_tpu.checkpoint.serialize import flatten_tree, load_checkpoint, save_checkpoint
from visualcla_tpu.core.config import LlamaConfig, tiny_visualcla_config
from visualcla_tpu.models import clip_vit as j_vit
from visualcla_tpu.models import llama as j_llama
from visualcla_tpu.models import resampler as j_res
from visualcla_tpu.models import visualcla as j_vcla
from visualcla_tpu_torch.checkpoint import serialize as t_ser
from visualcla_tpu_torch.checkpoint.from_jax import params_from_jax
from visualcla_tpu_torch.models import visualcla as t_vcla

ATOL = 1e-4


def build_pair(cfg, seed=0):
    """JAX params and a port model holding the same weights (fp32)."""
    params = j_vcla.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    # non-trivial norms, biases and query embeddings so every leaf matters
    flat = {k: np.asarray(v, np.float32) + (0.1 * rng.standard_normal(v.shape).astype(np.float32)
                                             if v.ndim <= 2 and "embed" not in k else 0)
            for k, v in flatten_tree(params).items()}
    from visualcla_tpu.checkpoint.serialize import unflatten_tree
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), unflatten_tree(flat))
    model = t_vcla.VisualCLAModel(cfg, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(flat, cfg))  # strict: every tensor set
    return jparams, model


@pytest.fixture(scope="module")
def pair():
    return build_pair(tiny_visualcla_config(vocab_size=64))


def pixels(cfg, B, seed=1):
    s = cfg.vision_config.image_size
    return np.random.default_rng(seed).standard_normal((B, 3, s, s)).astype(np.float32)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


def test_vit_forward(pair):
    jp, model = pair
    cfg = model.cfg
    pv = pixels(cfg, 2)
    close(model.vision(torch.from_numpy(pv)),
          j_vit.forward(jp["vision"], cfg.vision_config, jnp.asarray(pv)))


def test_resampler_forward_with_head_mask(pair):
    jp, model = pair
    cfg = model.cfg
    x = np.random.default_rng(2).standard_normal(
        (2, 9, cfg.visual_resampler_config.hidden_size)).astype(np.float32)
    close(model.resampler(torch.from_numpy(x)),
          j_res.forward(jp["resampler"], cfg.visual_resampler_config, jnp.asarray(x)))
    # a pruned head: the JAX head_mask leaf maps onto the port's buffer
    pruned = j_res.prune_heads(jp["resampler"], cfg.visual_resampler_config, {1: [0]})
    model.resampler.head_mask.copy_(torch.from_numpy(np.asarray(pruned["head_mask"], np.float32)))
    try:
        close(model.resampler(torch.from_numpy(x)),
              j_res.forward(pruned, cfg.visual_resampler_config, jnp.asarray(x)))
    finally:
        model.resampler.head_mask.fill_(1.0)


def test_encode_image_and_multimodal_embeds(pair):
    jp, model = pair
    cfg = model.cfg
    pv = pixels(cfg, 2, seed=3)
    close(t_vcla.encode_image(model, cfg, torch.from_numpy(pv)),
          j_vcla.encode_image(jp, cfg, jnp.asarray(pv)))
    T = cfg.num_image_tokens
    ids = np.random.default_rng(4).integers(0, 64, (2, T + 6))
    pos = np.array([2, -1])  # row 1 is text-only
    close(t_vcla.multimodal_embeds(model, cfg, torch.from_numpy(ids), pos, torch.from_numpy(pv)),
          j_vcla.multimodal_embeds(jp, cfg, jnp.asarray(ids), jnp.asarray(pos, jnp.int32),
                                   jnp.asarray(pv)))
    # two images per row, (B, K) marker positions, one unused slot
    ids2 = np.random.default_rng(5).integers(0, 64, (2, 2 * T + 8))
    pos2 = np.array([[0, T + 3], [1, -1]])
    pv2 = np.stack([pv, pv[::-1]], axis=1)
    close(t_vcla.multimodal_embeds(model, cfg, torch.from_numpy(ids2), pos2, torch.from_numpy(pv2)),
          j_vcla.multimodal_embeds(jp, cfg, jnp.asarray(ids2), jnp.asarray(pos2, jnp.int32),
                                   jnp.asarray(pv2)))


@pytest.mark.parametrize("num_kv", [4, 2], ids=["mha", "gqa"])
def test_llama_forward_logits_left_padded(num_kv):
    cfg = tiny_visualcla_config(vocab_size=64)
    cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
        cfg.text_config, num_key_value_heads=num_kv))
    jp, model = build_pair(cfg, seed=6)
    ids = np.random.default_rng(7).integers(0, 64, (2, 11))
    mask = np.ones((2, 11), np.int64)
    mask[1, :4] = 0  # left padding
    got = model.text.forward_logits(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(j_llama.forward_logits(jp["text"], cfg.text_config, jnp.asarray(ids),
                                             jnp.asarray(mask, jnp.int32)), np.float32)
    # pad queries see no valid slot: the kernels' contract gives them zeros,
    # the JAX dense path the mean of V; real positions must agree
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], atol=ATOL, rtol=ATOL)


def test_find_img_start():
    ids = np.array([[5, 9, 3, 9], [1, 2, 3, 4]])
    np.testing.assert_array_equal(t_vcla.find_img_start(ids, 9).numpy(),
                                  np.asarray(j_vcla.find_img_start(jnp.asarray(ids), 9)))
    with pytest.raises(ValueError, match="no room"):
        t_vcla.check_img_start_pos(np.array([5]), 4, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_reader_matches_jax_writer(tmp_path, dtype):
    """The numpy reader loads what the JAX package's save_checkpoint writes;
    the loaded model equals the JAX loader's weights."""
    cfg = tiny_visualcla_config(vocab_size=64)
    params = j_vcla.init_params(jax.random.PRNGKey(8), cfg, jnp.float32)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, params, cfg, dtype=dtype)
    jparams, _ = load_checkpoint(ckpt, dtype=jnp.float32)
    want = {k: np.asarray(v, np.float32) for k, v in flatten_tree(jparams).items()}
    read = t_ser.read_safetensors(os.path.join(ckpt, "params.safetensors"))
    assert set(read) == set(want)
    for k, v in read.items():
        np.testing.assert_array_equal(v.float().numpy(), want[k])
    model, tcfg = t_ser.load_checkpoint(ckpt, device="cpu", dtype=torch.float32)
    assert tcfg == cfg
    state = params_from_jax(want, cfg)
    for name, t in model.state_dict().items():
        if name in state:
            np.testing.assert_array_equal(t.numpy(), state[name].numpy())


def test_checkpoint_writer_roundtrip(tmp_path):
    path = str(tmp_path / "x.safetensors")
    rng = np.random.default_rng(9)
    tensors = {"a/b": torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
               "c": torch.from_numpy(rng.standard_normal(5).astype(np.float32)).bfloat16(),
               "d": torch.arange(6, dtype=torch.int32).reshape(2, 3)}
    t_ser.write_safetensors(path, tensors)
    back = t_ser.read_safetensors(path)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype
        assert torch.equal(back[k], v)
    from safetensors.numpy import load_file  # the official reader agrees
    official = load_file(path)
    np.testing.assert_array_equal(official["a/b"], tensors["a/b"].numpy())


def test_quantized_checkpoint_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="quantized"):
        params_from_jax({"text/layers/q_proj/q": np.zeros((1, 2, 2), np.int8)},
                        tiny_visualcla_config())
    with pytest.raises(NotImplementedError, match="quantized tiers"):
        t_ser.load_checkpoint(str(tmp_path), quantize="int8")


def test_llama_config_rejects_attention_bias():
    from visualcla_tpu_torch.models.llama import Llama

    with pytest.raises(NotImplementedError):
        Llama(LlamaConfig(hidden_size=8, num_attention_heads=2, intermediate_size=8,
                          num_hidden_layers=1, vocab_size=8, attention_bias=True))
