"""Parity of the PyTorch port's ops with the JAX package's, in fp32 on the CPU.

Inputs come from a numpy seed and go through both packages; tolerance
atol 1e-5 (fp32 with a different summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcla_tpu.ops import activations as j_act
from visualcla_tpu.ops import attention as j_attn
from visualcla_tpu.ops import norms as j_norms
from visualcla_tpu.ops import rope as j_rope
from visualcla_tpu_torch.ops import activations as t_act
from visualcla_tpu_torch.ops import attention as t_attn
from visualcla_tpu_torch.ops import norms as t_norms
from visualcla_tpu_torch.ops import rope as t_rope

ATOL = 1e-5


def f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 64)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x, w = f32(rng, *shape), f32(rng, shape[-1])
    close(t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
          j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm(eps):
    rng = np.random.default_rng(1)
    x, w, b = f32(rng, 2, 7, 24), f32(rng, 24), f32(rng, 24)
    close(t_norms.layer_norm(*map(torch.from_numpy, (x, w, b)), eps),
          j_norms.layer_norm(*map(jnp.asarray, (x, w, b)), eps))


def test_rope_table_and_apply():
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 300, (2, 6))
    cos_t, sin_t = t_rope.rope_table(torch.from_numpy(pos), 16, 10000.0)
    cos_j, sin_j = j_rope.rope_table(jnp.asarray(pos, jnp.int32), 16, 10000.0)
    close(cos_t, cos_j)
    close(sin_t, sin_j)
    q, k = f32(rng, 2, 6, 4, 16), f32(rng, 2, 6, 2, 16)
    qt, kt = t_rope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), cos_t, sin_t)
    qj, kj = j_rope.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j.astype(jnp.float32),
                               sin_j.astype(jnp.float32))
    close(qt, qj)
    close(kt, kj)


@pytest.mark.parametrize("name", ["quick_gelu", "gelu", "silu"])
def test_activations(name):
    x = f32(np.random.default_rng(3), 4, 33) * 3
    jfn = {"quick_gelu": j_act.quick_gelu, "gelu": j_act.gelu_exact,
           "silu": j_act.silu}[name]
    close(t_act.ACT2FN[name](torch.from_numpy(x)), jfn(jnp.asarray(x)))


@pytest.mark.parametrize("softmax_dtype", ["fp32", "native"])
@pytest.mark.parametrize("nkv", [4, 2])
def test_dot_product_attention(softmax_dtype, nkv):
    rng = np.random.default_rng(4)
    q, k, v = f32(rng, 2, 5, 4, 8), f32(rng, 2, 9, nkv, 8), f32(rng, 2, 9, nkv, 8)
    close(t_attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                       softmax_dtype=softmax_dtype),
          j_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                       softmax_dtype=softmax_dtype))


def test_causal_bias_and_masked_attention():
    rng = np.random.default_rng(5)
    B, Sq, Sk = 2, 4, 10
    q_pos = np.array([[3, 4, 5, 6], [6, 7, 8, 9]])
    kv_valid = rng.random((B, Sk)) > 0.3
    kv_valid[:, 0] = True
    kv_pos = np.broadcast_to(np.arange(Sk), (B, Sk)).copy()
    bt = t_attn.causal_bias(torch.from_numpy(q_pos), torch.from_numpy(kv_valid),
                            torch.from_numpy(kv_pos))
    bj = j_attn.causal_bias(jnp.asarray(q_pos), jnp.asarray(kv_valid), jnp.asarray(kv_pos))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj, np.float32))
    q, k, v = f32(rng, B, Sq, 2, 8), f32(rng, B, Sk, 2, 8), f32(rng, B, Sk, 2, 8)
    close(t_attn.dot_product_attention(*map(torch.from_numpy, (q, k, v)), bias=bt),
          j_attn.dot_product_attention(*map(jnp.asarray, (q, k, v)), bias=bj))
