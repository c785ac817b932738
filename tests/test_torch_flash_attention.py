"""The plain versions of the CUDA kernels B1 (decode) and B2 (prefill) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas.py runs them.  fp32, atol 1e-5.  The wrappers given CPU
tensors take the plain version, so they are checked here too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcla_tpu.ops.pallas.flash_attention import flash_attention
from visualcla_tpu_torch.ops import attention as t_attn
from visualcla_tpu_torch.ops.cuda import flash_attention as fa

ATOL = 1e-5
L, B, H, S = 2, 3, 16, 64


def make_case(seed, Sq, N, Nkv, write_slot):
    """Stacked cache with left padding (row 1) and, for row 2, validity that
    starts after row 2's first query: those queries are fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, N, H)).astype(np.float32)
    kc = rng.standard_normal((L, B, Nkv, S, H)).astype(np.float32)
    vc = rng.standard_normal((L, B, Nkv, S, H)).astype(np.float32)
    ws = np.broadcast_to(np.asarray(write_slot), (B,))
    kv_valid = np.zeros((B, S), bool)
    for b in range(B):
        kv_valid[b, : ws[b] + Sq] = True
    kv_valid[1, :5] = False  # left padding
    kv_valid[2, : ws[2] + 1] = False  # row 2's first query sees nothing valid
    return q, kc, vc, kv_valid


def jax_flash(q, kc, vc, kv_valid, write_slot, l):
    return np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv_valid),
        jnp.asarray(write_slot, jnp.int32), causal=True, layer_index=jnp.int32(l),
        interpret=True, block_kv=128), np.float32)


def torch_args(q, kc, vc, kv_valid, write_slot):
    ws = torch.as_tensor(np.asarray(write_slot)) if np.ndim(write_slot) else int(write_slot)
    return (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(kv_valid), ws)


@pytest.mark.parametrize("N,Nkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("write_slot", [0, [0, 7, 20]], ids=["scalar", "per_row"])
def test_prefill_plain_matches_pallas(N, Nkv, write_slot):
    Sq = 24
    q, kc, vc, kv_valid = make_case(10, Sq, N, Nkv, write_slot)
    for l in range(L):
        want = jax_flash(q, kc, vc, kv_valid, write_slot, l)
        args = torch_args(q, kc, vc, kv_valid, write_slot)
        got = fa.flash_prefill_stacked_ref(*args, l).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
        np.testing.assert_array_equal(got[2, 0], 0.0)  # fully masked -> zeros
        np.testing.assert_array_equal(fa.flash_prefill_stacked(*args, l).numpy(), got)


@pytest.mark.parametrize("N,Nkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("write_slot", [40, [40, 33, 63]], ids=["scalar", "per_row"])
def test_decode_plain_matches_pallas(N, Nkv, write_slot):
    q, kc, vc, kv_valid = make_case(11, 1, N, Nkv, write_slot)
    for l in range(L):
        want = jax_flash(q, kc, vc, kv_valid, write_slot, l)
        args = torch_args(q, kc, vc, kv_valid, write_slot)
        got = fa.flash_decode_stacked_ref(*args, l).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
        np.testing.assert_array_equal(got[2], 0.0)
        np.testing.assert_array_equal(fa.flash_decode_stacked(*args, l).numpy(), got)


def test_cached_attention_dispatch_and_counters():
    """cached_attention routes Sq == 1 to B1 and Sq > 1 to B2; on CPU tensors
    the plain versions run and no kernel launch is counted."""
    fa.reset_launch_counts()
    for Sq, ref in ((1, fa.flash_decode_stacked_ref), (6, fa.flash_prefill_stacked_ref)):
        q, kc, vc, kv_valid = make_case(12, Sq, 4, 2, 30)
        args = torch_args(q, kc, vc, kv_valid, 30)
        got = t_attn.cached_attention(*args, layer_index=1)
        np.testing.assert_array_equal(got.numpy(), ref(*args, 1).numpy())
    assert fa.LAUNCHES == {"flash_decode": 0, "flash_prefill": 0}


def test_wrapper_rejects_bad_arguments():
    q, kc, vc, kv_valid = make_case(13, 2, 4, 4, 0)
    args = torch_args(q, kc, vc, kv_valid, 0)
    with pytest.raises(ValueError, match="one query per row"):
        fa.flash_decode_stacked(*args, 0)
    with pytest.raises(ValueError, match="layer_index"):
        fa.flash_prefill_stacked(*args, L)
    with pytest.raises(TypeError, match="differ"):
        fa.flash_prefill_stacked(args[0].double(), *args[1:], 0)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_prefill_stacked(torch.zeros(B, 2, 3, H), *args[1:], 0)
