"""The plain versions of the CUDA kernels B1 (decode), B2 (prefill) and B2u
(unstacked K/V, causal or not) against the JAX package's Pallas kernels, run
in interpret mode on the CPU as tests/test_pallas.py runs them.  fp32, atol
1e-5.  The wrappers given CPU tensors take the plain version, so they are
checked here too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcla_tpu.ops import attention as j_attn
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
    assert set(fa.LAUNCHES) >= {"flash_decode", "flash_prefill"}
    assert not any(fa.LAUNCHES.values()), fa.LAUNCHES


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


def full_case(seed, layout, Sq, Skv, N, Nkv, hd, kv8):
    """Unstacked K/V in ``layout`` with holes in kv_valid and a fully masked
    last row; int8 K/V with per-(row, slot, head) scales in the layout's order."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, N, hd)).astype(np.float32)
    shape = (B, Skv, Nkv, hd) if layout == "bsnh" else (B, Nkv, Skv, hd)
    kv_valid = rng.random((B, Skv)) > 0.25
    kv_valid[-1] = False
    if not kv8:
        k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        return q, k, v, kv_valid, {}
    k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.03, shape[:3]).astype(np.float32) for _ in range(2))
    return q, k, v, kv_valid, {"k_scale": ks, "v_scale": vs}


@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("N,Nkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("layout,causal", [("bsnh", False), ("bnsh", True), ("bsnh", True),
                                           ("bnsh", False)])
def test_full_plain_matches_pallas(layout, causal, N, Nkv, kv8):
    """B2u: odd lengths (Sq 37, Skv 45), hd 64, per-row slots, GQA, int8
    scales; the fully masked row gives zeros."""
    Sq, Skv = 37, 45
    q, k, v, kv_valid, sc = full_case(20, layout, Sq, Skv, N, Nkv, 64, kv8)
    write_slot = np.array([0, 4, 8], np.int32)
    want = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_valid),
        jnp.asarray(write_slot), causal=causal, kv_layout=layout, interpret=True,
        **{n: jnp.asarray(a) for n, a in sc.items()}), np.float32)
    targs = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             torch.from_numpy(kv_valid), torch.from_numpy(write_slot))
    tsc = {n: torch.from_numpy(a) for n, a in sc.items()}
    got = fa.flash_attention_ref(*targs, causal=causal, kv_layout=layout, **tsc).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(got[-1], 0.0)
    np.testing.assert_array_equal(
        fa.flash_attention(*targs, causal=causal, kv_layout=layout, **tsc).numpy(), got)


@pytest.mark.parametrize("Sq", [1, 6], ids=["decode", "prefill"])
@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
def test_unstacked_cached_attention_matches_jax(Sq, kv8):
    """``cached_attention(layer_index=None)`` over one layer's bnsh K/V (B1
    for Sq == 1, B2u causal above) against the JAX package's flash form."""
    q, k, v, kv_valid, sc = full_case(21, "bnsh", Sq, 40, 4, 2, 16, kv8)
    kv_valid[:, 30:] = False  # the unwritten tail
    kv_valid[-1, :2] = True
    write_slot = np.array([25, 29, 20], np.int32) if Sq > 1 else np.array([29, 20, 3], np.int32)
    want = np.asarray(j_attn.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_valid),
        jnp.asarray(write_slot), impl="flash", **{n: jnp.asarray(a) for n, a in sc.items()}),
        np.float32)
    fa.reset_launch_counts()
    got = t_attn.cached_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_valid), torch.from_numpy(write_slot),
        **{n: torch.from_numpy(a) for n, a in sc.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    assert not any(fa.LAUNCHES.values())
    ref = t_attn.cached_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_valid), torch.from_numpy(write_slot),
        **{n: torch.from_numpy(a) for n, a in sc.items()}).numpy()
    np.testing.assert_array_equal(ref, got)


def test_full_wrapper_rejects_bad_arguments():
    q, k, v, kv_valid, _ = full_case(22, "bsnh", 5, 9, 4, 2, 8, False)
    args = [torch.from_numpy(a) for a in (q, k, v, kv_valid)]
    with pytest.raises(ValueError, match="kv_layout"):
        fa.flash_attention(*args, 0, kv_layout="sbnh")
    with pytest.raises(ValueError, match="kv_valid"):
        fa.flash_attention(*args[:3], args[3][:, :4], 0)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(torch.zeros(B, 5, 3, 8), *args[1:], 0)
    with pytest.raises(TypeError, match="int8"):
        fa.flash_attention(*args, 0, k_scale=torch.ones(B, 9, 2), v_scale=torch.ones(B, 9, 2))


# ---------------------------------------------------------------------------
# the shapes the card's kernels are held against their plain versions at:
# here the plain versions are held against the Pallas kernels at those shapes
# ---------------------------------------------------------------------------

def stacked_case(seed, Bc, Sq, N, Nkv, hd, Sc, slots, kv8, dead_row=None):
    """A stacked cache of ``Sc`` slots, queries of row b at slots[b] .. + Sq,
    ragged left padding, optionally a row that sees nothing, optionally int8
    K/V with (L, B, Nkv, S) scales."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bc, Sq, N, hd)).astype(np.float32)
    kv_valid = np.arange(Sc)[None, :] < (np.asarray(slots)[:, None] + Sq)
    for b in range(Bc):
        kv_valid[b, :b + 2] = False
    if dead_row is not None:
        kv_valid[dead_row] = False
    shape = (L, Bc, Nkv, Sc, hd)
    if not kv8:
        kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
        return q, kc, vc, kv_valid, {}
    kc, vc = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.03, shape[:4]).astype(np.float32) for _ in range(2))
    return q, kc, vc, kv_valid, {"k_scale": ks, "v_scale": vs}


def jax_stacked(q, kc, vc, kv_valid, slots, l, sc):
    return np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kv_valid),
        jnp.asarray(slots, jnp.int32), causal=True, layer_index=jnp.int32(l), interpret=True,
        block_kv=128, **{n: jnp.asarray(a) for n, a in sc.items()}), np.float32)


@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("N,Nkv,hd", [(4, 4, 128), (8, 2, 128), (4, 4, 64)],
                         ids=["mha", "gqa4", "hd64"])
@pytest.mark.parametrize("Sq", [5, 9])
def test_verify_shapes_plain_matches_pallas(Sq, N, Nkv, hd, kv8):
    """B2 at the speculative verify's shapes: Sq 5 and 9 at per-row slots
    (one row starts at slot 0, one sees nothing), MHA, N / Nkv = 4, hd 64,
    float and int8 K/V.  fp32, atol = rtol = 1e-5 (another summation order)."""
    slots = [100, 0, 37]
    q, kc, vc, kv_valid, sc = stacked_case(30 + Sq, 3, Sq, N, Nkv, hd, 128, slots, kv8,
                                           dead_row=2)
    want = jax_stacked(q, kc, vc, kv_valid, slots, 1, sc)
    tsc = {n: torch.from_numpy(a) for n, a in sc.items()}
    got = fa.flash_prefill_stacked_ref(*torch_args(q, kc, vc, kv_valid, slots), 1, **tsc).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(got[2], 0.0)  # the row that sees nothing
    np.testing.assert_array_equal(
        fa.flash_prefill_stacked(*torch_args(q, kc, vc, kv_valid, slots), 1, **tsc).numpy(), got)


@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("N,Nkv,hd", [(4, 4, 128), (8, 2, 128), (4, 4, 64)],
                         ids=["mha", "gqa4", "hd64"])
def test_decode_shapes_plain_matches_pallas(N, Nkv, hd, kv8):
    """B1 at the split-KV kernel's cases: rows whose slot lies in the first
    run of 128 slots, in a later one, at the end of the cache, a row with a
    negative slot and a row with nothing valid (both zeros), MHA, N / Nkv = 4
    and hd 64, float and int8 K/V.  fp32, atol = rtol = 1e-5."""
    slots = [40, 300, 383, -1, 200]
    q, kc, vc, kv_valid, sc = stacked_case(40, 5, 1, N, Nkv, hd, 384, slots, kv8, dead_row=4)
    want = jax_stacked(q, kc, vc, kv_valid, slots, 0, sc)
    tsc = {n: torch.from_numpy(a) for n, a in sc.items()}
    got = fa.flash_decode_stacked_ref(*torch_args(q, kc, vc, kv_valid, slots), 0, **tsc).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(got[3:], 0.0)
    np.testing.assert_array_equal(
        fa.flash_decode_stacked(*torch_args(q, kc, vc, kv_valid, slots), 0, **tsc).numpy(), got)


@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("layout", ["bsnh", "bnsh"])
def test_vit_shape_plain_matches_pallas(layout, kv8):
    """B2u at the ViT's token count: 257 queries over 257 slots (no multiple
    of any tile), causal off, hd 64, a fully masked last row.  fp32, atol =
    rtol = 1e-5."""
    q, k, v, kv_valid, sc = full_case(50, layout, 257, 257, 4, 4, 64, kv8)
    zero = np.zeros(B, np.int32)
    want = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_valid),
        jnp.asarray(zero), causal=False, kv_layout=layout, interpret=True,
        **{n: jnp.asarray(a) for n, a in sc.items()}), np.float32)
    tsc = {n: torch.from_numpy(a) for n, a in sc.items()}
    got = fa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(kv_valid), 0, causal=False, kv_layout=layout,
                                 **tsc).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(got[-1], 0.0)
