"""The port's quantization against the JAX package's, on the CPU.

- The quantizers (numpy and torch) produce the JAX package's bytes: compared
  bitwise.
- B3's plain version against the Pallas kernel in interpret mode (as
  tests/test_int4.py runs it) in bf16, atol = rtol = 2e-2 (bf16 rounding of
  the dequantized weight or of the output, another summation order), and
  against the XLA path ``_q_matmul_grouped`` in f32, atol = rtol = 1e-5.
- ``Int8Linear``, ``q_take`` and the int8/int4 heads against their JAX
  counterparts in f32, atol = rtol = 1e-5.
- The int8-K/V plain versions of B1/B2 against the Pallas flash kernel in
  interpret mode, f32, atol = rtol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcla_tpu.models import llama as j_llama
from visualcla_tpu.ops import quantization as jq
from visualcla_tpu.ops.pallas.flash_attention import flash_attention
from visualcla_tpu.ops.pallas.int4_matmul import int4_matmul as j_int4_matmul
from visualcla_tpu_torch.ops import linear as t_linear
from visualcla_tpu_torch.ops import quantization as tq
from visualcla_tpu_torch.ops.cuda import flash_attention as fa
from visualcla_tpu_torch.ops.cuda import int4_matmul as i4

# (in, out, group): a non-power-of-two G (3, 5, 86), odd out widths, and
# in-dims where the group falls back 128 -> 64 -> 32
SHAPES = [(96, 7, 32), (320, 33, 64), (256, 24, 128), (86 * 16, 9, 16)]


def weight(seed, *shape):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.1
    w[..., 0, :] = 0.0  # zero rows and columns: scale 1, not 0
    if len(shape) >= 2:
        w[..., :, 1] = 0.0
    return w


def same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("in_dim", [4096, 11008, 96, 192, 320, 16, 12, 7])
@pytest.mark.parametrize("group", [128, 64])
def test_effective_group(in_dim, group):
    assert tq.effective_group(in_dim, group) == jq.effective_group(in_dim, group)


@pytest.mark.parametrize("shape,axis", [((40, 7), -2), ((3, 16, 9), -2), ((11, 24), -1)])
def test_quantize_int8_bitwise(shape, axis):
    w = weight(0, *shape)
    want = jq.quantize_np(w, axis=axis)
    got = tq.quantize_np(w, axis=axis)
    for k in ("q", "scale"):
        same_bytes(got[k], want[k])
        same_bytes(tq.quantize(torch.from_numpy(w), axis=axis)[k].numpy(), want[k])
    jx = jq.quantize(jnp.asarray(w), axis=axis)
    same_bytes(got["q"], jx["q"])
    same_bytes(got["scale"], jx["scale"])


@pytest.mark.parametrize("in_dim,out,group", SHAPES)
@pytest.mark.parametrize("transposed", [False, True], ids=["contiguous", "transposed"])
def test_quantize_grouped_bitwise(in_dim, out, group, transposed):
    eff = jq.effective_group(in_dim, 128)
    if group == 128:
        group = eff
    w = weight(1, 2, in_dim, out)  # stacked: one leading-axis slice at a time
    want = jq.quantize_grouped_np(w, group=group, bits=4)
    got = tq.quantize_grouped_np(w, group=group)
    for k in ("q", "scale"):
        same_bytes(got[k], want[k])
    for layer in range(2):
        # a torch (out, in) weight seen as (in, out): strided, as from_dense passes it
        wt = (torch.from_numpy(w[layer].T.copy()).t() if transposed
              else torch.from_numpy(w[layer]))
        t = tq.quantize_grouped(wt, group=group)
        assert t["q"].is_contiguous() and t["scale"].is_contiguous()
        same_bytes(t["q"].numpy(), want["q"][layer])
        same_bytes(t["scale"].numpy(), want["scale"][layer])
        jx = jq.quantize_grouped(jnp.asarray(w[layer]), group=group, bits=4)
        same_bytes(t["q"].numpy(), jx["q"])
        same_bytes(t["scale"].numpy(), jx["scale"])
    with pytest.raises(ValueError, match="divisible"):
        tq.quantize_grouped_np(w, group=group + 2)


def test_pack_unpack_s4_bitwise():
    vals = np.random.default_rng(2).integers(-8, 8, (3, 2, 16, 5)).astype(np.int8)
    packed = jq.pack_s4_rows(vals)
    same_bytes(tq.pack_s4_rows(vals), packed)
    same_bytes(tq.pack_s4_rows(torch.from_numpy(vals)).numpy(), packed)
    same_bytes(tq.unpack_s4_rows(packed), jq.unpack_s4_rows(packed))
    same_bytes(tq.unpack_s4_rows(torch.from_numpy(packed)).numpy(), vals)
    with pytest.raises(ValueError, match="even"):
        tq.pack_s4_rows(vals[..., :3, :])


@pytest.mark.parametrize("shape", [(2, 3, 5, 16), (1, 4, 1, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bitwise(shape, dtype):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # a zero row: scale 1
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    jq_, js = jq.quantize_kv(jnp.asarray(xt.float().numpy(), getattr(jnp, dtype)))
    tq_, ts = tq.quantize_kv(xt)
    same_bytes(tq_.numpy(), jq_)
    same_bytes(ts.numpy(), js)
    assert ts[0, 0, 0] == 1.0


# ---------------------------------------------------------------------------
# B3's plain version
# ---------------------------------------------------------------------------

L4, IN4, OUT4, GS4 = 2, 256, 384, 128


@pytest.fixture(scope="module")
def w4():
    wq = jq.quantize_grouped_np(weight(4, L4, IN4, OUT4), group=GS4, bits=4)
    return np.array(wq["q"]), np.array(wq["scale"])


@pytest.mark.parametrize("T", [1, 8, 17, 300], ids=["group1", "group8", "scratch", "tiled"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "unstacked"])
def test_int4_plain_matches_pallas_interpret(w4, T, stacked):
    q, s = w4
    x = np.random.default_rng(5).standard_normal((T, IN4)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for layer in range(L4):
        # the port keeps one carrier per layer; the JAX kernel reads layer
        # ``layer`` of the stacked carrier by index, or an unstacked one
        if stacked:
            want = j_int4_matmul(xj, jnp.asarray(q), jnp.asarray(s), layer, interpret=True)
        else:
            want = j_int4_matmul(xj, jnp.asarray(q[layer]), jnp.asarray(s[layer]), None,
                                 interpret=True)
        ql, sl = torch.from_numpy(q)[layer], torch.from_numpy(s)[layer]
        got = i4.int4_matmul_ref(xt, ql, sl, out_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=2e-2, rtol=2e-2)
        # the wrapper, given CPU tensors, runs the plain version
        wrapped = i4.int4_matmul(xt, ql, sl, out_dtype=torch.float32)
        np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("T", [1, 4, 100], ids=["grouped", "grouped_edge", "dequant"])
@pytest.mark.parametrize("out_dtype", [None, "f32"])
def test_int4_plain_matches_xla_grouped_f32(T, out_dtype):
    # G = 3, gs/2 = 8: up to 8 tokens (2 rows x T) per-group products, more dequantized
    in_dim, out, gs = 48, 11, 16
    wq = jq.quantize_grouped_np(weight(6, in_dim, out), group=gs, bits=4)
    wq = {k: np.array(v) for k, v in wq.items() if k != "bits"}
    x = np.random.default_rng(7).standard_normal((2, T, in_dim)).astype(np.float32)
    want = jq._q_matmul_grouped(jnp.asarray(x, jnp.float32),
                                {"q": jnp.asarray(wq["q"]), "scale": jnp.asarray(wq["scale"])},
                                out_dtype=jnp.float32 if out_dtype else None)
    got = i4.int4_matmul_ref(torch.from_numpy(x), torch.from_numpy(wq["q"]),
                             torch.from_numpy(wq["scale"]),
                             out_dtype=torch.float32 if out_dtype else None)
    assert got.shape == (2, T, out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_int4_wrapper_rejects_bad_arguments(w4):
    q, s = (torch.from_numpy(a)[0] for a in w4)
    x = torch.zeros(2, IN4)
    with pytest.raises(ValueError, match="carrier"):
        i4.int4_matmul(x, torch.from_numpy(w4[0]), torch.from_numpy(w4[1]))  # stacked
    with pytest.raises(ValueError, match="in-dim"):
        i4.int4_matmul(torch.zeros(2, IN4 + 2), q, s)
    with pytest.raises(ValueError, match="carrier"):
        i4.int4_matmul(x, q.to(torch.int8), s)
    with pytest.raises(ValueError, match="scale"):
        i4.int4_matmul(x, q, s[:1])
    i4.reset_launch_counts()
    i4.int4_matmul(x, q, s)
    assert not any(i4.LAUNCHES.values())  # CPU tensors: the plain version, no launch


@pytest.mark.parametrize("T,want", [(1, 1), (2, 2), (3, 3), (8, 8), (16, 16), (300, 64)])
def test_decode_tokens_per_block(T, want):
    assert i4.decode_tokens_per_block(T) == want


# ---------------------------------------------------------------------------
# int8 layers, the int8 table, the quantized heads
# ---------------------------------------------------------------------------

def f32_close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j, np.float32), atol=atol,
                               rtol=atol)


def test_int8_linear_matches_q_matmul():
    w = weight(8, 24, 10)  # (in, out), JAX orientation
    wq = jq.quantize_np(w, axis=-2)
    x = np.random.default_rng(9).standard_normal((2, 3, 24)).astype(np.float32)
    lin = t_linear.Int8Linear.from_dense(torch.from_numpy(w.T.copy()))
    same_bytes(lin.q.numpy(), wq["q"].T)
    same_bytes(lin.scale.numpy(), wq["scale"])
    jw = {"q": jnp.asarray(wq["q"]), "scale": jnp.asarray(wq["scale"])}
    f32_close(lin(torch.from_numpy(x)), jq.q_matmul(jnp.asarray(x), jw))
    # bf16: x @ q in bf16, times the scale rounded to bf16, as the JAX package
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = jq.q_matmul(jnp.asarray(x, jnp.bfloat16), jw)
    np.testing.assert_allclose(lin(xb).float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_q_take_and_int8_table():
    table = weight(10, 13, 6)
    wq = jq.quantize_np(table, axis=-1)
    ids = np.array([[0, 5, 12], [3, 3, 1]])
    want = jq.q_take({"q": jnp.asarray(wq["q"]), "scale": jnp.asarray(wq["scale"])},
                     jnp.asarray(ids))
    got = tq.q_take({"q": torch.from_numpy(wq["q"]), "scale": torch.from_numpy(wq["scale"])},
                    torch.from_numpy(ids))
    same_bytes(got.numpy(), np.asarray(want, np.float32))
    tab = t_linear.Int8Table.from_dense(torch.from_numpy(table))
    same_bytes(tab(torch.from_numpy(ids)).numpy(), np.asarray(want, np.float32))
    dense = torch.from_numpy(table)
    assert torch.equal(tq.q_take(dense, torch.from_numpy(ids)), dense[torch.from_numpy(ids)])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_head_logits_match_jax(bits):
    H, V = 32, 21
    head = weight(11, H, V)
    hidden = np.random.default_rng(12).standard_normal((2, 3, H)).astype(np.float32)
    if bits == 8:
        wq = jq.quantize_np(head, axis=-2)
        mod = t_linear.Int8Linear.from_dense(torch.from_numpy(head.T.copy()))
    else:
        wq = jq.quantize_grouped_np(head, group=16, bits=4)
        mod = t_linear.Int4Linear.from_dense(torch.from_numpy(head.T.copy()), 16)
        same_bytes(mod.q.numpy(), wq["q"])
    jparams = {"lm_head": {"q": jnp.asarray(wq["q"]), "scale": jnp.asarray(wq["scale"])}}
    want = j_llama.logits(jparams, jnp.asarray(hidden))
    got = mod.forward_f32(torch.from_numpy(hidden))
    assert got.dtype == torch.float32
    f32_close(got, want)


def test_make_linear_tiers():
    assert isinstance(t_linear.make_linear(64, 8, "none"), t_linear.Linear)
    assert isinstance(t_linear.make_linear(64, 8, "int8"), t_linear.Int8Linear)
    m = t_linear.make_linear(96, 8, "int4")
    assert isinstance(m, t_linear.Int4Linear) and m.q.shape == (3, 16, 8)
    # no group >= 8 divides 12: per-channel int8, as the JAX loader falls back
    assert isinstance(t_linear.make_linear(12, 8, "int4"), t_linear.Int8Linear)
    with pytest.raises(ValueError, match="quant"):
        t_linear.make_linear(64, 8, "int2")


# ---------------------------------------------------------------------------
# int8 K/V in B1/B2's plain versions
# ---------------------------------------------------------------------------

def kv8_case(seed, Sq, N, Nkv, L=2, B=2, S=48, H=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, N, H)).astype(np.float32)
    k = rng.standard_normal((L, B, Nkv, S, H)).astype(np.float32)
    v = rng.standard_normal((L, B, Nkv, S, H)).astype(np.float32)
    (kq, ks), (vq, vs) = jq.quantize_kv(jnp.asarray(k)), jq.quantize_kv(jnp.asarray(v))
    slot = np.array([20, 27], np.int32)[:B]
    valid = np.arange(S)[None, :] < slot[:, None] + Sq
    valid[1, :4] = False  # left padding
    return q, *(np.array(a) for a in (kq, ks, vq, vs)), valid, slot


@pytest.mark.parametrize("Sq", [1, 9], ids=["decode", "prefill"])
@pytest.mark.parametrize("N,Nkv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_kv8_plain_matches_pallas(Sq, N, Nkv):
    q, kq, ks, vq, vs, valid, slot = kv8_case(13, Sq, N, Nkv)
    plain = fa.flash_decode_stacked_ref if Sq == 1 else fa.flash_prefill_stacked_ref
    wrapper = fa.flash_decode_stacked if Sq == 1 else fa.flash_prefill_stacked
    fa.reset_launch_counts()
    for layer in range(2):
        want = flash_attention(
            jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(valid),
            jnp.asarray(slot), causal=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
            layer_index=jnp.int32(layer), interpret=True, block_kv=16)
        args = (torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
                torch.from_numpy(valid), torch.from_numpy(slot), layer)
        sc = {"k_scale": torch.from_numpy(ks), "v_scale": torch.from_numpy(vs)}
        got = plain(*args, **sc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_array_equal(wrapper(*args, **sc).numpy(), got.numpy())
    assert not any(fa.LAUNCHES.values())


def test_kv8_arguments_are_checked():
    q, kq, ks, vq, vs, valid, slot = kv8_case(14, 1, 4, 4)
    args = (torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
            torch.from_numpy(valid), torch.from_numpy(slot), 0)
    with pytest.raises(ValueError, match="both"):
        fa.flash_decode_stacked(*args, k_scale=torch.from_numpy(ks))
    with pytest.raises(TypeError, match="differ"):
        fa.flash_decode_stacked(*args)  # int8 cache without scales
    with pytest.raises(ValueError, match="k_scale"):
        fa.flash_decode_stacked(*args, k_scale=torch.from_numpy(ks)[:, :1],
                                v_scale=torch.from_numpy(vs))
    dense = (args[0], args[0].new_zeros(kq.shape), args[0].new_zeros(vq.shape)) + args[3:]
    with pytest.raises(TypeError, match="int8"):
        fa.flash_decode_stacked(*dense, k_scale=torch.from_numpy(ks),
                                v_scale=torch.from_numpy(vs))
