"""The split-KV structure of the paged kernels B5 (verify) and B6 (decode
without an append), and the numerics of B3's prefill form, on the CPU.

The CUDA kernels run only on the card; what they do beyond the plain
versions' arithmetic is held here in plain PyTorch:
- B5 split + ordered combine: an fp32 emulation (this file only) cuts each
  row's context into runs of ``run`` slots, takes every slot from the base
  ``lens - Sq`` on from ``k_new`` / ``v_new`` (and their scales), never from
  the pool, merges the runs' partials (m, l, acc) in split order, and is held
  against ``paged_verify_attention_ref`` (append, then attention over the
  pool).  Tolerance 1e-5 on f32 pools (another summation order only);
  one bf16 step (2e-2) on bf16 and int8 pools, where p is rounded to bf16
  against another running max.
- The split count is a function of the table's width alone.
- B3's choice of form: the decode form for few tokens, the prefill form for
  many, changing once as the token count grows.
- B3's prefill form dequantizes each nibble as (0x4B0000nn as a float) -
  (2^23 + 8), times its scale in fp32, rounded once to bf16: bitwise the
  plain version's dequantized weight.
- B4 split + ordered combine + analytic new-token term + append at blk /
  off: an fp32 emulation over the lens - 1 old slots, held against
  ``paged_append_attention_ref`` (outputs, and the pools bitwise) and the
  Pallas B4 in interpret mode; f32 pools 1e-5, bf16 and int8 pools one bf16
  step (2e-2).
- B3's decode form: each group's dot over the exact nibbles in fp32, times
  its scale, the groups summed in the kernel's fixed order (a split's groups
  in turn, the splits in order), held against
  ``int4_matmul_ref`` and the JAX ``int4_matmul`` (interpret mode) within
  chip_smoke.py's B3 tolerance; the nibble-to-bf16 trick the kernel uses is
  exact; the splits depend on the weight's shape alone.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualcla_tpu.ops.pallas.int4_matmul import int4_matmul as j_int4_matmul
from visualcla_tpu.ops.pallas.paged_attention import paged_append_attention as j_b4
from visualcla_tpu_torch.fixtures import paged_case, paged_verify_case
from visualcla_tpu_torch.ops.cuda import int4_matmul as i4
from visualcla_tpu_torch.ops.cuda import paged_attention as pa
from visualcla_tpu_torch.ops.quantization import (dequantize_grouped, quantize_grouped,
                                                  unpack_s4_halves)

NEG_INF = -1e30


def split_verify_emulation(q, k_new, v_new, k_pool, v_pool, tables, lens, layer,
                           k_new_scales=None, v_new_scales=None, k_scales=None,
                           v_scales=None, *, run):
    """B5's split kernel and combine in fp32: (B, Sq, N, hd) in q's dtype.
    Reads the pools only below each row's base; writes nothing."""
    B, Sq, N, hd = q.shape
    Nkv = k_new.shape[2]
    rep = N // Nkv
    R = rep * Sq
    BS = k_pool.shape[2]
    width = tables.shape[1] * BS
    int8 = k_pool.dtype == torch.int8
    cdt = torch.bfloat16 if int8 else k_pool.dtype

    def rnd(x):
        return x.to(cdt).float()

    out = torch.zeros(B, Sq, N, hd)
    for b in range(B):
        length = int(lens[b])
        base, ctx = length - Sq, min(length, width)
        j = torch.arange(ctx)
        blk, off = tables[b, j // BS].long(), j % BS
        new = j >= base
        k = k_pool[layer, blk, off].reshape(ctx, Nkv, hd).float()
        v = v_pool[layer, blk, off].reshape(ctx, Nkv, hd).float()
        k[new] = k_new[b, j[new] - base].float()
        v[new] = v_new[b, j[new] - base].float()
        ks = torch.ones(ctx, Nkv)
        vs = torch.ones(ctx, Nkv)
        if int8:
            ks, vs = k_scales[layer, blk, off].clone(), v_scales[layer, blk, off].clone()
            ks[new] = k_new_scales[b, j[new] - base]
            vs[new] = v_new_scales[b, j[new] - base]
        qs = rnd(q[b].float() / math.sqrt(hd))  # (Sq, N, hd)
        see = base + torch.arange(R) // rep  # row r = query r // rep of head r % rep
        for g in range(Nkv):
            Q = qs[:, g * rep:(g + 1) * rep].reshape(R, hd)
            parts = []
            for split in range(pa.split_count(width, run)):
                j0 = split * run
                if j0 >= ctx:  # a split past the row's context leaves at once
                    break
                sl = slice(j0, min(ctx, j0 + run))
                s = (Q @ k[sl, g].T) * ks[sl, g][None]
                seen = torch.arange(j0, sl.stop)[None] <= see[:, None]
                s = torch.where(seen, s, torch.full_like(s, NEG_INF))
                m = s.amax(-1)
                p = torch.where(seen, torch.exp(s - m[:, None]), torch.zeros_like(s))
                parts.append((m, p.sum(-1), rnd(p * vs[sl, g][None]) @ v[sl, g]))
            m_all = torch.stack([m for m, _, _ in parts]).amax(0)
            l_all, acc = torch.zeros(R), torch.zeros(R, hd)
            for m, l, a in parts:  # in split order
                c = torch.exp(m - m_all)
                l_all = l_all + l * c
                acc = acc + a * c[:, None]
            o = acc / torch.where(l_all == 0, torch.ones_like(l_all), l_all)[:, None]
            out[b, :, g * rep:(g + 1) * rep] = o.reshape(Sq, rep, hd)
    return out.to(q.dtype)


CASES = {  # ctx lens (-1: a parked row), Sq, N, Nkv, table blocks (None: what the rows need)
    "ragged_parked": ([318, 383, 130, -1], 5, 4, 4, None),
    "gqa_block_edge": ([62, 700, -1], 9, 8, 2, None),
    "past_the_table": ([2 * 16 - 3, 40], 5, 4, 2, 2),
}
POOLS = {"f32": (torch.float32, False, 1e-5), "bf16": (torch.bfloat16, False, 2e-2),
         "int8": (torch.float32, True, 2e-2)}


@pytest.mark.parametrize("run", [64, 128, 256])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("case", list(CASES))
def test_split_verify_emulation_matches_plain(case, pool, run):
    ctx, Sq, N, Nkv, width = CASES[case]
    dtype, kv_int8, tol = POOLS[pool]
    BS = 16 if case == "past_the_table" else 64
    args = paged_verify_case(ctx, Sq, N, Nkv, hd=32, block_size=BS, dtype=dtype,
                             kv_int8=kv_int8, seed=len(ctx) + Sq)
    if width is not None:  # row 0's last new tokens run past its table
        args["tables"] = args["tables"][:, :width].contiguous()
    got = split_verify_emulation(**args, run=run)  # before the plain version appends
    want = pa.paged_verify_attention_ref(**args)
    rows = [b for b, c in enumerate(ctx) if c >= 0]
    torch.testing.assert_close(got[rows].float(), want[rows].float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("width", [64, 448, 2048, 4096])
@pytest.mark.parametrize("run", [64, 128, 256])
def test_split_count_depends_on_the_table_width_alone(width, run):
    """The partials' scratch holds one split a run of the table, however many
    slots the rows use (``lens`` is no argument): enough runs to cover the
    table, none wholly past it."""

    class Lib:  # the library's run length, without a card
        @staticmethod
        def vcla_paged_run():
            return run

    scratch = pa._split_scratch(Lib, 3, 2, 10, width, 32, "cpu")
    B, Nkv, rows, splits, entry = scratch.shape
    assert (B, Nkv, rows, entry) == (3, 2, 10, 34)
    assert (splits - 1) * run < width <= splits * run


def _dequant_like_the_kernel(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """B3 prefill's dequantization in numpy: low nibbles are W rows [0, gs/2)
    of a group, high nibbles rows [gs/2, gs); nibble + 8 as the low byte of
    2^23 gives the float nibble exactly."""
    b = q.numpy().astype(np.uint32)
    s = scale.numpy()[:, None, :]
    halves = []
    for shift in (0, 4):
        biased = ((b >> shift) & 0xF) ^ 0x8
        f = (np.uint32(0x4B000000) | biased).view(np.float32) - np.float32(8388616.0)
        halves.append(torch.from_numpy(np.multiply(f, s, dtype=np.float32)))
    w = torch.cat(halves, dim=1)  # (G, gs, out) fp32
    return w.reshape(-1, w.shape[-1]).to(torch.bfloat16)


@pytest.mark.parametrize("gs", [64, 128, 192])
def test_int4_prefill_dequant_is_the_plain_weight(gs):
    g = torch.Generator().manual_seed(gs)
    w = (torch.randn(2 * gs, 40, generator=g) * 0.02).to(torch.bfloat16)
    wq = quantize_grouped(w, group=gs)
    got = _dequant_like_the_kernel(wq["q"], wq["scale"])
    assert torch.equal(got, dequantize_grouped(wq["q"], wq["scale"], torch.bfloat16))


@pytest.mark.parametrize("T,out", [(25, 4096), (130, 11008), (512, 4096), (512, 11008),
                                   (70, 250)])
def test_int4_prefill_tiling_is_one_the_kernel_has(T, out):
    tile = i4.prefill_tiling(T, out, 132)
    assert tile in i4.PREFILL_TILES
    # no tiling whose blocks all fit one wave is passed over for a taller one
    # that does not
    rows = i4.PREFILL_TILES[tile]
    assert -(-T // rows) * -(-out // 128) <= 132 or all(
        -(-T // r) * -(-out // 128) > 132 for r in i4.PREFILL_TILES.values() if r < rows)


@pytest.mark.parametrize("in_dim,out", [(4096, 4096), (4096, 11008), (11008, 4096),
                                        (4096, 49958), (5120, 13824), (4096, 32000)])
@pytest.mark.parametrize("sms", [132, 114])
def test_int4_form_changes_once_from_decode_to_prefill(in_dim, out, sms):
    picks = [i4.decode_form(T, in_dim, out, sms) for T in range(1, 1025)]
    assert picks[0] and not picks[-1]
    assert sum(a != b for a, b in zip(picks, picks[1:])) == 1


@pytest.mark.parametrize("T,in_dim,out,decode", [
    (8, 4096, 4096, True), (16, 4096, 4096, True), (25, 4096, 4096, True),  # q/k/v/o
    (4, 4096, 11008, True), (8, 4096, 11008, True), (9, 4096, 11008, True),  # gate/up
    (8, 4096, 49958, True), (9, 4096, 49958, True),  # the head
    # the 32-row pool's pass: Mistral-7B's q/o, k/v, gate/up, down, head
    (32, 4096, 4096, True), (32, 4096, 1024, True), (32, 4096, 14336, True),
    (32, 14336, 4096, True), (32, 4096, 32768, True),
    # Jamba2-Mini's: Mamba's in_proj and out_proj, the head (the rest as Mistral's)
    (32, 4096, 16384, True), (32, 8192, 4096, True), (32, 4096, 65536, True),
    # an admission's 256-token chunk stays on the prefill form
    (256, 4096, 4096, False), (256, 4096, 14336, False), (256, 14336, 4096, False)])
def test_int4_form_at_the_pool_steps_of_the_7b_shapes(T, in_dim, out, decode):
    """The form an H100 runs faster (bench_int4.py's sweep, PERF.md §6) at a
    default pool's decode step (8 rows), a speculative chunk (9), speculative
    pool steps (up to 25), the 32-row pool's decode pass and an admission's
    256-token chunk."""
    assert i4.decode_form(T, in_dim, out, 132) == decode


# ---------------------------------------------------------------------------
# B4: split + ordered combine + the new token's analytic term + the append
# ---------------------------------------------------------------------------

def split_append_emulation(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
                           k_new_scales=None, v_new_scales=None, k_scales=None,
                           v_scales=None, *, run):
    """B4's split kernel over the old context (lens - 1 slots, none taken
    from k_new), the combine in split order, then the new token as one fp32
    term, in fp32: (B, N, hd) in q's dtype.  Then the append at
    pool[layer, blk, off], in place."""
    B, N, hd = q.shape
    Nkv = k_new.shape[1]
    rep = N // Nkv
    BS = k_pool.shape[2]
    width = tables.shape[1] * BS
    int8 = k_pool.dtype == torch.int8
    cdt = torch.bfloat16 if int8 else k_pool.dtype

    def rnd(x):
        return x.to(cdt).float()

    out = torch.zeros(B, N, hd)
    for b in range(B):
        ctx = min(int(lens[b]) - 1, width)
        j = torch.arange(max(ctx, 0))
        bix, oix = tables[b, j // BS].long(), j % BS
        k = k_pool[layer, bix, oix].reshape(-1, Nkv, hd).float()
        v = v_pool[layer, bix, oix].reshape(-1, Nkv, hd).float()
        ks = k_scales[layer, bix, oix] if int8 else torch.ones(len(j), Nkv)
        vs = v_scales[layer, bix, oix] if int8 else torch.ones(len(j), Nkv)
        qs = rnd(q[b].float() * (1.0 / math.sqrt(hd)))  # (N, hd)
        for g in range(Nkv):
            Q = qs[g * rep:(g + 1) * rep]
            m_all, l_all, acc = torch.full((rep,), NEG_INF), torch.zeros(rep), torch.zeros(rep, hd)
            parts = []
            for split in range(pa.split_count(width, run)):
                j0 = split * run
                if j0 >= ctx:
                    break
                sl = slice(j0, min(ctx, j0 + run))
                s = (Q @ k[sl, g].T) * ks[sl, g][None]
                m = s.amax(-1)
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(-1), rnd(p * vs[sl, g][None]) @ v[sl, g]))
            if parts:
                m_all = torch.stack([m for m, _, _ in parts]).amax(0)
            for m, l, a in parts:  # in split order
                c = torch.exp(m - m_all)
                l_all = l_all + l * c
                acc = acc + a * c[:, None]
            sn = (Q * k_new[b, g].float()).sum(-1)
            v_sc = 1.0
            if int8:
                sn = sn * k_new_scales[b, g]
                v_sc = v_new_scales[b, g]
            m_new = torch.maximum(m_all, sn)
            pn = torch.exp(sn - m_new)
            alpha = torch.exp(m_all - m_new)
            den = l_all * alpha + pn
            num = acc * alpha[:, None] + (pn * v_sc)[:, None] * v_new[b, g].float()[None]
            out[b, g * rep:(g + 1) * rep] = num / torch.where(den == 0, torch.ones_like(den),
                                                              den)[:, None]
    l, bi, oi = int(layer), blk.long(), off.long()
    k_pool[l, bi, oi] = k_new.reshape(B, -1)
    v_pool[l, bi, oi] = v_new.reshape(B, -1)
    if int8:
        k_scales[l, bi, oi] = k_new_scales
        v_scales[l, bi, oi] = v_new_scales
    return out.to(q.dtype)


B4_POOLS = {"f32": (torch.float32, False, 1e-5), "bf16": (torch.bfloat16, False, 2e-2),
            "int8": (torch.float32, True, 2e-2)}
B4_HEADS = {"mha": (4, 4), "gqa": (8, 2)}
B4_POOL_KEYS = ("k_pool", "v_pool", "k_scales", "v_scales")


def _b4_case(pool, heads):
    """Two parked rows (lens 1, dummy block 0 at offset BS - 1), appends at
    offsets 0 and BS - 1, a row with no old context, long rows over several
    runs; 16-slot blocks."""
    dtype, kv_int8, _ = B4_POOLS[pool]
    N, Nkv = B4_HEADS[heads]
    BS = 16
    ctx = [-1, 2 * BS, 3 * BS - 1, 0, 5 * BS + 7, 300, -1]
    return paged_case(ctx, N, Nkv, hd=32, block_size=BS, L=3, layer=2, dtype=dtype,
                      kv_int8=kv_int8, seed=len(pool) * 10 + N + Nkv)


def _copy(case):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in case.items()}


@pytest.mark.parametrize("run", [64, 128])
@pytest.mark.parametrize("heads", list(B4_HEADS))
@pytest.mark.parametrize("pool", list(B4_POOLS))
def test_split_append_emulation_matches_plain(pool, heads, run):
    case = _b4_case(pool, heads)
    tol = B4_POOLS[pool][2]
    ref_case = _copy(case)
    got = split_append_emulation(**case, run=run)
    want = pa.paged_append_attention_ref(**ref_case)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    for key in B4_POOL_KEYS:
        if case.get(key) is not None:
            assert torch.equal(case[key], ref_case[key]), key
    # the parked rows and the row with no old context give v_new (times vsn)
    for b in (0, 3, 6):
        vn = case["v_new"][b].float()
        if case.get("v_new_scales") is not None:
            vn = vn * case["v_new_scales"][b][:, None]
        rep = case["q"].shape[1] // vn.shape[0]
        torch.testing.assert_close(got[b].float(), vn.repeat_interleave(rep, 0).to(
            got.dtype).float(), atol=0, rtol=0)


@pytest.mark.parametrize("heads", list(B4_HEADS))
@pytest.mark.parametrize("pool", list(B4_POOLS))
def test_split_append_emulation_matches_pallas_interpret(pool, heads):
    case = _b4_case(pool, heads)
    tol = B4_POOLS[pool][2]
    def to_jax(v):
        if not isinstance(v, torch.Tensor):
            return v
        if v.dtype == torch.bfloat16:
            return jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(v.numpy())

    j = {k: to_jax(v) for k, v in case.items()}
    jo, jkp, jvp, jks, jvs = j_b4(
        j["q"], j["k_new"], j["v_new"], j["k_pool"], j["v_pool"], j["tables"], j["lens"],
        j["blk"], j["off"], jnp.int32(case["layer"]), j.get("k_new_scales"),
        j.get("v_new_scales"), j.get("k_scales"), j.get("v_scales"), interpret=True)
    got = split_append_emulation(**case, run=64)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jo, np.float32), atol=tol,
                               rtol=tol)
    for name, want in (("k_pool", jkp), ("v_pool", jvp), ("k_scales", jks), ("v_scales", jvs)):
        if want is not None:
            np.testing.assert_array_equal(case[name].float().numpy(),
                                          np.asarray(want, np.float32), err_msg=name)


# ---------------------------------------------------------------------------
# B3's decode form: exact nibbles on the tensor cores, a fixed group order
# ---------------------------------------------------------------------------

B3_TOL = 1e-2  # chip_smoke.py's: |err| <= B3_TOL * max|ref| + B3_TOL * |ref|


def int4_decode_emulation(x, q, scale, *, sms=132):
    """B3's decode form in fp32 on bf16 x: each group's dot over its exact
    nibbles in fp32, times the group's scale and added to its split's total
    in one rounding (the kernel's fma), the groups of a split in order; the
    splits' totals added in split order (``i4.decode_splits``).  The same
    order at every token count."""
    G, gsh, out = q.shape
    T = x.shape[0]
    lo, hi = unpack_s4_halves(q)
    xg = x.float().reshape(T, G, 2 * gsh).transpose(0, 1)  # (G, T, gs)
    dots = xg[..., :gsh] @ lo.float() + xg[..., gsh:] @ hi.float()  # (G, T, out) fp32
    splits, gps = i4.decode_splits(G, gsh, out, sms)
    y = torch.zeros(T, out)
    for s in range(splits):
        total = torch.zeros(T, out)
        for g in range(s * gps, min(G, (s + 1) * gps)):
            total = (total.double() + dots[g].double() * scale[g].double()).float()
        y = y + total
    return y


def _b3_tol(ref):
    return B3_TOL * ref.abs().max() + B3_TOL * ref.abs()


@pytest.mark.parametrize("T", [1, 8, 16, 32, 64])
@pytest.mark.parametrize("in_dim,out,gs", [(1024, 384, 128), (384, 250, 128), (1536, 200, 64),
                                           (768, 96, 192)])
def test_int4_decode_emulation_matches_plain_and_pallas(in_dim, out, gs, T):
    g = torch.Generator().manual_seed(in_dim + out + T)
    w = (torch.randn(in_dim, out, generator=g) * 0.02).to(torch.bfloat16)
    wq = quantize_grouped(w, group=gs)
    x = torch.randn(T, in_dim, generator=g).to(torch.bfloat16)
    got = int4_decode_emulation(x, wq["q"], wq["scale"])
    ref = i4.int4_matmul_ref(x.float(), wq["q"], wq["scale"])
    assert bool(((got - ref).abs() <= _b3_tol(ref)).all())
    want = torch.from_numpy(np.array(j_int4_matmul(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(wq["q"].numpy()),
        jnp.asarray(wq["scale"].numpy()), None, interpret=True), np.float32))
    assert bool(((got - want).abs() <= _b3_tol(want)).all())


def test_int4_decode_nibble_pairs_are_exact():
    """Every byte's two nibbles through the kernel's bf16 trick: (t & mask) ^
    0x43084308 is the bf16 pair (136 + n); minus 136 it is n exactly."""
    b = np.arange(256, dtype=np.uint32)
    for shift in (0, 4):  # low nibbles, then the high ones (the byte shifted)
        t = ((b >> shift) & 0xF) | (((b >> shift) & 0xF) << 16)
        biased = ((t & 0x000F000F) ^ 0x43084308).astype(np.uint32)
        halves = np.stack([biased & 0xFFFF, biased >> 16], -1).astype(np.uint32) << 16
        vals = halves.view(np.float32) - np.float32(136.0)
        nib = ((b >> shift) & 0xF).astype(np.int64)
        want = np.where(nib >= 8, nib - 16, nib).astype(np.float32)
        np.testing.assert_array_equal(vals, np.stack([want, want], -1))


@pytest.mark.parametrize("in_dim,out", [(4096, 4096), (4096, 11008), (11008, 4096),
                                        (4096, 49958), (5120, 13824), (13824, 5120)])
@pytest.mark.parametrize("sms", [132, 114])
def test_int4_decode_splits_cover_the_groups(in_dim, out, sms):
    """Every group in exactly one split, no split empty, at most one cluster
    of splits a column tile, and more than one split only where the blocks
    still fit one wave of two an SM."""
    G, gsh = in_dim // 128, 64
    splits, gps = i4.decode_splits(G, gsh, out, sms)
    assert (splits - 1) * gps < G <= splits * gps
    assert 1 <= splits <= i4._DECODE_MAX_SPLITS
    tiles = -(-out // i4._DECODE_COLS)
    assert splits == 1 or tiles * splits <= i4._DECODE_BLOCKS_PER_SM * sms
