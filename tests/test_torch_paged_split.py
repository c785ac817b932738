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
"""
import math

import numpy as np
import pytest
import torch

from visualcla_tpu_torch.fixtures import paged_verify_case
from visualcla_tpu_torch.ops.cuda import int4_matmul as i4
from visualcla_tpu_torch.ops.cuda import paged_attention as pa
from visualcla_tpu_torch.ops.quantization import dequantize_grouped, quantize_grouped

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


@pytest.mark.parametrize("out", [4096, 11008, 49958, 5120, 13824, 32000])
@pytest.mark.parametrize("sms", [132, 114])
def test_int4_form_changes_once_from_decode_to_prefill(out, sms):
    picks = [i4.decode_form(T, out, sms) for T in range(1, 1025)]
    assert picks[0] and not picks[-1]
    assert sum(a != b for a, b in zip(picks, picks[1:])) == 1


@pytest.mark.parametrize("T,out,decode", [
    (8, 4096, True), (16, 4096, True), (25, 4096, False),  # q/k/v/o, down
    (4, 11008, True), (8, 11008, False), (9, 11008, False),  # gate/up
    (8, 49958, True), (9, 49958, False)])  # the head
def test_int4_form_at_the_pool_steps_of_the_7b_shapes(T, out, decode):
    """The form an H100 runs faster (bench_int4.py's sweep) at a default
    pool's decode step (8 rows), a speculative chunk (9) and speculative pool
    steps (up to 20)."""
    assert i4.decode_form(T, out, 132) == decode
