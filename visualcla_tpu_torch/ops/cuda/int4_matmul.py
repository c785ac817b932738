"""Grouped-int4 matmul: the CUDA kernel B3, its plain PyTorch version, and the
wrapper.

B3 ``int4_matmul`` replaces ``int4_matmul`` (visualcla_tpu/ops/pallas/
int4_matmul.py) -> ``_kernel`` / ``_kernel_scratch`` / ``_kernel_scratch_tiled``.
The kernels live in ``csrc/int4_matmul.cu``; its header says what bounds each
form on the card (decode: carrier bytes; prefill: flops) and what the design
does about it.

Contract: x (..., in); the v2 carrier q (G, gs/2, out) uint8 and scale
(G, out) f32 of one weight (``ops.quantization``).  Returns x @ W4
(..., out) in ``out_dtype`` (default x's dtype).

The kernel takes x in bf16 (an f32 x is rounded to bf16 first, as the TPU
kernel does) and accumulates in fp32.  ``decode_form`` picks the form from
the token count and the weight's shape: the decode form for few tokens, the
prefill form (tensor cores, which needs gs % 64 == 0; other group sizes stay
on the decode form) for more.

The plain version follows the JAX package's XLA path
(``ops/quantization.py:_q_matmul_grouped``) in x's dtype with fp32
accumulation: up to gs/2 tokens one product per group on the exact nibbles,
scaled in fp32 and summed over groups; more tokens one product with the
weight dequantized (f32, then rounded to x's dtype).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.

Under autograd (an x that requires grad) the wrapper runs ``Int4MatmulFn``:
its forward is the same kernel (or plain version), its backward the input
gradient alone, dX = dY W^T.  That is the transpose of the JAX package's XLA
form, which ``jax.grad`` differentiates wherever its Pallas B3 is not used
(off the TPU, under a TP mesh): the Pallas kernel has no VJP, and neither
does this one.  So the backward is no kernel: W is dequantized (each value
in f32, rounded once to x's dtype, with no weight-sized f32 temporary), and
one product of dY rounded to x's dtype follows (``torch.matmul``, cuBLAS on
the card).  The carrier and the scales are frozen: a ``scale`` that
requires grad raises.  ``int4_matmul_grad_ref`` is the backward's plain
version, for the tests.
"""
from __future__ import annotations

import ctypes

import torch

from ..quantization import dequantize_grouped, unpack_s4_halves
from . import build

# The decode form's blocks (``csrc/int4_matmul.cu``): 256 columns and up to
# 64 tokens (16, 32 or 64 a block, from T), streaming their run of groups
# through a ring, 8 warps of 32 columns each over every group of it; a column
# tile's splits run as one cluster (at most 16 blocks, a size Hopper takes as
# non-portable), and the blocks stay within one wave of 2 an SM.
_DECODE_COLS = 256
_DECODE_TOKENS = 64
_DECODE_MAX_SPLITS = 16
_DECODE_BLOCKS_PER_SM = 2
_DECODE_MIN_GROUPS = 4  # groups a split keeps once every SM has a block
# The prefill form's block tilings, tokens a block: 1 -> 64, 2 -> 128 (both
# 128 columns wide); ``prefill_tiling`` picks one from the grid.
PREFILL_TILES = {1: 64, 2: 128}
# The cost model behind ``decode_form``, fitted on an H100 (80GB HBM3, 700 W)
# to bench_int4.py's sweep of both forms on the LLaMA-7B, Mistral-7B and
# Jamba shapes and heads at 1-256 tokens, each shape's calls on carriers that
# do not stay in the L2 (PERF.md §6).  The decode form takes a fixed
# _DECODE_FIXED_US (the ring's fill, the cluster's sums) plus the carrier's
# bytes at _DECODE_BYTES_PER_US times its token tile's cost (_DECODE_TILE_COST:
# 16, 32 or 64 tokens a block; its products grow with the tile); each prefill
# block walks all of in_dim, so at few tokens the prefill form takes its
# waves of blocks (one block an SM; counted at 64 tokens, where its time is
# still flat in T) times in_dim at _PREFILL_US_PER_IN.  Where ``out`` is not a
# multiple of 16 both read the carrier without 16-byte rows (the decode form
# _UNALIGNED_DECODE_COST, the prefill form _UNALIGNED_PREFILL_COST times
# longer).  The decode form's cost grows with T, the prefill form's does not,
# and past one block's 64 tokens the prefill form serves, so the form changes
# once as T grows.
_DECODE_FIXED_US = 7.3
_DECODE_BYTES_PER_US = 2.24e6
_DECODE_TILE_COST = {16: 1.0, 32: 1.46, 64: 2.78}
_PREFILL_US_PER_IN = 0.0105
_UNALIGNED_DECODE_COST = 1.7
_UNALIGNED_PREFILL_COST = 2.3
LAUNCHES = {"int4_matmul_decode": 0, "int4_matmul_prefill": 0}
FORMS = ("decode", "prefill")

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library."""
    global _lib
    if _lib is None:
        lib = build.load("int4_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vcla_int4_matmul_decode.argtypes = [
            ptr, ptr, ptr, ptr,  # x q scale out
            i32, i32, i32, i32, i32, i32, i32, i32,  # T in G gsh out out_bf16 splits gps
            ptr]  # stream
        lib.vcla_int4_matmul_decode.restype = i32
        lib.vcla_int4_matmul_prefill.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]  # ... out_bf16 tile
        lib.vcla_int4_matmul_prefill.restype = i32
        lib.vcla_int4_error_string.argtypes = [i32]
        lib.vcla_int4_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, q, scale):
    """The checks the kernel and the plain version share."""
    if q.dim() != 3 or q.dtype != torch.uint8:
        raise ValueError(f"expected a uint8 (G, gs/2, out) carrier, got {q.dtype} "
                         f"{tuple(q.shape)}")
    G, gsh, out = q.shape
    if tuple(scale.shape) != (G, out) or scale.dtype != torch.float32:
        raise ValueError(f"scale {scale.dtype} {tuple(scale.shape)} does not match the "
                         f"carrier {tuple(q.shape)}")
    if x.shape[-1] != G * 2 * gsh:
        raise ValueError(f"x in-dim {x.shape[-1]} != G*gs = {G}*{2 * gsh}")
    if len({x.device, q.device, scale.device}) != 1:
        raise ValueError(f"x on {x.device}, weight on {q.device}, scale on {scale.device}")


def int4_matmul_ref(x, q, scale, *, out_dtype=None):
    """Plain version of B3: ``_q_matmul_grouped``'s numerics, any device."""
    _check(x, q, scale)
    G, gsh, out = q.shape
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    T = x2.shape[0]
    if T * 4 > 2 * gsh * 2:  # the (G, T, out) fp32 partials outweigh one weight temp
        y = x2 @ dequantize_grouped(q, scale, x.dtype)
    else:
        lo, hi = unpack_s4_halves(q)
        xg = x2.reshape(T, G, 2 * gsh).transpose(0, 1).float()  # (G, T, gs), exact upcast
        y = xg[..., :gsh] @ lo.float() + xg[..., gsh:] @ hi.float()  # (G, T, out) fp32
        y = (y * scale[:, None, :]).sum(0)
    return y.to(out_dtype).reshape(*lead, out)


def int4_matmul(x, q, scale, *, out_dtype=None):
    """B3: x @ W4 through the kernel on CUDA tensors, the plain version on CPU
    tensors; differentiable in x (``Int4MatmulFn``) when x requires grad."""
    if torch.is_grad_enabled():
        if scale.requires_grad:  # (a uint8 carrier cannot require grad)
            raise RuntimeError(
                "kernel B3 (int4_matmul) has no gradient with respect to its scale: the int4 "
                "weight is frozen (keep it out of the trainable partition)")
        if x.requires_grad:
            return Int4MatmulFn.apply(x, q, scale, out_dtype)
    return _forward(x, q, scale, out_dtype)


def _forward(x, q, scale, out_dtype):
    if x.device.type == "cpu":
        return int4_matmul_ref(x, q, scale, out_dtype=out_dtype)
    return _launch(x, q, scale, out_dtype)


class Int4MatmulFn(torch.autograd.Function):
    """B3 under autograd: forward the kernel (the plain version on CPU
    tensors), backward dX = dY W^T in x's dtype.  Saves the carrier and the
    scales only, so a recompute under remat runs B3 again."""

    @staticmethod
    def forward(ctx, x, q, scale, out_dtype):
        ctx.save_for_backward(q, scale)
        ctx.x_dtype = x.dtype
        return _forward(x, q, scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        w = _dequantized(q, scale, ctx.x_dtype)
        dx = g.reshape(-1, g.shape[-1]).to(ctx.x_dtype) @ w.t()
        return dx.reshape(*g.shape[:-1], dx.shape[-1]), None, None, None


def _dequantized(q, scale, dtype):
    """``dequantize_grouped(q, scale, dtype)`` in four elementwise launches
    and without its int32 and f32 temporaries (~6 bytes a weight moved
    instead of ~40): the signed nibbles by arithmetic shifts of the carrier
    seen as int8, then each half times its scales, computed in f32 and
    rounded once to ``dtype`` as it is stored (the same values)."""
    G, gsh, out = q.shape
    qi = q.view(torch.int8)
    s = scale[:, None, :]
    w = torch.empty(G, 2, gsh, out, dtype=dtype, device=q.device)
    torch.mul((qi << 4) >> 4, s, out=w[:, 0])  # low nibbles: rows [0, gs/2) of a group
    torch.mul(qi >> 4, s, out=w[:, 1])
    return w.view(G * 2 * gsh, out)


def int4_matmul_grad_ref(g, q, scale, x_dtype):
    """Plain version of ``Int4MatmulFn``'s backward: the input gradient of
    x @ W4 for the output cotangent ``g`` (..., out), in ``x_dtype``."""
    w = dequantize_grouped(q, scale, x_dtype)
    return g.to(x_dtype) @ w.t()


def _launch(x, q, scale, out_dtype=None, form=None, tile=None):
    """The kernel on CUDA tensors.  ``form`` ("decode" / "prefill") and the
    prefill ``tile`` default to what ``decode_form`` and ``prefill_tiling``
    pick; bench_int4.py and the card tests pass them to time and check each."""
    _check(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {x.device}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel writes bfloat16 or float32, got {out_dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bfloat16 (or float32, rounded to bfloat16), got {x.dtype}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    G, gsh, out = q.shape
    in_dim = 2 * gsh * G
    lead = x.shape[:-1]
    xb = x.reshape(-1, in_dim).to(torch.bfloat16)
    if not xb.is_contiguous() or xb.data_ptr() % 16:
        xb = xb.clone(memory_format=torch.contiguous_format)
    if not q.is_contiguous() or not scale.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("carrier and scale must be contiguous (and the carrier 16-byte aligned)")
    T = xb.shape[0]
    if form is None:
        form = ("decode" if gsh % 32 or decode_form(T, in_dim, out, _sm_count(x.device))
                else "prefill")
    if form not in FORMS or (form == "prefill" and gsh % 32):
        raise ValueError(f"no {form!r} form for group size {2 * gsh}")
    y = torch.empty(T, out, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build_kernels()
    ptrs = (xb.data_ptr(), q.data_ptr(), scale.data_ptr())
    shape = (T, in_dim, G, gsh, out, int(out_dtype == torch.bfloat16))
    if form == "decode":  # one launch
        splits, gps = decode_splits(G, gsh, out, _sm_count(x.device))
        err = lib.vcla_int4_matmul_decode(*ptrs, y.data_ptr(), *shape, splits, gps, stream)
    else:
        tile = tile or prefill_tiling(T, out, _sm_count(x.device))
        err = lib.vcla_int4_matmul_prefill(*ptrs, y.data_ptr(), *shape, tile, stream)
    name = f"int4_matmul_{form}"
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.vcla_int4_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return y.reshape(*lead, out)


def decode_form(T: int, in_dim: int, out: int, sms: int) -> bool:
    """Whether the decode form serves T tokens of an (in_dim, out) weight on
    a card of ``sms`` SMs: the cost model above, the prefill form's waves
    taken at 64 tokens and the tiling ``prefill_tiling`` picks there.  Past
    one block's 64 tokens the prefill form serves."""
    if T > _DECODE_TOKENS:
        return False
    tile = 16 if T <= 16 else 32 if T <= 32 else 64
    decode = _DECODE_FIXED_US + in_dim * out / 2 / _DECODE_BYTES_PER_US * _DECODE_TILE_COST[tile]
    rows = PREFILL_TILES[prefill_tiling(64, out, sms)]
    prefill = -(-(-(-out // 128) * -(-64 // rows)) // sms) * in_dim * _PREFILL_US_PER_IN
    if out % 16:
        decode *= _UNALIGNED_DECODE_COST
        prefill *= _UNALIGNED_PREFILL_COST
    return decode < prefill


def decode_splits(G: int, gsh: int, out: int, sms: int) -> tuple:
    """(splits, groups a split) of the decode form for a carrier of G groups
    of ``gsh`` rows and ``out`` columns on ``sms`` SMs.  The blocks (256
    columns each) stay within one wave of 2 an SM and a cluster of 16; within
    that, a split keeps 4 groups or more once the blocks give every SM one (a
    block's fixed path, its ring's fill and the cluster's sums, weighs on
    fewer groups), and fewer groups only to give every SM a block.  A
    function of the weight's shape and the card alone, never of the token
    count, so a token's row is summed in the same order whatever the batch."""
    tiles = -(-out // _DECODE_COLS)
    want = max(G // _DECODE_MIN_GROUPS, -(-sms // tiles))
    splits = max(1, min(_DECODE_BLOCKS_PER_SM * sms // tiles, _DECODE_MAX_SPLITS, G, want))
    gps = -(-G // splits)
    return -(-G // gps), gps


def prefill_tiling(T: int, out: int, sms: int) -> int:
    """The prefill form's block tiling for T tokens and ``out`` columns on a
    card of ``sms`` SMs: the one whose waves of blocks (one block an SM) take
    the fewest token rows in all, the taller block on a tie (less dequantizing
    a product).  A block's time grows with its token rows."""
    col_blocks = -(-out // 128)

    def cost(tile):
        rows = PREFILL_TILES[tile]
        return -(-col_blocks * -(-T // rows) // sms) * rows, -rows

    return min(PREFILL_TILES, key=cost)


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_tokens_per_block(T: int) -> int:
    """Tokens one decode-form block serves: T up to 64 (in tiles of 16, 32
    or 64), then 64 a block over several blocks."""
    return min(T, _DECODE_TOKENS)
