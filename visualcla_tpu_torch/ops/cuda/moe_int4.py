"""Grouped int4 expert products: the CUDA kernel B7, its plain PyTorch
version, and the wrapper.

B7 ``moe_int4_matmul`` replaces no TPU kernel (the JAX package has no
experts); the kernel lives in ``csrc/moe_int4.cu``, whose header says what
bounds it and what the design does about it.

Contract: x (A, in), the routed tokens' inputs in expert order; the experts'
stacked v2 carriers q (E, G, gs/2, out) uint8 and scales (E, G, out) f32
(``ops.quantization``'s layout, one weight an expert); offsets (E + 1)
int32: expert e's rows of x are [offsets[e], offsets[e + 1]).  Returns
(A, out), row j = x[j] @ W4_e for the expert e whose range holds j, in
``out_dtype`` (default x's dtype); rows past offsets[E] (tokens routed to
no expert) are left unwritten by the kernel and zero in the plain version.  ``max_rows`` bounds one expert's rows
(the token count: top-k routing takes a token once an expert), so the
kernel's grid is static and nothing is read back to the host: the launch
replays inside a captured graph.

Numerics: the kernel takes x in bf16 and sums each group's exact-nibble dot
in fp32, times its scale, over the groups in order (B3's decode order).
The plain version computes the same sums in fp32 on the CPU, expert by
expert (reading the offsets on the host).  Group size 128 only; ``out`` a
multiple of 128.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..quantization import unpack_s4_halves
from . import build

LAUNCHES = {"moe_int4_matmul": 0}
# token rows a block: 16 while an expert sees few tokens (decode), 64 for
# admissions
DECODE_TILE, PREFILL_TILE = 16, 64

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("moe_int4")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vcla_moe_int4_matmul.argtypes = [ptr, ptr, ptr, ptr, ptr,  # xp q scale offs out
                                             i32, i32, i32, i32, i32, i32, ptr]
        lib.vcla_moe_int4_matmul.restype = i32
        lib.vcla_moe_int4_error_string.argtypes = [i32]
        lib.vcla_moe_int4_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(x, q, scale, offsets):
    if q.dim() != 4 or q.dtype != torch.uint8:
        raise ValueError(f"expected a uint8 (E, G, gs/2, out) carrier, got {q.dtype} "
                         f"{tuple(q.shape)}")
    E, G, gsh, out = q.shape
    if tuple(scale.shape) != (E, G, out) or scale.dtype != torch.float32:
        raise ValueError(f"scale {scale.dtype} {tuple(scale.shape)} does not match the "
                         f"carrier {tuple(q.shape)}")
    if x.dim() != 2 or x.shape[1] != G * 2 * gsh:
        raise ValueError(f"x {tuple(x.shape)}: expected (A, {G * 2 * gsh})")
    if tuple(offsets.shape) != (E + 1,):
        raise ValueError(f"offsets {tuple(offsets.shape)}: expected ({E + 1},)")
    if len({x.device, q.device, scale.device, offsets.device}) != 1:
        raise ValueError("x, carrier, scale and offsets must lie on one device")


def grouped_ref(x, q, scale):
    """x (T, in) @ one int4 carrier as B7 sums it: per group an fp32 dot on
    the exact nibbles, times the group's scale, summed over the groups in
    order.  -> (T, out) f32."""
    G, gsh, out = q.shape
    lo, hi = unpack_s4_halves(q)
    xg = x.float().reshape(x.shape[0], G, 2 * gsh)
    y = torch.zeros(x.shape[0], out, dtype=torch.float32, device=x.device)
    for g in range(G):
        part = xg[:, g, :gsh] @ lo[g].float() + xg[:, g, gsh:] @ hi[g].float()
        y += part * scale[g]
    return y


def moe_int4_matmul_ref(x, q, scale, offsets, *, out_dtype=None):
    """Plain version of B7, expert by expert (the offsets read on the host)."""
    _check(x, q, scale, offsets)
    bounds = offsets.tolist()
    y = torch.zeros(x.shape[0], q.shape[-1], dtype=torch.float32, device=x.device)
    for e in range(q.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            y[a:b] = grouped_ref(x[a:b], q[e], scale[e])
    return y.to(out_dtype or x.dtype)


def interleave_groups(x: torch.Tensor, group: int = 128) -> torch.Tensor:
    """(A, in) -> (A, in) bf16 with each group's halves interleaved, pairs
    (x[r], x[group/2 + r]): the kernel's k order, one word a pair."""
    A, K = x.shape
    return (x.to(torch.bfloat16).reshape(A, K // group, 2, group // 2).transpose(2, 3)
            .contiguous().reshape(A, K))


def moe_int4_matmul(x, q, scale, offsets, max_rows: int, *, out_dtype=None, tile=None):
    """B7 on CUDA tensors (one launch over every expert), the plain version on
    CPU tensors.  ``tile`` (16 or 64 token rows a block) defaults by
    ``max_rows``."""
    if x.device.type == "cpu":
        return moe_int4_matmul_ref(x, q, scale, offsets, out_dtype=out_dtype)
    _check(x, q, scale, offsets)
    E, G, gsh, out = q.shape
    if 2 * gsh != 128 or out % 128:
        raise ValueError(f"B7 takes group size 128 and out a multiple of 128, got group "
                         f"{2 * gsh}, out {out}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"B7 writes bfloat16 or float32, got {out_dtype}")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("carrier and scales must be contiguous")
    tile = tile or (DECODE_TILE if max_rows <= 2 * DECODE_TILE else PREFILL_TILE)
    xp = interleave_groups(x)
    offs = offsets.to(torch.int32).contiguous()
    y = torch.empty(x.shape[0], out, dtype=out_dtype, device=x.device)
    if x.shape[0] == 0:
        return y
    lib = build_kernels()
    err = lib.vcla_moe_int4_matmul(xp.data_ptr(), q.data_ptr(), scale.data_ptr(), offs.data_ptr(),
                                   y.data_ptr(), x.shape[1], out, E, int(max_rows), int(tile),
                                   int(out_dtype == torch.bfloat16),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_int4_matmul kernel launch failed: "
                           f"{lib.vcla_moe_int4_error_string(err).decode()}")
    LAUNCHES["moe_int4_matmul"] += 1
    return y
