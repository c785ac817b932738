"""Paged decode attention with the new token's K/V appended in the same call:
the CUDA kernel B4, its plain PyTorch version, and the wrapper.

B4 ``paged_append_attention`` replaces ``paged_append_attention`` ->
``_append_kernel`` (visualcla_tpu/ops/pallas/paged_attention.py).  The kernel
lives in ``csrc/paged_attention.cu``; its header says what bounds it on the
card (the bytes of the rows' K/V context) and what the design does about it.

Contract, the JAX function's (``paged_attention.py:442-470``):
  q (B, N, hd), rope applied; k_new, v_new (B, Nkv, hd) in the pool's type
  (int8 already quantized, with k_new_scales / v_new_scales (B, Nkv) f32);
  k_pool, v_pool (L, NB, BS, Nkv*hd) in q's type or int8 with k_scales /
  v_scales (L, NB, BS, Nkv) f32; tables (B, max_blocks) pool block ids;
  lens (B,) the context length INCLUDING the new token; blk, off (B,) the pool
  block and in-block offset the new token goes to; layer, the pool layer.
  Row b attends, with query head n on kv head n // (N / Nkv), over its
  lens[b] - 1 old tokens (slot j in block tables[b, j // BS] at j % BS) and
  the new token; the new token's K/V (and scales) are written into
  pool[layer, blk[b], off[b]].  Parked rows pass lens 1 and blk 0: the dummy
  block 0 is never handed out, and nothing reads it.

Numerics, the Pallas kernel's: the compute type is the pool's type for a float
pool and bf16 for an int8 pool; q * scale and the probabilities (times the V
scales) are rounded to it before their products, which accumulate in fp32;
int8 K scales multiply the score after the dot, V scales the probability, and
the softmax denominator sums the unscaled probabilities; an fp32 online
softmax runs block by block in table order.

The pools (and scale pools) are updated IN PLACE; the call returns only the
attention output (B, N, hd) in q's type.  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches, the int8-pool form as
``paged_append_kv8``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128,)  # every LLaMA size in core/config.py
LAUNCHES = {"paged_append": 0, "paged_append_kv8": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    global _lib
    if _lib is None:
        lib = build.load("paged_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.vcla_paged_append.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # q k_new v_new k_pool v_pool
            ptr, ptr, ptr, ptr,  # tables lens blk off
            ptr, ptr, ptr, ptr,  # k_new_scales v_new_scales k_scales v_scales
            ptr,  # out
            i32, i32, i32, i32, i32, i32, i32,  # B N Nkv NB BS max_blocks layer
            i32, i32, i32,  # head_dim is_bf16 kv_int8
            ctypes.c_float, ptr]  # scale stream
        lib.vcla_paged_append.restype = i32
        lib.vcla_paged_error_string.argtypes = [i32]
        lib.vcla_paged_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
           k_new_scales, v_new_scales, k_scales, v_scales):
    if q.dim() != 3 or k_new.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"expected q (B, N, hd), k_new (B, Nkv, hd) and pools "
                         f"(L, NB, BS, Nkv*hd); got {tuple(q.shape)}, {tuple(k_new.shape)}, "
                         f"{tuple(k_pool.shape)}")
    B, N, hd = q.shape
    _, Nkv, hdk = k_new.shape
    L, NB, BS, KVL = k_pool.shape
    if (tuple(v_new.shape) != tuple(k_new.shape) or tuple(v_pool.shape) != tuple(k_pool.shape)
            or k_new.shape[0] != B or hdk != hd or KVL != Nkv * hd):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k/v_new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if N % Nkv:
        raise ValueError(f"query heads {N} not a multiple of kv heads {Nkv}")
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} is not (B={B}, max_blocks)")
    for name, t in (("lens", lens), ("blk", blk), ("off", off)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({B},)")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range for L={L}")
    scales = (k_new_scales, v_new_scales, k_scales, v_scales)
    if k_pool.dtype == torch.int8:
        if any(s is None for s in scales) or v_pool.dtype != torch.int8 \
                or k_new.dtype != torch.int8 or v_new.dtype != torch.int8:
            raise TypeError("an int8 pool takes int8 k_new/v_new and all four scale tensors")
        for name, s, shape in (("k_new_scales", k_new_scales, (B, Nkv)),
                               ("v_new_scales", v_new_scales, (B, Nkv)),
                               ("k_scales", k_scales, (L, NB, BS, Nkv)),
                               ("v_scales", v_scales, (L, NB, BS, Nkv))):
            if tuple(s.shape) != shape or s.dtype != torch.float32:
                raise ValueError(f"{name} {s.dtype} {tuple(s.shape)}, expected float32 {shape}")
    else:
        if any(s is not None for s in scales):
            raise TypeError(f"scales given with a {k_pool.dtype} pool")
        if not (q.dtype == k_new.dtype == v_new.dtype == k_pool.dtype == v_pool.dtype):
            raise TypeError(f"q {q.dtype}, k/v_new {k_new.dtype}/{v_new.dtype} and pools "
                            f"{k_pool.dtype}/{v_pool.dtype} differ")
    tensors = [q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off]
    tensors += [s for s in scales if s is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


# ---------------------------------------------------------------------------
# plain PyTorch version (the kernel's contract, any device)
# ---------------------------------------------------------------------------

def _append(k_new, v_new, k_pool, v_pool, blk, off, layer, k_new_scales, v_new_scales,
            k_scales, v_scales):
    B = k_new.shape[0]
    l, b_ix, o_ix = int(layer), blk.long(), off.long()
    k_pool[l, b_ix, o_ix] = k_new.reshape(B, -1)
    v_pool[l, b_ix, o_ix] = v_new.reshape(B, -1)
    if k_scales is not None:
        k_scales[l, b_ix, o_ix] = k_new_scales
        v_scales[l, b_ix, o_ix] = v_new_scales


def paged_append_attention_ref(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off,
                               layer, k_new_scales=None, v_new_scales=None, k_scales=None,
                               v_scales=None, *, scale=None):
    """Plain version of B4: the JAX kernel's arithmetic, block by block in
    table order, vectorized over rows.  Updates the pools in place."""
    _check(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
           k_new_scales, v_new_scales, k_scales, v_scales)
    B, N, hd = q.shape
    Nkv = k_new.shape[1]
    L, NB, BS, KVL = k_pool.shape
    rep = N // Nkv
    int8 = k_pool.dtype == torch.int8
    cdt = torch.bfloat16 if int8 else k_pool.dtype
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    l = int(layer)

    def rnd(x):  # round to the compute type, keep fp32
        return x.to(cdt).float()

    qs = rnd(q.float() * scale).reshape(B, Nkv, rep, hd)
    ctx = lens.long() - 1  # the pool holds the OLD context only
    m = torch.full((B, Nkv, rep), NEG_INF, device=q.device)
    den = torch.zeros((B, Nkv, rep), device=q.device)
    acc = torch.zeros((B, Nkv, rep, hd), device=q.device)
    ar = torch.arange(BS, device=q.device)
    for i in range(tables.shape[1]):
        bid = tables[:, i].long()
        k = k_pool[l, bid].reshape(B, BS, Nkv, hd).float()
        v = v_pool[l, bid].reshape(B, BS, Nkv, hd).float()
        s = torch.einsum("bgrd,btgd->bgrt", qs, k)  # (B, Nkv, rep, BS)
        if int8:
            s = s * k_scales[l, bid].permute(0, 2, 1)[:, :, None, :]
        valid = (i * BS + ar)[None, :] < ctx[:, None]  # (B, BS)
        s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        if int8:
            p_v = p * v_scales[l, bid].permute(0, 2, 1)[:, :, None, :]
        else:
            p_v = p
        pv = torch.einsum("bgrt,btgd->bgrd", rnd(p_v), v)
        step = (ctx > i * BS)[:, None, None]  # rows with old context in this block
        den = torch.where(step, den * alpha + p.sum(dim=-1), den)
        acc = torch.where(step[..., None], acc * alpha[..., None] + pv, acc)
        m = torch.where(step, m_new, m)
    # the new token: one analytic online-softmax term, always in context
    kn = k_new.float()[:, :, None, :]
    vn = v_new.float()[:, :, None, :]
    sn = (qs * kn).sum(dim=-1)  # (B, Nkv, rep), products in fp32
    if int8:
        sn = sn * k_new_scales[:, :, None]
    m_new = torch.maximum(m, sn)
    pn = torch.exp(sn - m_new)
    alpha = torch.exp(m - m_new)
    den = den * alpha + pn
    if int8:
        pn = pn * v_new_scales[:, :, None]
    acc = acc * alpha[..., None] + pn[..., None] * vn
    out = acc / torch.where(den == 0, torch.ones_like(den), den)[..., None]
    _append(k_new, v_new, k_pool, v_pool, blk, off, layer, k_new_scales, v_new_scales,
            k_scales, v_scales)
    return out.reshape(B, N, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _launch(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
            k_new_scales, v_new_scales, k_scales, v_scales, scale):
    B, N, hd = q.shape
    Nkv = k_new.shape[1]
    L, NB, BS, _ = k_pool.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bfloat16 or float32 queries, got {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head dims are {KERNEL_HEAD_DIMS}, got {hd}")
    named = [("q", q), ("k_new", k_new), ("v_new", v_new), ("k_pool", k_pool),
             ("v_pool", v_pool)]
    kv8 = k_pool.dtype == torch.int8
    if kv8:
        named += [("k_new_scales", k_new_scales), ("v_new_scales", v_new_scales),
                  ("k_scales", k_scales), ("v_scales", v_scales)]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    tables, lens, blk, off = _i32(tables), _i32(lens), _i32(blk), _i32(off)
    out = torch.empty_like(q)
    lib = build_kernels()
    err = lib.vcla_paged_append(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(), blk.data_ptr(),
        off.data_ptr(),
        *((t.data_ptr() if kv8 else None)
          for t in (k_new_scales, v_new_scales, k_scales, v_scales)),
        out.data_ptr(), B, N, Nkv, NB, BS, tables.shape[1], int(layer), hd,
        int(q.dtype == torch.bfloat16), int(kv8), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_append kernel launch failed: "
                           f"{lib.vcla_paged_error_string(err).decode()}")
    LAUNCHES["paged_append_kv8" if kv8 else "paged_append"] += 1
    return out


def paged_append_attention(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
                           k_new_scales=None, v_new_scales=None, k_scales=None,
                           v_scales=None, *, scale=None):
    """B4: append each row's new K/V into the pools IN PLACE at
    ``pool[layer, blk, off]`` and return its decode attention (B, N, hd)
    over the row's block table (see the module docstring)."""
    _check(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
           k_new_scales, v_new_scales, k_scales, v_scales)
    args = (q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
            k_new_scales, v_new_scales, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_append_attention_ref(*args, scale=scale)
    return _launch(*args, scale)
