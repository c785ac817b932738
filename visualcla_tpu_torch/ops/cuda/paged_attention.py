"""Paged attention over the block pool: the CUDA kernels B4, B5 and B6, their
plain PyTorch versions, and the wrappers.

B4 ``paged_append_attention`` replaces ``paged_append_attention`` ->
``_append_kernel`` (visualcla_tpu/ops/pallas/paged_attention.py): decode
attention with the new token's K/V appended in the same call.  B5
``paged_verify_attention`` (-> ``_verify_kernel``) is its Sq-token form, the
speculative verify step; B6 ``paged_decode_attention`` (-> ``_paged_kernel``)
is decode attention over one layer's pool without an append, in f32 (see
their docstrings).  The kernels live in ``csrc/paged_attention.cu``; its
comments say what bounds them on the card (the bytes of the rows' K/V
context) and what the design does about it.  All three share one split-KV
structure: a kernel over runs of each row's table writes fp32 partials (see
``_split_scratch``) and a second launch merges them in split order (B4's
then folds in the new token as one analytic fp32 term).

B4's contract, the JAX function's (``paged_attention.py:442-470``):
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

B4's and B5's numerics, the Pallas kernels': the compute type is the pool's type for a float
pool and bf16 for an int8 pool; q * scale and the probabilities (times the V
scales) are rounded to it before their products, which accumulate in fp32;
int8 K scales multiply the score after the dot, V scales the probability, and
the softmax denominator sums the unscaled probabilities; an fp32 online
softmax runs block by block in table order.

The pools (and scale pools) are updated IN PLACE; the call returns only the
attention output (B, N, hd) in q's type.  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.
Under autograd a wrapper raises if an input requires grad: no kernel has
a backward.
``LAUNCHES`` counts kernel launches, each int8-pool form under its own
``_kv8`` name.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, refuse_autograd

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128,)  # every LLaMA size in core/config.py
LAUNCHES = {"paged_append": 0, "paged_append_kv8": 0, "paged_verify": 0,
            "paged_verify_kv8": 0, "paged_decode": 0, "paged_decode_kv8": 0}

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
            ptr, ptr,  # out scratch
            i32, i32, i32, i32, i32, i32, i32,  # B N Nkv NB BS max_blocks layer
            i32, i32, i32,  # head_dim is_bf16 kv_int8
            ctypes.c_float, ptr]  # scale stream
        lib.vcla_paged_append.restype = i32
        lib.vcla_paged_verify.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # q k_new v_new k_pool v_pool
            ptr, ptr,  # tables lens
            ptr, ptr, ptr, ptr,  # k_new_scales v_new_scales k_scales v_scales
            ptr, ptr,  # out scratch
            i32, i32, i32, i32, i32, i32, i32, i32,  # B Sq N Nkv NB BS max_blocks layer
            i32, i32, i32,  # head_dim is_bf16 kv_int8
            ctypes.c_float, ptr]  # scale stream
        lib.vcla_paged_verify.restype = i32
        lib.vcla_paged_decode.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # q k_pool v_pool tables lens
            ptr, ptr, ptr, ptr,  # k_scales v_scales out scratch
            i32, i32, i32, i32, i32, i32,  # B N Nkv NB BS max_blocks
            i32, i32, i32,  # head_dim is_bf16 kv_int8
            ctypes.c_float, ptr]  # scale stream
        lib.vcla_paged_decode.restype = i32
        lib.vcla_paged_run.argtypes = []
        lib.vcla_paged_run.restype = i32
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
    for name, t in (("blk", blk), ("off", off)):
        if tuple(t.shape) != (B,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({B},)")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range for L={L}")
    _check_types(q, k_new, v_new, k_pool, v_pool,
                 k_new_scales=(k_new_scales, (B, Nkv)), v_new_scales=(v_new_scales, (B, Nkv)),
                 k_scales=(k_scales, (L, NB, BS, Nkv)), v_scales=(v_scales, (L, NB, BS, Nkv)))
    _check_rows(B, tables, lens, [q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off,
                                  k_new_scales, v_new_scales, k_scales, v_scales])


def _check_types(q, *kv, **scales) -> None:
    """The K/V tensors ``kv`` (new tokens and pools) share one type: q's, or
    int8 (then q may be bf16 or f32).  An int8 pool takes every scale tensor,
    f32 of its expected shape (name -> (tensor, shape)); a float pool none."""
    int8 = kv[-1].dtype == torch.int8
    types = {t.dtype for t in kv} | (set() if int8 else {q.dtype})
    if len(types) != 1:
        raise TypeError(f"q {q.dtype} and the K/V tensors {[t.dtype for t in kv]} do not "
                        f"match")
    if not int8:
        if any(s is not None for s, _ in scales.values()):
            raise TypeError("scales given with a float pool")
        return
    for name, (s, shape) in scales.items():
        if s is None:
            raise TypeError(f"an int8 pool takes {name}")
        if tuple(s.shape) != shape or s.dtype != torch.float32:
            raise ValueError(f"{name} {s.dtype} {tuple(s.shape)}, expected float32 {shape}")


def _check_rows(B: int, tables, lens, tensors) -> None:
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables {tuple(tables.shape)} is not (B={B}, max_blocks)")
    if tuple(lens.shape) != (B,):
        raise ValueError(f"lens {tuple(lens.shape)} != ({B},)")
    devices = {t.device for t in tensors if t is not None}
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


def _check_launch(hd: int, **named) -> float:
    """What the kernels take beyond the contract: bf16 or f32 queries ``q``,
    head dim 128, contiguous tensors (``None`` skipped) on the current
    device.  -> the default scale."""
    q = named["q"]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bfloat16 or float32 queries, got {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head dims are {KERNEL_HEAD_DIMS}, got {hd}")
    for name, t in named.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return 1.0 / math.sqrt(hd)


def _check_aligned(**named) -> None:
    """B4 and B5 copy K/V rows 16 bytes at a time: each tensor must start 16-byte
    aligned (its rows then are: hd 128 in any type is a multiple of 16 bytes)."""
    for name, t in named.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")


def _ptr(t) -> int:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, lib, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.vcla_paged_error_string(err).decode()}")


def _launch(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
            k_new_scales, v_new_scales, k_scales, v_scales, scale):
    B, N, hd = q.shape
    Nkv = k_new.shape[1]
    L, NB, BS, _ = k_pool.shape
    default = _check_launch(hd, q=q, k_new=k_new, v_new=v_new, k_pool=k_pool,
                            v_pool=v_pool, k_new_scales=k_new_scales,
                            v_new_scales=v_new_scales, k_scales=k_scales, v_scales=v_scales)
    kv8 = k_pool.dtype == torch.int8
    if scale is None:
        scale = default
    _check_aligned(k_new=k_new, v_new=v_new, k_pool=k_pool, v_pool=v_pool)
    tables, lens, blk, off = _i32(tables), _i32(lens), _i32(blk), _i32(off)
    out = torch.empty_like(q)
    lib = build_kernels()
    scratch = _split_scratch(lib, B, Nkv, N // Nkv, tables.shape[1] * BS, hd, q.device)
    err = lib.vcla_paged_append(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(), blk.data_ptr(),
        off.data_ptr(), *map(_ptr, (k_new_scales, v_new_scales, k_scales, v_scales)),
        out.data_ptr(), scratch.data_ptr(), B, N, Nkv, NB, BS, tables.shape[1], int(layer), hd,
        int(q.dtype == torch.bfloat16), int(kv8), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, "paged_append")
    LAUNCHES["paged_append_kv8" if kv8 else "paged_append"] += 1
    return out


def paged_append_attention(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
                           k_new_scales=None, v_new_scales=None, k_scales=None,
                           v_scales=None, *, scale=None):
    """B4: append each row's new K/V into the pools IN PLACE at
    ``pool[layer, blk, off]`` and return its decode attention (B, N, hd)
    over the row's block table (see the module docstring)."""
    refuse_autograd("B4 (paged_append_attention)", q, k_new, v_new, k_pool, v_pool,
                    k_new_scales, v_new_scales, k_scales, v_scales)
    _check(q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
           k_new_scales, v_new_scales, k_scales, v_scales)
    args = (q, k_new, v_new, k_pool, v_pool, tables, lens, blk, off, layer,
            k_new_scales, v_new_scales, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_append_attention_ref(*args, scale=scale)
    return _launch(*args, scale)


# ---------------------------------------------------------------------------
# B5 (Sq-token verify with the append) and B6 (decode over one layer's pool)
# ---------------------------------------------------------------------------

def _check_verify(q, k_new, v_new, k_pool, v_pool, tables, lens, layer, k_new_scales,
                  v_new_scales, k_scales, v_scales):
    if q.dim() != 4 or k_new.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"expected q (B, Sq, N, hd), k_new (B, Sq, Nkv, hd) and pools "
                         f"(L, NB, BS, Nkv*hd); got {tuple(q.shape)}, {tuple(k_new.shape)}, "
                         f"{tuple(k_pool.shape)}")
    B, Sq, N, hd = q.shape
    Nkv = k_new.shape[2]
    L, NB, BS, KVL = k_pool.shape
    if (tuple(v_new.shape) != tuple(k_new.shape) or tuple(v_pool.shape) != tuple(k_pool.shape)
            or tuple(k_new.shape) != (B, Sq, Nkv, hd) or KVL != Nkv * hd):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k/v_new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if N % Nkv:
        raise ValueError(f"query heads {N} not a multiple of kv heads {Nkv}")
    if not 1 <= Sq <= BS:
        raise ValueError(f"Sq={Sq} new tokens a row, the contract takes 1..BS={BS}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range for L={L}")
    _check_types(q, k_new, v_new, k_pool, v_pool,
                 k_new_scales=(k_new_scales, (B, Sq, Nkv)),
                 v_new_scales=(v_new_scales, (B, Sq, Nkv)),
                 k_scales=(k_scales, (L, NB, BS, Nkv)), v_scales=(v_scales, (L, NB, BS, Nkv)))
    _check_rows(B, tables, lens, [q, k_new, v_new, k_pool, v_pool, tables, lens, k_new_scales,
                                  v_new_scales, k_scales, v_scales])


def _check_decode(q, k_pool, v_pool, tables, lens, k_scales, v_scales):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"expected q (B, N, hd) and pools (NB, BS, Nkv, hd); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}")
    B, N, hd = q.shape
    NB, BS, Nkv, hdk = k_pool.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) or hdk != hd:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if N % Nkv:
        raise ValueError(f"query heads {N} not a multiple of kv heads {Nkv}")
    _check_types(q, k_pool, v_pool, k_scales=(k_scales, (NB, BS, Nkv)),
                 v_scales=(v_scales, (NB, BS, Nkv)))
    _check_rows(B, tables, lens, [q, k_pool, v_pool, tables, lens, k_scales, v_scales])


def _attend_blocks(qs, k_pool, v_pool, k_scales, v_scales, tables, lens, Sq: int, rep: int,
                   rnd):
    """The TPU kernels' fp32 online softmax over each row's blocks in table
    order.  qs (B, Nkv, R, hd) fp32, R = Sq * rep, row r is query r // rep of
    query head r % rep of its group, scaled (and rounded); k_pool, v_pool
    (NB, BS, Nkv*hd) one layer (int8 with k_scales, v_scales (NB, BS, Nkv));
    query j of row b sees the slots <= lens[b] - Sq + j.  ``rnd`` rounds p
    (times the V scales) before p @ V.  -> (B, Nkv, R, hd) fp32."""
    B, Nkv, R, hd = qs.shape
    BS = k_pool.shape[1]
    dev = qs.device
    lens = lens.long()
    lim = (lens - Sq)[:, None] + torch.arange(R, device=dev)[None, :] // rep  # (B, R)
    m = torch.full((B, Nkv, R), NEG_INF, device=dev)
    den = torch.zeros((B, Nkv, R), device=dev)
    acc = torch.zeros((B, Nkv, R, hd), device=dev)
    ar = torch.arange(BS, device=dev)
    for i in range(tables.shape[1]):
        bid = tables[:, i].long()
        k = k_pool[bid].reshape(B, BS, Nkv, hd).float()
        v = v_pool[bid].reshape(B, BS, Nkv, hd).float()
        s = torch.einsum("bgrd,btgd->bgrt", qs, k)  # (B, Nkv, R, BS)
        if k_scales is not None:
            s = s * k_scales[bid].permute(0, 2, 1)[:, :, None, :]
        valid = (i * BS + ar)[None, None, :] <= lim[:, :, None]  # (B, R, BS)
        s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        p_v = p if v_scales is None else p * v_scales[bid].permute(0, 2, 1)[:, :, None, :]
        pv = torch.einsum("bgrt,btgd->bgrd", rnd(p_v), v)
        step = (lens > i * BS)[:, None, None]  # rows with context in this block
        den = torch.where(step, den * alpha + p.sum(dim=-1), den)
        acc = torch.where(step[..., None], acc * alpha[..., None] + pv, acc)
        m = torch.where(step, m_new, m)
    return acc / torch.where(den == 0, torch.ones_like(den), den)[..., None]


def _verify_slots(tables, lens, Sq: int, block_size: int):
    """(blk, off), each (B, Sq): where B5 appends new token j of row b, at
    slot lens[b] - Sq + j of its table; a slot past the table goes to dummy
    block 0, offset 0."""
    slots = (lens.long() - Sq)[:, None] + torch.arange(Sq, device=lens.device)[None, :]
    idx = slots // block_size
    inside = (slots >= 0) & (idx < tables.shape[1])
    blk = torch.gather(tables.long(), 1, idx.clamp(0, tables.shape[1] - 1))
    zero = torch.zeros_like(blk)
    return torch.where(inside, blk, zero), torch.where(inside, slots % block_size, zero)


def paged_verify_attention_ref(q, k_new, v_new, k_pool, v_pool, tables, lens, layer,
                               k_new_scales=None, v_new_scales=None, k_scales=None,
                               v_scales=None, *, scale=None):
    """Plain version of B5: the append, then the JAX kernel's arithmetic block
    by block in table order, vectorized over rows.  Updates the pools in
    place."""
    _check_verify(q, k_new, v_new, k_pool, v_pool, tables, lens, layer, k_new_scales,
                  v_new_scales, k_scales, v_scales)
    B, Sq, N, hd = q.shape
    Nkv = k_new.shape[2]
    rep = N // Nkv
    int8 = k_pool.dtype == torch.int8
    cdt = torch.bfloat16 if int8 else k_pool.dtype
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    l = int(layer)
    blk, off = _verify_slots(tables, lens, Sq, k_pool.shape[2])
    k_pool[l, blk, off] = k_new.reshape(B, Sq, -1)
    v_pool[l, blk, off] = v_new.reshape(B, Sq, -1)
    if int8:
        k_scales[l, blk, off] = k_new_scales
        v_scales[l, blk, off] = v_new_scales

    def rnd(x):  # round to the compute type, keep fp32
        return x.to(cdt).float()

    qs = rnd(q.float() * scale).reshape(B, Sq, Nkv, rep, hd).transpose(1, 2)
    o = _attend_blocks(qs.reshape(B, Nkv, Sq * rep, hd), k_pool[l], v_pool[l],
                       k_scales[l] if int8 else None, v_scales[l] if int8 else None,
                       tables, lens, Sq, rep, rnd)
    return o.reshape(B, Nkv, Sq, rep, hd).transpose(1, 2).reshape(B, Sq, N, hd).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, tables, lens, k_scales=None,
                               v_scales=None, *, scale=None):
    """Plain version of B6: the JAX kernel's arithmetic, all in f32, block by
    block in table order."""
    _check_decode(q, k_pool, v_pool, tables, lens, k_scales, v_scales)
    B, N, hd = q.shape
    NB, BS, Nkv, _ = k_pool.shape
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qs = (q.float() * scale).reshape(B, Nkv, N // Nkv, hd)
    o = _attend_blocks(qs, k_pool.reshape(NB, BS, Nkv * hd), v_pool.reshape(NB, BS, Nkv * hd),
                       k_scales, v_scales, tables, lens, 1, N // Nkv, lambda x: x)
    return o.reshape(B, N, hd).to(q.dtype)


def split_count(width: int, run: int) -> int:
    """The kv splits B4, B5 and B6 make of a block table ``width`` = max_blocks *
    BS slots wide, ``run`` slots each: a function of the width alone, never of
    lens (which live on the device), so a captured call stays valid as rows
    grow; a split whose run starts past its row's context does nothing."""
    return -(-width // run)


def _split_scratch(lib, B: int, Nkv: int, rows: int, width: int, hd: int, device):
    """The fp32 partials (acc, m, l) of every (row, kv head, query row of the
    group, split), merged by the combine launch."""
    splits = split_count(width, lib.vcla_paged_run())
    return torch.empty(B, Nkv, rows, splits, hd + 2, dtype=torch.float32, device=device)


def paged_verify_attention(q, k_new, v_new, k_pool, v_pool, tables, lens, layer,
                           k_new_scales=None, v_new_scales=None, k_scales=None,
                           v_scales=None, *, scale=None):
    """B5, the speculative verify step.  q (B, Sq, N, hd) rope applied; k_new,
    v_new (B, Sq, Nkv, hd) in the pool's type (int8 with k_new_scales /
    v_new_scales (B, Sq, Nkv) f32); pools, scale pools and tables as B4; lens
    (B,) the context length INCLUDING the Sq new tokens (``Sq <= BS``).  New
    token j goes to slot lens - Sq + j of the row's table (see
    ``_verify_slots``), IN PLACE, and query j attends over the slots <=
    lens - Sq + j.  Parked rows pass lens == Sq with a zeroed table: they
    write only dummy block 0, and their outputs are to be dropped.  Numerics
    as B4's old tokens for every token, the new ones included (their
    probabilities are rounded to the compute type too).  -> (B, Sq, N, hd)."""
    args = (q, k_new, v_new, k_pool, v_pool, tables, lens, layer, k_new_scales,
            v_new_scales, k_scales, v_scales)
    refuse_autograd("B5 (paged_verify_attention)", q, k_new, v_new, k_pool, v_pool,
                    k_new_scales, v_new_scales, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_verify_attention_ref(*args, scale=scale)
    _check_verify(*args)
    B, Sq, N, hd = q.shape
    Nkv = k_new.shape[2]
    L, NB, BS, _ = k_pool.shape
    default = _check_launch(hd, q=q, k_new=k_new, v_new=v_new, k_pool=k_pool,
                            v_pool=v_pool, k_new_scales=k_new_scales,
                            v_new_scales=v_new_scales, k_scales=k_scales, v_scales=v_scales)
    kv8 = k_pool.dtype == torch.int8
    _check_aligned(k_new=k_new, v_new=v_new, k_pool=k_pool, v_pool=v_pool)
    tables, lens = _i32(tables), _i32(lens)
    out = torch.empty_like(q)
    lib = build_kernels()
    scratch = _split_scratch(lib, B, Nkv, N // Nkv * Sq, tables.shape[1] * BS, hd, q.device)
    err = lib.vcla_paged_verify(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
        *map(_ptr, (k_new_scales, v_new_scales, k_scales, v_scales)), out.data_ptr(),
        scratch.data_ptr(), B, Sq, N, Nkv, NB, BS, tables.shape[1], int(layer), hd,
        int(q.dtype == torch.bfloat16), int(kv8), float(default if scale is None else scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, "paged_verify")
    LAUNCHES["paged_verify_kv8" if kv8 else "paged_verify"] += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, tables, lens, k_scales=None, v_scales=None, *,
                           scale=None):
    """B6: decode attention without an append over ONE layer's pool.  q
    (B, N, hd); k_pool, v_pool (NB, BS, Nkv, hd) in q's type or int8 with
    k_scales / v_scales (NB, BS, Nkv) f32; tables (B, max_blocks); lens (B,)
    the valid tokens a row (slots < lens[b]).  All arithmetic in f32 (q *
    scale and p are not rounded); a row with lens 0 gives zeros.
    -> (B, N, hd) in q's type."""
    args = (q, k_pool, v_pool, tables, lens, k_scales, v_scales)
    refuse_autograd("B6 (paged_decode_attention)", q, k_pool, v_pool, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(*args, scale=scale)
    _check_decode(*args)
    B, N, hd = q.shape
    NB, BS, Nkv, _ = k_pool.shape
    default = _check_launch(hd, q=q, k_pool=k_pool, v_pool=v_pool, k_scales=k_scales,
                            v_scales=v_scales)
    kv8 = k_pool.dtype == torch.int8
    tables, lens = _i32(tables), _i32(lens)
    out = torch.empty_like(q)
    lib = build_kernels()
    scratch = _split_scratch(lib, B, Nkv, N // Nkv, tables.shape[1] * BS, hd, q.device)
    err = lib.vcla_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), _ptr(k_scales), _ptr(v_scales), out.data_ptr(), scratch.data_ptr(),
        B, N, Nkv, NB, BS,
        tables.shape[1], hd, int(q.dtype == torch.bfloat16), int(kv8),
        float(default if scale is None else scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, lib, "paged_decode")
    LAUNCHES["paged_decode_kv8" if kv8 else "paged_decode"] += 1
    return out
