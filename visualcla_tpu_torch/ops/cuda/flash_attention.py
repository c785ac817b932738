"""Flash attention: the CUDA kernels B1 (decode over the stacked cache), B2
(prefill over the stacked cache) and B2u (attention over unstacked K/V,
causal or not), their plain PyTorch versions, and the wrappers.

B1 ``flash_decode_stacked`` replaces ``_flash_decode_stacked`` ->
``_decode_kernel``, B2 ``flash_prefill_stacked`` replaces ``_flash_stacked``
-> ``_flash_kernel(stacked=True)`` and B2u ``flash_attention`` replaces
``_flash_attention_jit`` -> ``_flash_kernel(stacked=False)``
(visualcla_tpu/ops/pallas/flash_attention.py).  The kernels live in
``csrc/flash_attention.cu``, where B2 and B2u are one template; its header
says what bounds each one on the card and what the design does about it.

Contract (B1, B2): q (B, Sq, N, hd); k_cache, v_cache (L, B, Nkv, S, hd),
read at ``layer_index`` in place, in q's dtype, or int8 with ``k_scale`` /
``v_scale`` (L, B, Nkv, S) f32 per-slot scales (the int8 KV cache; the
kernel folds them in after the dots, the plain version dequantizes in fp32);
kv_valid (B, S) bool; write_slot an int or a () or (B,) integer tensor.
Query i of row b sits at slot ``write_slot[b] + i`` and sees kv slot j iff ``kv_valid[b, j]`` and ``j <= write_slot[b] + i``.
Query head n reads kv head ``n // (N // Nkv)``.  Softmax in fp32; a fully
masked query row gives zeros (the dense ``cached_attention`` of the JAX
package gives the mean of V there instead).  Output (B, Sq, N, hd) in q's
dtype.  B2u (``flash_attention``) takes the same arguments over one
unstacked K/V, (B, S, Nkv, hd) "bsnh" or (B, Nkv, S, hd) "bnsh" with scales
(B, S, Nkv) or (B, Nkv, S), and ``causal`` on or off (off: every valid slot
is seen); the kernel reads K/V through their strides, so the ViT's bsnh
K/V straight out of a ``reshape`` are not copied.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``LAUNCHES`` counts one per wrapper call that
reached its kernel (B1 is two device launches, the kv splits and their
combine, and counts one), the int8 K/V calls under their own names
(``flash_decode_kv8``, ``flash_prefill_kv8``, ``flash_full_kv8``).  With q in
bf16 B2 / B2u run on the tensor cores and need 16-byte aligned q, K and V rows;
with q in f32 they run the fp32 kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)  # the ViT and resampler heads, and LLaMA's
# The block of the bf16 B2 / B2u kernel: 1 = one warpgroup (64 query rows),
# 2 = two warpgroups (128 query rows), 3 = two warpgroups that share 64 query
# rows and split the kv axis.  None picks what measured faster on the H100
# (``_tiling``); a number forces it (``bench_flash.py`` times all three).
TILING = None
LAUNCHES = {"flash_decode": 0, "flash_prefill": 0, "flash_decode_kv8": 0,
            "flash_prefill_kv8": 0, "flash_full": 0, "flash_full_kv8": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library."""
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        ptr = ctypes.c_void_p
        i32 = ctypes.c_int
        i64 = ctypes.c_longlong
        lib.vcla_flash_decode_splits.argtypes = [i32]  # S
        lib.vcla_flash_decode_splits.restype = i32
        lib.vcla_flash_decode.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q k v ks vs kv_valid slots out scratch
            i32, i32, i32, i32, i32, i32, i32,  # B N Nkv S hd is_bf16 kv_int8
            ctypes.c_float, ptr]  # scale stream
        lib.vcla_flash_decode.restype = i32
        lib.vcla_flash_attention.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            # B Sq N Nkv S hd is_bf16 kv_int8 causal tiling
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            *[i64] * 12,  # (row, slot, head) strides of q, k, v and the scales
            ctypes.c_float, ptr]
        lib.vcla_flash_attention.restype = i32
        lib.vcla_error_string.argtypes = [i32]
        lib.vcla_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers and the plain versions
# ---------------------------------------------------------------------------

def _check_common(q, k, v, kv_valid, B, S, Nkv, hd, k_scale, v_scale, scale_shape):
    if q.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, Sq, N, hd) and k, v of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != B or q.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if q.shape[2] % Nkv:
        raise ValueError(f"query heads {q.shape[2]} not a multiple of kv heads {Nkv}")
    if tuple(kv_valid.shape) != (B, S):
        raise ValueError(f"kv_valid {tuple(kv_valid.shape)} != {(B, S)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"q {q.dtype} and k/v {k.dtype}/{v.dtype} differ")
    else:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError(f"scales given with {k.dtype}/{v.dtype} k/v, expected int8")
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != scale_shape or sc.dtype != torch.float32:
                raise ValueError(f"{name} {sc.dtype} {tuple(sc.shape)}, expected float32 "
                                 f"{scale_shape}")
    devices = {q.device, k.device, v.device, kv_valid.device}
    if k_scale is not None:
        devices |= {k_scale.device, v_scale.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def _check(q, k_cache, v_cache, kv_valid, layer_index, decode: bool,
           k_scale=None, v_scale=None):
    if q.dim() != 4 or k_cache.dim() != 5:
        raise ValueError(
            f"expected q (B, Sq, N, hd) and stacked k/v (L, B, Nkv, S, hd); got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    L, B, Nkv, S, hd = k_cache.shape
    _check_common(q, k_cache, v_cache, kv_valid, B, S, Nkv, hd, k_scale, v_scale,
                  (L, B, Nkv, S))
    if decode and q.shape[1] != 1:
        raise ValueError(f"decode takes one query per row, got Sq={q.shape[1]}")
    if not 0 <= int(layer_index) < L:
        raise ValueError(f"layer_index {layer_index} out of range for L={L}")


def _check_full(q, k, v, kv_valid, k_scale, v_scale, kv_layout):
    if kv_layout not in ("bsnh", "bnsh"):
        raise ValueError(f"kv_layout must be 'bsnh' or 'bnsh', got {kv_layout!r}")
    if k.dim() != 4:
        raise ValueError(f"expected {kv_layout} k/v of 4 dims, got {tuple(k.shape)}")
    if kv_layout == "bsnh":
        B, S, Nkv, hd = k.shape
        scale_shape = (B, S, Nkv)
    else:
        B, Nkv, S, hd = k.shape
        scale_shape = (B, Nkv, S)
    _check_common(q, k, v, kv_valid, B, S, Nkv, hd, k_scale, v_scale, scale_shape)


def slot_vector(write_slot, B: int, device) -> torch.Tensor:
    """write_slot (int, () or (B,)) -> contiguous (B,) int32 on ``device``."""
    if not isinstance(write_slot, torch.Tensor):
        return torch.full((B,), int(write_slot), dtype=torch.int32, device=device)
    ws = write_slot.to(device=device, dtype=torch.int32).reshape(-1)
    if ws.numel() not in (1, B):
        raise ValueError(f"write_slot has {ws.numel()} entries for {B} rows")
    return ws.expand(B).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' contract, any device)
# ---------------------------------------------------------------------------

def _attend_ref(q, k, v, kv_valid, write_slot, scale, k_scale=None, v_scale=None,
                causal=True):
    """The kernels' arithmetic on one bnsh K/V (B, Nkv, S, hd), scales (B, Nkv, S)."""
    B, Sq, N, hd = q.shape
    Nkv, S = k.shape[1], k.shape[2]
    rep = N // Nkv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    k, v = k.float(), v.float()
    if k_scale is not None:  # int8 K/V: dequantize in fp32
        k, v = k * k_scale[..., None], v * v_scale[..., None]
    # query head n reads kv head n // rep
    k = k[:, :, None].expand(B, Nkv, rep, S, hd).reshape(B, N, S, hd)
    v = v[:, :, None].expand(B, Nkv, rep, S, hd).reshape(B, N, S, hd)
    qf = q.float().transpose(1, 2) * scale  # (B, N, Sq, hd)
    s = qf @ k.transpose(-1, -2)  # (B, N, Sq, S)
    ok = kv_valid.bool()[:, None, :].expand(B, Sq, S)
    if causal:
        slots = slot_vector(write_slot, B, q.device).long()
        q_slot = slots[:, None] + torch.arange(Sq, device=q.device)[None, :]  # (B, Sq)
        ok = ok & (torch.arange(S, device=q.device)[None, None, :] <= q_slot[:, :, None])
    ok = ok[:, None]  # (B, 1, Sq, S)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ v) / torch.where(l == 0, torch.ones_like(l), l)
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, N, hd)


def _layer(k_cache, v_cache, k_scale, v_scale, layer_index):
    """One layer of the stacked cache and its scales: views, no copy."""
    l = int(layer_index)
    return (k_cache[l], v_cache[l], None if k_scale is None else k_scale[l],
            None if v_scale is None else v_scale[l])


def flash_decode_stacked_ref(q, k_cache, v_cache, kv_valid, write_slot,
                             layer_index, *, scale=None, k_scale=None, v_scale=None):
    """Plain version of B1 (Sq == 1)."""
    _check(q, k_cache, v_cache, kv_valid, layer_index, True, k_scale, v_scale)
    k, v, ks, vs = _layer(k_cache, v_cache, k_scale, v_scale, layer_index)
    return _attend_ref(q, k, v, kv_valid, write_slot, scale, ks, vs)


def flash_prefill_stacked_ref(q, k_cache, v_cache, kv_valid, write_slot,
                              layer_index, *, scale=None, k_scale=None, v_scale=None):
    """Plain version of B2 (any Sq)."""
    _check(q, k_cache, v_cache, kv_valid, layer_index, False, k_scale, v_scale)
    k, v, ks, vs = _layer(k_cache, v_cache, k_scale, v_scale, layer_index)
    return _attend_ref(q, k, v, kv_valid, write_slot, scale, ks, vs)


def _to_bnsh(k, v, k_scale, v_scale, kv_layout):
    """bsnh K/V (B, S, Nkv, hd) and scales (B, S, Nkv) as bnsh views."""
    if kv_layout == "bnsh":
        return k, v, k_scale, v_scale
    return (k.transpose(1, 2), v.transpose(1, 2),
            None if k_scale is None else k_scale.transpose(1, 2),
            None if v_scale is None else v_scale.transpose(1, 2))


def flash_attention_ref(q, k, v, kv_valid, write_slot, *, scale=None, causal=True,
                        k_scale=None, v_scale=None, kv_layout="bsnh"):
    """Plain version of B2u: the kernel's fp32 arithmetic on any device."""
    _check_full(q, k, v, kv_valid, k_scale, v_scale, kv_layout)
    k, v, k_scale, v_scale = _to_bnsh(k, v, k_scale, v_scale, kv_layout)
    return _attend_ref(q, k, v, kv_valid, write_slot, scale, k_scale, v_scale, causal)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch_checks(q, hd, named):
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bfloat16 or float32, got {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head dims are {KERNEL_HEAD_DIMS}, got {hd}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.index != torch.cuda.current_device():
        # the library launches on the thread's current device
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _valid_u8(kv_valid):
    return (kv_valid.view(torch.uint8) if kv_valid.dtype == torch.bool
            else kv_valid.to(torch.uint8)).contiguous()


def _raise_on(err, fn_name):
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: "
                           f"{build_kernels().vcla_error_string(err).decode()}")


def _tiling(q, kv8: bool) -> int:
    """The bf16 kernel's block for this call: the kv split when 64-row blocks
    would be fewer than the card's SMs (the ViT and the resampler at B = 1, the
    speculative verify: one block's chain of kv tiles sets the time there),
    128-row blocks with int8 K/V (both warpgroups share a tile's int8 -> bf16
    pass), else 64-row blocks."""
    if TILING is not None:
        return TILING
    B, Sq, N, _ = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if -(-Sq // 64) * N * B < sms:
        return 3
    return 2 if kv8 else 1


def _launch_attention(name, q, k, v, kv_valid, write_slot, scale, causal, k_scale, v_scale):
    """B2 / B2u on bnsh views k, v (B, Nkv, S, hd), scales (B, Nkv, S), any
    strides with a contiguous last axis; counted under ``name`` (+ ``_kv8``)."""
    B, Sq, N, hd = q.shape
    Nkv, S = k.shape[1], k.shape[2]
    _launch_checks(q, hd, [("q", q)])
    for t_name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{t_name}'s head-dim axis must be contiguous")
    kv8 = k_scale is not None
    if kv8 and k_scale.stride() != v_scale.stride():  # the kernel takes one set of strides
        k_scale, v_scale = k_scale.contiguous(), v_scale.contiguous()
    out = torch.empty_like(q)
    valid, slots = _valid_u8(kv_valid), slot_vector(write_slot, B, q.device)
    # strides (row, slot, head) of q (B, Sq, N, hd), of k/v and of the scales
    q_st = (q.stride(0), q.stride(1), q.stride(2))
    k_st = (k.stride(0), k.stride(2), k.stride(1))
    v_st = (v.stride(0), v.stride(2), v.stride(1))
    sc_st = (k_scale.stride(0), k_scale.stride(2), k_scale.stride(1)) if kv8 else (0, 0, 0)
    if max(q_st[1], k_st[1], v_st[1], sc_st[1]) >= 2 ** 31:
        raise ValueError("the kernel takes 32-bit slot strides")
    if q.dtype == torch.bfloat16:  # the tensor-core kernel copies rows 16 bytes at a time
        for t_name, t, st in (("q", q, q_st), ("k", k, k_st), ("v", v, v_st)):
            if t.data_ptr() % 16 or any(n * t.element_size() % 16 for n in st):
                raise ValueError(f"{t_name}: the bf16 kernel needs 16-byte aligned rows "
                                 f"(data_ptr and (row, slot, head) strides {st})")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    lib = build_kernels()
    err = lib.vcla_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if kv8 else None, v_scale.data_ptr() if kv8 else None,
        valid.data_ptr(), slots.data_ptr(), out.data_ptr(),
        B, Sq, N, Nkv, S, hd, int(q.dtype == torch.bfloat16), int(kv8), int(causal),
        _tiling(q, kv8), *q_st, *k_st, *v_st, *sc_st, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    name += "_kv8" if kv8 else ""
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def _launch_decode(q, k, v, kv_valid, write_slot, scale, k_scale, v_scale):
    """B1 on one layer k, v (B, Nkv, S, hd), scales (B, Nkv, S), contiguous."""
    B, _, N, hd = q.shape
    Nkv, S = k.shape[1], k.shape[2]
    named = [("q", q), ("k", k), ("v", v)]
    kv8 = k_scale is not None
    if kv8:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    _launch_checks(q, hd, named)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    valid, slots = _valid_u8(kv_valid), slot_vector(write_slot, B, q.device)
    lib = build_kernels()
    # each kv split's partial (acc, m, l); the split count depends on S alone
    # (no host read of the slots: the call stays capturable in a CUDA graph)
    scratch = torch.empty((B, N, lib.vcla_flash_decode_splits(S), hd + 2),
                          dtype=torch.float32, device=q.device)
    err = lib.vcla_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if kv8 else None, v_scale.data_ptr() if kv8 else None,
        valid.data_ptr(), slots.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        B, N, Nkv, S, hd, int(q.dtype == torch.bfloat16), int(kv8), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    name = "flash_decode_kv8" if kv8 else "flash_decode"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def flash_decode_stacked(q, k_cache, v_cache, kv_valid, write_slot, layer_index,
                         *, scale=None, k_scale=None, v_scale=None):
    """B1: decode attention (Sq == 1) over layer ``layer_index`` of the cache."""
    _check(q, k_cache, v_cache, kv_valid, layer_index, True, k_scale, v_scale)
    k, v, ks, vs = _layer(k_cache, v_cache, k_scale, v_scale, layer_index)
    if q.device.type == "cpu":
        return _attend_ref(q, k, v, kv_valid, write_slot, scale, ks, vs)
    return _launch_decode(q, k, v, kv_valid, write_slot, scale, ks, vs)


def flash_prefill_stacked(q, k_cache, v_cache, kv_valid, write_slot, layer_index,
                          *, scale=None, k_scale=None, v_scale=None):
    """B2: causal attention of Sq queries over layer ``layer_index`` of the cache."""
    _check(q, k_cache, v_cache, kv_valid, layer_index, False, k_scale, v_scale)
    k, v, ks, vs = _layer(k_cache, v_cache, k_scale, v_scale, layer_index)
    if q.device.type == "cpu":
        return _attend_ref(q, k, v, kv_valid, write_slot, scale, ks, vs)
    return _launch_attention("flash_prefill", q, k, v, kv_valid, write_slot, scale, True,
                             ks, vs)


def flash_attention(q, k, v, kv_valid, write_slot, *, scale=None, causal=True,
                    k_scale=None, v_scale=None, kv_layout="bsnh"):
    """B2u: attention of q (B, Sq, N, hd) over one unstacked K/V, bsnh
    (B, S, Nkv, hd) or bnsh (B, Nkv, S, hd), causal or not, the JAX entry's
    contract.  As there, Sq == 1 with causal bnsh K/V goes to B1 (on the
    K/V viewed as a one-layer cache)."""
    _check_full(q, k, v, kv_valid, k_scale, v_scale, kv_layout)
    if q.shape[1] == 1 and causal and kv_layout == "bnsh":
        return flash_decode_stacked(
            q, k[None], v[None], kv_valid, write_slot, 0, scale=scale,
            k_scale=None if k_scale is None else k_scale[None],
            v_scale=None if v_scale is None else v_scale[None])
    k, v, k_scale, v_scale = _to_bnsh(k, v, k_scale, v_scale, kv_layout)
    if q.device.type == "cpu":
        return _attend_ref(q, k, v, kv_valid, write_slot, scale, k_scale, v_scale, causal)
    return _launch_attention("flash_full", q, k, v, kv_valid, write_slot, scale, causal,
                             k_scale, v_scale)
