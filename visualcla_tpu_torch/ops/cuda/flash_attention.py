"""Flash attention over one layer of the stacked KV cache: the CUDA kernels
B1 (decode) and B2 (prefill), their plain PyTorch versions, and the wrappers.

B1 ``flash_decode_stacked`` replaces ``_flash_decode_stacked`` ->
``_decode_kernel`` and B2 ``flash_prefill_stacked`` replaces ``_flash_stacked``
-> ``_flash_kernel(stacked=True)`` (visualcla_tpu/ops/pallas/flash_attention.py).
The kernels live in ``csrc/flash_attention.cu``; its header says what bounds
each one on the card (decode: cache bytes; prefill: flops) and what the design
does about it.

Contract (both): q (B, Sq, N, hd); k_cache, v_cache (L, B, Nkv, S, hd), read
at ``layer_index`` in place, in q's dtype, or int8 with ``k_scale`` /
``v_scale`` (L, B, Nkv, S) f32 per-slot scales (the int8 KV cache; the
kernel folds them in after the dots, the plain version dequantizes in fp32);
kv_valid (B, S) bool; write_slot an int or a () or (B,) integer tensor.
Query i of row b sits at slot ``write_slot[b] + i`` and sees kv slot j iff ``kv_valid[b, j]`` and ``j <= write_slot[b] + i``.
Query head n reads kv head ``n // (N // Nkv)``.  Softmax in fp32; a fully
masked query row gives zeros (the dense ``cached_attention`` of the JAX
package gives the mean of V there instead).  Output (B, Sq, N, hd) in q's
dtype.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, the int8
K/V launches under their own names (``flash_decode_kv8``, ``flash_prefill_kv8``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (128,)  # every LLaMA size in core/config.py
LAUNCHES = {"flash_decode": 0, "flash_prefill": 0, "flash_decode_kv8": 0,
            "flash_prefill_kv8": 0}

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
        lib.vcla_flash_decode.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,  # q k v kv_valid slots out
            i32, i32, i32, i32, i32, i32,  # B N Nkv S hd is_bf16
            ctypes.c_float, ptr]  # scale stream
        lib.vcla_flash_decode.restype = i32
        lib.vcla_flash_prefill.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32,  # B Sq N Nkv S hd is_bf16
            ctypes.c_float, ptr]
        lib.vcla_flash_prefill.restype = i32
        lib.vcla_flash_decode_kv8.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # q k v ks vs kv_valid slots out
            i32, i32, i32, i32, i32, i32,  # B N Nkv S hd is_bf16
            ctypes.c_float, ptr]
        lib.vcla_flash_decode_kv8.restype = i32
        lib.vcla_flash_prefill_kv8.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32,  # B Sq N Nkv S hd is_bf16
            ctypes.c_float, ptr]
        lib.vcla_flash_prefill_kv8.restype = i32
        lib.vcla_error_string.argtypes = [i32]
        lib.vcla_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# argument checks shared by the wrappers and the plain versions
# ---------------------------------------------------------------------------

def _check(q, k_cache, v_cache, kv_valid, layer_index, decode: bool,
           k_scale=None, v_scale=None):
    if q.dim() != 4 or k_cache.dim() != 5 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"expected q (B, Sq, N, hd) and stacked k/v (L, B, Nkv, S, hd); got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Sq, N, hd = q.shape
    L, Bk, Nkv, S, hdk = k_cache.shape
    if Bk != B or hdk != hd:
        raise ValueError(f"q {tuple(q.shape)} does not match cache {tuple(k_cache.shape)}")
    if N % Nkv:
        raise ValueError(f"query heads {N} not a multiple of kv heads {Nkv}")
    if decode and Sq != 1:
        raise ValueError(f"decode takes one query per row, got Sq={Sq}")
    if tuple(kv_valid.shape) != (B, S):
        raise ValueError(f"kv_valid {tuple(kv_valid.shape)} != {(B, S)}")
    if not 0 <= int(layer_index) < L:
        raise ValueError(f"layer_index {layer_index} out of range for L={L}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if k_scale is None:
        if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
            raise TypeError(f"q {q.dtype} and cache {k_cache.dtype}/{v_cache.dtype} differ")
    else:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError(f"scales given with a {k_cache.dtype}/{v_cache.dtype} cache, "
                            "expected int8")
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != (L, B, Nkv, S) or sc.dtype != torch.float32:
                raise ValueError(f"{name} {sc.dtype} {tuple(sc.shape)}, expected float32 "
                                 f"{(L, B, Nkv, S)}")
    devices = {q.device, k_cache.device, v_cache.device, kv_valid.device}
    if k_scale is not None:
        devices |= {k_scale.device, v_scale.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


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

def _attend_ref(q, k_cache, v_cache, kv_valid, write_slot, layer_index, scale,
                k_scale=None, v_scale=None):
    B, Sq, N, hd = q.shape
    Nkv, S = k_cache.shape[2], k_cache.shape[3]
    rep = N // Nkv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    l = int(layer_index)
    k, v = k_cache[l].float(), v_cache[l].float()
    if k_scale is not None:  # int8 K/V: dequantize in fp32
        k, v = k * k_scale[l][..., None], v * v_scale[l][..., None]
    # query head n reads kv head n // rep
    k = k[:, :, None].expand(B, Nkv, rep, S, hd).reshape(B, N, S, hd)
    v = v[:, :, None].expand(B, Nkv, rep, S, hd).reshape(B, N, S, hd)
    qf = q.float().transpose(1, 2) * scale  # (B, N, Sq, hd)
    s = qf @ k.transpose(-1, -2)  # (B, N, Sq, S)
    slots = slot_vector(write_slot, B, q.device).long()
    q_slot = slots[:, None] + torch.arange(Sq, device=q.device)[None, :]  # (B, Sq)
    kv_slot = torch.arange(S, device=q.device)
    ok = kv_valid.bool()[:, None, :] & (kv_slot[None, None, :] <= q_slot[:, :, None])
    ok = ok[:, None]  # (B, 1, Sq, S)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ v) / torch.where(l == 0, torch.ones_like(l), l)
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, N, hd)


def flash_decode_stacked_ref(q, k_cache, v_cache, kv_valid, write_slot,
                             layer_index, *, scale=None, k_scale=None, v_scale=None):
    """Plain version of B1 (Sq == 1)."""
    _check(q, k_cache, v_cache, kv_valid, layer_index, True, k_scale, v_scale)
    return _attend_ref(q, k_cache, v_cache, kv_valid, write_slot, layer_index, scale,
                       k_scale, v_scale)


def flash_prefill_stacked_ref(q, k_cache, v_cache, kv_valid, write_slot,
                              layer_index, *, scale=None, k_scale=None, v_scale=None):
    """Plain version of B2 (any Sq)."""
    _check(q, k_cache, v_cache, kv_valid, layer_index, False, k_scale, v_scale)
    return _attend_ref(q, k_cache, v_cache, kv_valid, write_slot, layer_index, scale,
                       k_scale, v_scale)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _launch(fn_name, q, k_cache, v_cache, kv_valid, write_slot, layer_index, scale,
            k_scale=None, v_scale=None):
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")
    B, Sq, N, hd = q.shape
    Nkv, S = k_cache.shape[2], k_cache.shape[3]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel takes bfloat16 or float32, got {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel head dims are {KERNEL_HEAD_DIMS}, got {hd}")
    named = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("kv_valid", kv_valid)]
    if k_scale is not None:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    valid = kv_valid.view(torch.uint8) if kv_valid.dtype == torch.bool \
        else kv_valid.to(torch.uint8)
    slots = slot_vector(write_slot, B, q.device)
    # one layer of the stacked cache: a view at an offset, no copy
    k = k_cache[int(layer_index)]
    v = v_cache[int(layer_index)]
    if q.device.index != torch.cuda.current_device():
        # the library launches on the thread's current device
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build_kernels()
    is_bf16 = int(q.dtype == torch.bfloat16)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if k_scale is not None:
        fn_name += "_kv8"
        ptrs += (k_scale[int(layer_index)].data_ptr(), v_scale[int(layer_index)].data_ptr())
    ptrs += (valid.data_ptr(), slots.data_ptr(), out.data_ptr())
    shape = (B, N, Nkv, S) if fn_name.startswith("flash_decode") else (B, Sq, N, Nkv, S)
    err = getattr(lib, "vcla_" + fn_name)(*ptrs, *shape, hd, is_bf16, float(scale), stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} kernel launch failed: {lib.vcla_error_string(err).decode()}")
    LAUNCHES[fn_name] += 1
    return out


def flash_decode_stacked(q, k_cache, v_cache, kv_valid, write_slot, layer_index,
                         *, scale=None, k_scale=None, v_scale=None):
    """B1: decode attention (Sq == 1) over layer ``layer_index`` of the cache."""
    _check(q, k_cache, v_cache, kv_valid, layer_index, True, k_scale, v_scale)
    if q.device.type == "cpu":
        return _attend_ref(q, k_cache, v_cache, kv_valid, write_slot, layer_index, scale,
                           k_scale, v_scale)
    return _launch("flash_decode", q, k_cache, v_cache, kv_valid, write_slot,
                   layer_index, scale, k_scale, v_scale)


def flash_prefill_stacked(q, k_cache, v_cache, kv_valid, write_slot, layer_index,
                          *, scale=None, k_scale=None, v_scale=None):
    """B2: causal attention of Sq queries over layer ``layer_index`` of the cache."""
    _check(q, k_cache, v_cache, kv_valid, layer_index, False, k_scale, v_scale)
    if q.device.type == "cpu":
        return _attend_ref(q, k_cache, v_cache, kv_valid, write_slot, layer_index, scale,
                           k_scale, v_scale)
    return _launch("flash_prefill", q, k_cache, v_cache, kv_valid, write_slot,
                   layer_index, scale, k_scale, v_scale)
