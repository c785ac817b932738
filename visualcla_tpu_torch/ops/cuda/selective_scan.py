"""Mamba-1's causal depthwise convolution and selective scan: the CUDA kernel
B8, its plain PyTorch versions, and the wrappers.

B8 replaces no TPU kernel (the JAX package has no state-space layers); the
kernels live in ``csrc/selective_scan.cu``, whose header gives the
equations (transformers' ``JambaMambaMixer.slow_forward``), what bounds
each form and what the design does about it.

Two forms, both carrying state between calls:

- chunk (admissions): ``conv_chunk(x, weight, bias, state, lens)`` and
  ``scan_chunk(u, dt, dt_bias, A_log, B, C, D, z, state, lens)`` over (rows, W)
  positions; a row's positions at or past ``lens[row]`` leave both states
  as they were (dt = 0 there; the conv state keeps the last 3 real inputs),
  so a right-padded prompt's 256-token chunks chain, and the state kept is
  the one at the last real token;
- step (decode): ``conv_step(x, weight, bias, state, run)`` and
  ``scan_step(...)`` for one token a row, masked by the pass's ``run``
  vector: a row that does not run keeps its state unwritten.

``dt`` is dt_proj's product without its bias: the bias is added in f32
before softplus, as Mamba's kernels take it (``delta_bias``), since dt's
bias (-2.3 .. -6.9) rounded with the product to bf16 would move a small dt
by a few percent.  The conv state (rows, D, 3) holds the last three inputs
in the model's dtype; the SSM state (rows, D, N) is f32.  Both are updated in place.  The
kernel computes in f32 from bf16 inputs and writes bf16 outputs; the plain
versions compute in f32 in the inputs' dtype and run on the CPU.  A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

LAUNCHES = {"selective_conv_chunk": 0, "selective_conv_step": 0, "selective_scan_chunk": 0,
            "selective_scan_step": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("selective_scan")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.vcla_selective_conv_chunk.argtypes = [ptr, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr,
                                                  i32, i32, i32, ptr]
        lib.vcla_selective_conv_step.argtypes = [ptr, i64, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
        lib.vcla_selective_scan.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ptr,
                                            ptr, ptr, i32, i32, i32, i32, i32, ptr]
        for f in (lib.vcla_selective_conv_chunk, lib.vcla_selective_conv_step,
                  lib.vcla_selective_scan):
            f.restype = i32
        lib.vcla_selective_scan_error_string.argtypes = [i32]
        lib.vcla_selective_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{build_kernels().vcla_selective_scan_error_string(err).decode()}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _rows_view(x: torch.Tensor):
    """(B, W, D) whose last dim is contiguous -> its (batch, position) strides."""
    if x.stride(-1) != 1:
        raise ValueError("the channels must be contiguous")
    return x.stride(0), x.stride(1)


def _bf16(*ts):
    for t in ts:
        if t is not None and (t.dtype != torch.bfloat16 or not t.is_cuda):
            raise TypeError(f"B8 takes bfloat16 CUDA tensors, got {t.dtype} on {t.device}")


# -- the causal depthwise convolution + SiLU ----------------------------------

def conv_chunk_ref(x, weight, bias, state, lens):
    """Plain chunk form: x (B, W, D), weight (D, 4), bias (D) or None, state
    (B, D, 3) (updated in place), lens (B,).  -> u (B, W, D)."""
    B, W, D = x.shape
    xx = torch.cat([state.transpose(1, 2).to(x.dtype), x], dim=1).float()  # (B, 3 + W, D)
    y = sum(weight[:, j].float() * xx[:, j:j + W] for j in range(4))
    if bias is not None:
        y = y + bias.float()
    t = torch.arange(W, device=x.device)
    keep = t[None, :] < lens.to(x.device)[:, None]
    u = torch.where(keep[..., None], F.silu(y), torch.zeros_like(y)).to(x.dtype)
    idx = (lens.to(x.device).long()[:, None] + torch.arange(3, device=x.device)[None])  # (B, 3)
    state.copy_(torch.gather(xx, 1, idx[..., None].expand(B, 3, D)).transpose(1, 2)
                .to(state.dtype))
    return u


def conv_chunk(x, weight, bias, state, lens):
    if x.device.type == "cpu":
        return conv_chunk_ref(x, weight, bias, state, lens)
    _bf16(x, weight, bias, state)
    B, W, D = x.shape
    sb, st = _rows_view(x)
    u = torch.empty(B, W, D, dtype=x.dtype, device=x.device)
    out = torch.empty_like(state)
    w, n = weight.contiguous(), lens.to(torch.int32)  # held until the launch is queued
    err = build_kernels().vcla_selective_conv_chunk(
        x.data_ptr(), sb, st, w.data_ptr(), 0 if bias is None else bias.data_ptr(),
        state.data_ptr(), out.data_ptr(), n.data_ptr(), u.data_ptr(), B, W, D, _stream(x))
    _raise("selective_conv_chunk", err)
    state.copy_(out)
    return u


def conv_step_ref(x, weight, bias, state, run):
    """Plain step form: x (B, D), state (B, D, 3) updated where ``run``.
    -> u (B, D), 0 for rows that do not run."""
    xx = torch.cat([state.to(x.dtype), x[..., None]], dim=-1).float()  # (B, D, 4)
    y = (xx * weight.float()).sum(-1)
    if bias is not None:
        y = y + bias.float()
    r = run.to(x.device).bool()
    state.copy_(torch.where(r[:, None, None], xx[..., 1:].to(state.dtype), state))
    return torch.where(r[:, None], F.silu(y), torch.zeros_like(y)).to(x.dtype)


def conv_step(x, weight, bias, state, run):
    if x.device.type == "cpu":
        return conv_step_ref(x, weight, bias, state, run)
    _bf16(x, weight, bias, state)
    B, D = x.shape
    if x.stride(-1) != 1:
        raise ValueError("the channels must be contiguous")
    u = torch.empty(B, D, dtype=x.dtype, device=x.device)
    w, r = weight.contiguous(), run.to(torch.int32)
    err = build_kernels().vcla_selective_conv_step(
        x.data_ptr(), x.stride(0), w.data_ptr(), 0 if bias is None else bias.data_ptr(),
        state.data_ptr(), r.data_ptr(), u.data_ptr(), B, D, _stream(x))
    _raise("selective_conv_step", err)
    return u


# -- the selective scan --------------------------------------------------------

def scan_ref(u, dt, dt_bias, A_log, Bm, Cm, Dskip, z, state, lens):
    """Plain scan over (B, W) positions in f32: the sequential recurrence of
    ``slow_forward``; positions at or past ``lens`` take dt = 0.  The state
    (B, D, N) f32 is updated in place.  -> y (B, W, D) in u's dtype."""
    B, W, D = u.shape
    A = -torch.exp(A_log.float())  # (D, N)
    keep = (torch.arange(W, device=u.device)[None, :] < lens.to(u.device)[:, None]).float()
    delta = F.softplus(dt.float() + dt_bias.float()) * keep[..., None]  # (B, W, D)
    s = state.float()
    ys = []
    for t in range(W):
        d = delta[:, t, :, None]  # (B, D, 1)
        s = torch.exp(A[None] * d) * s + (d * Bm[:, t, None, :].float()) * u[:, t, :, None].float()
        ys.append((s * Cm[:, t, None, :].float()).sum(-1))
    y = torch.stack(ys, 1) + u.float() * Dskip.float()
    state.copy_(s)
    return (y * F.silu(z.float())).to(u.dtype)


def _scan(u, dt, dt_bias, A_log, Bm, Cm, Dskip, z, state, lens, step: bool):
    _bf16(u, dt, dt_bias, A_log, Bm, Cm, Dskip, z)
    if state.dtype != torch.float32 or not state.is_contiguous():
        raise TypeError("the SSM state is a contiguous float32 tensor")
    B, W, D = u.shape
    N = Bm.shape[-1]
    zb, zt = _rows_view(z)
    y = torch.empty(B, W, D, dtype=u.dtype, device=u.device)
    # every operand bound to a name until the launch is queued (a temporary
    # freed earlier could be handed to the next allocation)
    ins = [t.contiguous() for t in (u, dt, dt_bias, A_log, Bm, Cm, Dskip)]
    n = lens.to(torch.int32)
    err = build_kernels().vcla_selective_scan(
        *(t.data_ptr() for t in ins), z.data_ptr(), zb, zt, state.data_ptr(), n.data_ptr(),
        y.data_ptr(), B, W, D, N, int(step), _stream(u))
    _raise("selective_scan_step" if step else "selective_scan_chunk", err)
    return y


def scan_chunk(u, dt, dt_bias, A_log, Bm, Cm, Dskip, z, state, lens):
    """u, dt (B, W, D); dt_bias (D); A_log (D, N); B, C (B, W, N); D (D); z
    (B, W, D) with contiguous channels; state (B, D, N) f32; lens (B,)."""
    if u.device.type == "cpu":
        return scan_ref(u, dt, dt_bias, A_log, Bm, Cm, Dskip, z, state, lens)
    return _scan(u, dt, dt_bias, A_log, Bm, Cm, Dskip, z, state, lens, step=False)


def scan_step(u, dt, dt_bias, A_log, Bm, Cm, Dskip, z, state, run):
    """One token a row: u, dt, z (B, D); B, C (B, N); the state of rows that
    do not run is left unwritten and their y is 0.  -> y (B, D)."""
    args = (u[:, None], dt[:, None], dt_bias, A_log, Bm[:, None], Cm[:, None], Dskip, z[:, None],
            state, run)
    if u.device.type == "cpu":
        y = scan_ref(*args)[:, 0]
        return torch.where(run.to(y.device).bool()[:, None], y, torch.zeros_like(y))
    return _scan(*args, step=True)[:, 0]
