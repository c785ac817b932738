"""Ring attention: context parallelism (CP) over a sequence-sharded mesh axis
(port of visualcla_tpu/parallel/ring.py).

Each rank of the ``seq`` axis holds a contiguous chunk of the sequence and
keeps its queries; K/V (with their positions and validity) make P - 1 hops
around the ring (``parallel.tp.ring_pass``: ``batch_isend_irecv``), each
arriving block folded into an fp32 online softmax, the same blockwise
recurrence as the flash kernels', with the finite ``_NEG`` for a masked
score.  It is plain torch einsums, not a kernel: the JAX package runs it in
XLA.  Masking is by absolute position, so any layout works as long as each
rank carries its own position ids.
"""
from __future__ import annotations

from typing import Optional

import torch

from .tp import Axis, axis, gather_from_model, ring_pass

_NEG = -1e30  # a finite "-inf": the online-softmax recurrence stays NaN-free


def ring_attention(
    q: torch.Tensor,  # (B, Sq_local, N, H): this rank's queries
    k: torch.Tensor,  # (B, Sk_local, Nkv, H): this rank's keys
    v: torch.Tensor,  # (B, Sk_local, Nkv, H)
    q_positions: torch.Tensor,  # (B, Sq_local) absolute positions
    kv_positions: torch.Tensor,  # (B, Sk_local) absolute positions
    kv_valid: torch.Tensor,  # (B, Sk_local) bool
    ring: Axis,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact attention over a sequence sharded on ``ring`` (every rank of its
    group calls it at once).  GQA stays in the einsum: K/V travel at Nkv
    heads.  -> (B, Sq_local, N, H) in q's dtype; a query with no valid key
    (padding) gets zeros."""
    B, Sq, N, H = q.shape
    Nkv = k.shape[2]
    G = N // Nkv
    if scale is None:
        scale = H ** -0.5
    qf = (q.float() * scale).reshape(B, Sq, Nkv, G, H)
    m = torch.full((B, Nkv, G, Sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)

    def fold(m, l, acc, k_c, v_c, pos_c, ok_c):
        logits = torch.einsum("bqngh,bknh->bngqk", qf, k_c.float())  # (B, Nkv, G, Sq, Sk)
        ok = ok_c[:, None, None, None, :]
        if causal:
            ok = ok & (pos_c[:, None, None, None, :] <= q_positions[:, None, None, :, None])
        logits = torch.where(ok, logits, torch.full_like(logits, _NEG))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None]) * ok  # masked lanes add 0
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bngqk,bknh->bqngh", p, v_c.float())
        return m_new, l_new, acc * corr.permute(0, 3, 1, 2)[..., None] + pv

    block = [k, v, kv_positions, kv_valid.bool()]
    m, l, acc = fold(m, l, acc, *block)
    for _ in range(ring.size - 1):  # rotate, then fold the arriving block
        block = ring_pass(block, ring.group, ring.size, ring.rank)
        m, l, acc = fold(m, l, acc, *block)
    l = l.clamp(min=1e-30)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, N, H).to(q.dtype)


def ring_attention_sharded(
    q: torch.Tensor,  # (B, S, N, H): the whole arrays, the same on every rank
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    seq_axis: str = "seq",
    kv_valid: Optional[torch.Tensor] = None,  # (B, S) bool
    causal: bool = True,
) -> torch.Tensor:
    """``ring_attention`` over ``mesh``: the sequence split contiguously on
    ``seq_axis``, and where the mesh also has ``data`` / ``model`` axes that
    divide the batch / both head counts, the rows and heads too (the ring's
    hops are independent per row and head).  Every rank passes the same
    whole arrays and gets the whole (B, S, N, H) output."""
    B, S, N, H = q.shape
    ring = axis(mesh, seq_axis)
    if S % ring.size:
        raise ValueError(f"sequence {S} not divisible by {seq_axis}={ring.size}")
    data, model = axis(mesh, "data"), axis(mesh, "model")
    if data is not None and B % data.size:
        data = None
    if model is not None and (N % model.size or k.shape[2] % model.size):
        model = None
    positions = torch.arange(S, device=q.device)[None].expand(B, S)
    if kv_valid is None:
        kv_valid = torch.ones(B, S, dtype=torch.bool, device=q.device)

    def part(x, ax, dim):
        if ax is None:
            return x
        w = x.shape[dim] // ax.size
        return x.narrow(dim, ax.rank * w, w)

    def local(x, heads=True):
        x = part(part(x, data, 0), ring, 1)
        return part(x, model, 2) if heads else x

    out = ring_attention(local(q), local(k), local(v), local(positions, False),
                         local(positions, False), local(kv_valid, False), ring, causal=causal)
    for ax, dim in ((model, 2), (ring, 1), (data, 0)):
        if ax is not None:
            out = gather_from_model(out, ax.group, ax.size, dim)
    return out
