"""Paged-KV continuous-batching engine (port of visualcla_tpu/engine/paged.py).

The same scheduling surface as the JAX package's (``server.Scheduler`` drives
``prefill_row`` / ``begin_prefill`` / ``step`` / ``step_n`` / ``snapshot`` /
``release_rows``), with the KV cache in a global block pool:

- ``(L, NB, BS, Nkv*hd)`` pools (int8 with ``(L, NB, BS, Nkv)`` f32 scales
  at ``kv_quant="int8"``) and a host free-list allocator whose block 0 is the
  dummy target of unused table entries and parked rows: it is never handed
  out;
- per-row block tables and context lengths on the host, which the host
  mutates between chunks (admission, release); before a chunk they go into
  static device buffers, the chunk advances the lengths on the device, and
  the host's copy of the lengths is read back once after it;
- every decode step runs kernel B4 (``ops.cuda.paged_attention``) once per
  layer: the new token's K/V are appended to the pool and attended over in
  one launch;
- an admission runs the text tower over a contiguous scratch cache (kernel
  B2) and scatters the prompt's blocks into the pool; prompts are
  RIGHT-padded to a bucket, so the real tokens sit in slots 0..S-1.

The engine reads its text tower through one surface (``Llama``'s and
``Jamba``'s): ``init_kv_cache`` (an admission's scratch), ``pool_state``
(what a row keeps beside its K/V), ``stateful`` and ``require(path)`` (a
tower that does not serve a path raises).  A stateful tower (Jamba,
``models/jamba.py``) keeps two kinds of state in one pool: the paged K/V of
its attention layers alone, and per row and Mamba layer the conv and SSM
states (``PagedState.conv`` / ``ssm``).  Its admissions chain the Mamba
states through the scratch from chunk to chunk (the chunks' windows never
overlap, for any tower: a state must not see a token twice; each chunk
starts from a saved copy, chosen by the chunk's index mod 2, which is part
of its key, so that a capture's warm-up run leaves the states as one run
does), and the scatter stage writes the row's states into its slot (a
device row index) beside its K/V blocks; the captured decode step updates
the states of the running rows only (kernel B8's step form) and routes the
others' tokens to no expert.  Speculation and meshes refuse such a tower.

A row costs ceil(len / BS) blocks, so the pool admits requests by tokens,
not by rows x max_seq_len.  ``step_n`` is the JAX package's ``_step_n_impl``
on a captured CUDA graph (``engine/graphs.py``): ``n`` replays of one
captured decode step, each gated on the device by the JAX loop's ``cond`` (a
row runs and none has finished since the chunk began), so the chunk stops
where the JAX loop stops and its later steps change nothing (their parked
rows append into block 0); ``step`` is a chunk of one.  The sampler's
branch flags come from the host's copy of the knobs and are part of the
graph's key.  With ``spec_k > 0``, ``spec_step_n`` runs speculative
iterations the same way (``engine/paged_spec.py``, kernel B5): each commits
1..spec_k+1 tokens a greedy row.  The JAX flat / nested loop choice is a TPU
workaround, not ported.

Admissions are replays too, in key space "prefill": a one-shot admission
(``prefill_row``) is a chunked one (``begin_prefill``) whose one chunk is as
wide as the bucket, and both run the same stages over static buffers:
encode (key: form, bucket, image shapes, vision attention), tower chunk
(form, bucket, chunk start and width), scatter (form, bucket), and the
first token (bucket, the sampler's flags; the row, S - 1, the limit and the
knobs in device buffers).  The one-shot form and the chunked one keep
buffers of their own, as a one-shot admission may run while a chunked one is
part way; the first token's stage, which follows the last chunk in the same
call, is shared by both.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import VisualCLAConfig
from ..models import llama, visualcla
from ..ops.attention import vision_attention_impl
from ..ops.cuda.paged_attention import paged_append_attention
from ..ops.linear import Int4Linear
from ..ops.quantization import quantize_kv
from ..ops.rope import apply_rope, rope_table
from ..parallel.sharding import bind
from ..utils.profiling import span
from .generate import PrefillInputs, host_pixels, pick_bucket
from .graphs import LOCK, Graphs
from .sampling import SamplingConfig, sample_step_rowwise
from .server import _check_serving_sampling, knob_flags, knob_kwargs, sampling_knobs


def init_pools(cfg, num_blocks: int, block_size: int, dtype=torch.bfloat16,
               kv_quant: str = "none", *, device=None, kv_heads: Optional[int] = None):
    """-> (k_pool, v_pool, k_scales | None, v_scales | None): zeroed pools
    (L, NB, BS, Nkv*hd) in ``dtype``, or int8 with scales that start at one;
    L the config's attention layers.  ``kv_heads``: the heads a rank holds
    over a mesh (default the config's)."""
    L, hd = cfg.num_attention_layers, cfg.head_dim
    Nkv = cfg.num_key_value_heads if kv_heads is None else kv_heads
    shape = (L, num_blocks, block_size, Nkv * hd)
    if kv_quant == "int8":
        sshape = (L, num_blocks, block_size, Nkv)
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device))
    if kv_quant != "none":
        raise ValueError(f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device), None, None)


def pool_layer(layer: llama.DecoderLayer, h, cos, sin, state: "PagedState", attend):
    """One decoder layer over the pool for Sq new tokens a row: qkv -> rope
    -> (int8 pool: K and V quantized per token and head, together) ->
    ``attend(q, k, v, k_scales, v_scales)``, a paged kernel that appends the
    new K/V to the pools in place and attends -> o_proj -> MLP."""
    x = layer.input_norm(h)
    q, k, v = layer.project_qkv(x)  # over a mesh: the rank's heads
    q, k = apply_rope(q, k, cos, sin)
    if state.k_scales is not None:
        (k, v), (ksc, vsc) = (t.unbind(0) for t in quantize_kv(torch.stack((k, v))))
    else:
        k, v, ksc, vsc = k.to(state.k_pool.dtype), v.to(state.v_pool.dtype), None, None
    return layer.out_mlp(h, attend(q, k, v, ksc, vsc))


def paged_decode_forward(text: llama.Llama, embeds, positions, state: "PagedState",
                         tables, blk, off, lens, run=None):
    """One decode step over the pool, kernel B4 in every layer: embeds
    (B, 1, H), rope positions (B,), ``lens`` (B,) INCLUDING the new token.
    -> final-normed hidden (B, 1, H).  A stateful tower (Jamba) runs its own
    step, which takes the pass's ``run`` vector too (``Jamba.paged_decode``:
    B4 in its attention layers, B8's step form in its Mamba layers)."""
    if text.stateful:
        return text.paged_decode(embeds, state, tables, blk, off, lens, run, state.moe_tally)
    cos, sin = rope_table(positions[:, None], text.cfg.head_dim, text.cfg.rope_theta)

    def first(t):
        return None if t is None else t[:, 0]

    h = embeds
    for l, layer in enumerate(text.layers):
        def attend(q, k, v, ksc, vsc, l=l):
            return paged_append_attention(
                q[:, 0], k[:, 0], v[:, 0], state.k_pool, state.v_pool, tables, lens, blk, off,
                l, first(ksc), first(vsc), state.k_scales, state.v_scales)[:, None]

        h = pool_layer(layer, h, cos, sin, state, attend)
    return text.final_norm(h)


@dataclasses.dataclass
class PagedState:
    """The pool's device state (every tensor has the pool's rows first but
    the pools)."""

    k_pool: torch.Tensor  # (L, NB, BS, Nkv*hd)
    v_pool: torch.Tensor
    k_scales: Optional[torch.Tensor]  # (L, NB, BS, Nkv) f32 at kv_quant="int8"
    v_scales: Optional[torch.Tensor]
    last_token: torch.Tensor  # (B,) int64
    positions: torch.Tensor  # (B,) next rope position
    gen_ids: torch.Tensor  # (B, T)
    gen_len: torch.Tensor  # (B,)
    # (B, Smax) prompt + generated tokens a row, the speculative drafts'
    # source; valid length positions + 1 (the last token is not in the pool)
    all_ids: torch.Tensor
    max_len: torch.Tensor  # (B,) per-request max_new_tokens
    active: torch.Tensor  # (B,) bool
    finished: torch.Tensor  # (B,) bool: hit EOS or a limit, awaiting collection
    mu: torch.Tensor  # (B,) f32 mirostat state
    knobs: torch.Tensor  # (B, 11) f32 per-request knobs (server.sampling_knobs)
    generator: torch.Generator
    # a Jamba tower's: the rows' Mamba states (Lm, B, D, 3) / (Lm, B, D, N)
    # f32, and the MoE counters (assignments (L_moe, E), experts hit ())
    conv: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    moe_tally: Optional[tuple] = None


@dataclasses.dataclass
class _AdmitBuffers:
    """One admission form's static device buffers at one bucket L."""

    inputs: dict  # PrefillInputs by shape: the padded ids and mask, markers, pixels
    embeds: torch.Tensor  # (1, L, H) the spliced embeddings
    positions: torch.Tensor  # (1, L) rope positions
    mask: torch.Tensor  # (1, L) bool, the real slots
    scratch: dict  # one-row cache of L slots (llama.init_kv_cache)
    blocks: torch.Tensor  # (L / BS,) the prompt's pool blocks


class PagedServingEngine:
    """Block-paged pool engine for one model on one device; duck-type
    compatible with ``server.Scheduler``."""

    def __init__(
        self,
        model: visualcla.VisualCLAModel,
        cfg: VisualCLAConfig,
        *,
        eos_token_id: int,
        pad_token_id: int,
        pool_size: int = 8,  # concurrent rows
        block_size: int = 64,
        num_blocks: int = 256,  # KV budget: num_blocks * block_size tokens
        max_seq_len: int = 2048,
        max_new_tokens_cap: int = 1024,
        prompt_buckets=(128, 256, 512, 1024),
        sampling: Optional[SamplingConfig] = None,
        kv_quant: str = "none",  # "int8": halve the pool's bytes (per-token scales)
        seed: int = 0,
        mesh=None,
        spec_k: int = 0,  # >0: speculative iterations of spec_k drafts (spec_step_n)
        spec_max_active: Optional[int] = None,  # the Scheduler speculates up to this
        #   many live rows (None: 2 at the int4 tier, else 4)
        spec_max_ngram: int = 3,
    ):
        self.stateful = model.text.stateful
        if spec_k > 0:
            model.text.require("speculation")
        if mesh is not None:
            model.text.require("mesh")
        bind(model, mesh)
        self.mesh = mesh  # the pools hold the rank's kv heads; rows are not split
        self.model = model
        self.cfg = cfg
        self.kv_quant = kv_quant
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.B = pool_size
        self.BS = block_size
        self.NB = num_blocks
        self.Smax = max_seq_len
        self.T = max_new_tokens_cap
        self.max_blocks = (max_seq_len + block_size - 1) // block_size
        self.prompt_buckets = tuple(b for b in prompt_buckets if b <= max_seq_len)
        bad = [b for b in self.prompt_buckets if b % block_size]
        if bad:
            raise ValueError(f"prompt buckets {bad} are not multiples of "
                             f"block_size={block_size} (prefill scatters whole blocks)")
        self.sampling = _check_serving_sampling(sampling or SamplingConfig())
        p = model.text.final_norm.weight  # a float leaf at every weight tier
        self.device, self.dtype = p.device, p.dtype
        self.decode_steps = 0  # live decode steps run (counts["decode_passes"]: all)
        self.spec_steps = 0  # live speculative iterations run
        self.spec_k = int(spec_k)
        if spec_max_active is None:
            int4 = any(isinstance(m, Int4Linear) for m in model.text.modules())
            spec_max_active = 2 if int4 else 4
        self.spec_max_active = int(spec_max_active)
        self.spec_max_ngram = int(spec_max_ngram)

        # host allocator: block 0 is the dummy target for unused table slots
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.tables = np.zeros((self.B, self.max_blocks), np.int32)
        self.row_blocks: List[List[int]] = [[] for _ in range(self.B)]
        self.ctx_len = np.zeros((self.B,), np.int32)
        # host mirrors: active is host-driven; finished and the rows'
        # generated lengths as of the last chunk or snapshot (a row that
        # ends at its admission shows only at the next one)
        self._host_active = np.zeros((self.B,), bool)
        self._host_finished = np.zeros((self.B,), bool)
        self._host_gen_len = np.zeros((self.B,), np.int64)
        self._host_max_len = np.zeros((self.B,), np.int64)
        default_knobs = sampling_knobs(self.sampling, None)
        self._host_knobs = np.tile(default_knobs, (self.B, 1))

        dev, B, T = self.device, self.B, self.T
        k_pool, v_pool, k_scales, v_scales = init_pools(
            cfg.text_config, num_blocks, block_size, self.dtype, kv_quant, device=dev,
            kv_heads=model.text.kv_heads)
        self._state = PagedState(
            k_pool=k_pool, v_pool=v_pool, k_scales=k_scales, v_scales=v_scales,
            last_token=torch.zeros(B, dtype=torch.int64, device=dev),
            positions=torch.zeros(B, dtype=torch.int64, device=dev),
            gen_ids=torch.zeros(B, T, dtype=torch.int64, device=dev),
            gen_len=torch.zeros(B, dtype=torch.int64, device=dev),
            all_ids=torch.zeros(B, max_seq_len, dtype=torch.int64, device=dev),
            max_len=torch.zeros(B, dtype=torch.int64, device=dev),
            active=torch.zeros(B, dtype=torch.bool, device=dev),
            finished=torch.zeros(B, dtype=torch.bool, device=dev),
            mu=torch.full((B,), 2.0 * self.sampling.mirostat_tau, device=dev),
            knobs=torch.as_tensor(self._host_knobs, device=dev),
            generator=torch.Generator(device=dev).manual_seed(seed),
            **model.text.pool_state(B, self.dtype, device=dev),
        )
        # the captured chunks' static inputs: the block tables and context
        # lengths (uploaded from the host's before a chunk, the lengths
        # advanced on the device and read back after it), the finished
        # flags at the chunk's start, and the live (ungated) steps and
        # speculative iterations run so far
        self._tables_dev = torch.zeros(self.B, self.max_blocks, dtype=torch.int32, device=dev)
        self._lens_dev = torch.zeros(self.B, dtype=torch.int64, device=dev)
        self._finished0 = torch.zeros(self.B, dtype=torch.bool, device=dev)
        self._live = torch.zeros(2, dtype=torch.int64, device=dev)
        self._live_host = np.zeros(2, np.int64)
        self._rows = torch.arange(self.B, device=dev)
        self.graphs = Graphs()
        # the admissions' static buffers: per (form, bucket), the hidden
        # states per bucket, and the first token's inputs (row, S - 1,
        # max_new_tokens; knobs; the padded ids)
        self._admit_bufs: dict = {}
        self._hidden: dict = {}
        self._tail_ctl = torch.zeros(3, dtype=torch.int64, device=dev)
        self._tail_knobs = torch.zeros(11, dtype=torch.float32, device=dev)
        self._tail_ids = torch.zeros(1, max_seq_len, dtype=torch.int64, device=dev)
        self._chunked_busy = False
        self._admit_row = torch.zeros(1, dtype=torch.int64, device=dev)  # the scatter's row
        # forward passes run on the device, gated ones included: each
        # launches B4 (decode) or B5 (speculative) once a layer, a tower
        # chunk (prefill_passes) B2; the live (ungated) decode passes, read
        # back after each chunk; admission stages run, and those replayed
        # from a graph
        self.counts = {"decode_passes": 0, "spec_passes": 0, "live_decode_passes": 0,
                       "prefill_passes": 0, "admit_stages": 0, "admit_replays": 0}
        if self.stateful:
            # Mamba states scattered by admissions (one a layer and row); the
            # MoE counters as of the last decode chunk's read back: the
            # assignments each (MoE layer, expert) got and the sum over MoE
            # passes of the experts that got any (gated passes included: B7
            # ran them)
            self.counts.update(ssm_state_writes=0,
                               moe_expert_tokens=tuple([0] * self._state.moe_tally[0].numel()),
                               moe_experts_hit=0)

    def pool_bytes(self) -> int:
        """Device bytes of the K/V pools and their scales."""
        s = self._state
        return sum(t.numel() * t.element_size()
                   for t in (s.k_pool, s.v_pool, s.k_scales, s.v_scales) if t is not None)

    # -- allocator -------------------------------------------------------------

    def can_admit(self, prompt_len: int) -> bool:
        """Worst-case block need for this prompt (prefill_row's allocation,
        bucket padding included) against the free pool."""
        try:
            L = self.bucket_len(prompt_len)
        except ValueError:
            return False  # longer than the largest bucket: never admissible
        nb_prompt = (L + self.BS - 1) // self.BS
        nb_total = (prompt_len + self.T + 1 + self.BS - 1) // self.BS
        # decode stops at Smax (hit_cap), so no row uses more blocks
        need = min(max(nb_total, nb_prompt), self.max_blocks)
        return len(self._free) >= need

    def _alloc_blocks(self, row: int, n: int) -> List[int]:
        if len(self._free) < n:
            raise RuntimeError("KV block pool exhausted")
        blocks = [self._free.pop() for _ in range(n)]
        self.row_blocks[row].extend(blocks)
        tb = self.row_blocks[row]
        self.tables[row, :] = 0
        self.tables[row, :len(tb)] = tb
        return blocks

    def _free_row(self, row: int) -> None:
        self._free.extend(self.row_blocks[row])
        self.row_blocks[row] = []
        self.tables[row, :] = 0
        self.ctx_len[row] = 0

    def bucket_len(self, n: int) -> int:
        try:
            return pick_bucket(self.prompt_buckets, n)
        except ValueError:
            # past the buckets: a block-size multiple up to Smax (decode
            # stops at Smax via hit_cap)
            L = -(-n // self.BS) * self.BS
            if L <= self.Smax:
                return L
            raise

    # -- admission -------------------------------------------------------------

    def _prepare_admission(self, row: int, input_ids, img_start_pos, pixel_values,
                           max_new_tokens: int):
        """Host half of an admission: RIGHT-pad to the bucket (slots 0..S-1
        hold the prompt), normalize the image marker, reserve every block the
        request can touch.
        -> (ids, mask, img_pos, host pixels, blocks, nb_prompt, S, L)."""
        input_ids = np.asarray(input_ids).reshape(-1)
        S = len(input_ids)
        L = self.bucket_len(S)
        ids = np.full((1, L), self.pad, np.int64)
        mask = np.zeros((1, L), np.int64)
        ids[0, :S] = input_ids
        mask[0, :S] = 1
        if img_start_pos is not None and np.ndim(img_start_pos) > 0:
            # multi-image admission: (K,) markers with (1, K, 3, H, W) pixels
            img_pos = np.asarray(img_start_pos, np.int64).reshape(1, -1)
        else:
            img_pos = np.asarray([-1 if img_start_pos is None or img_start_pos < 0
                                  else img_start_pos], np.int64)
        visualcla.check_img_start_pos(img_pos, self.cfg.num_image_tokens, L)
        pixels = host_pixels(pixel_values)
        if pixels is not None and img_pos.ndim == 2 and pixels.dim() == 4:
            pixels = pixels[None]  # (1, K, 3, H, W)
        self._free_row(row)
        # blocks for the whole padded prompt + headroom for decode, never
        # past Smax or the table's max_blocks entries
        nb_prompt = -(-L // self.BS)
        nb_total = (S + min(max_new_tokens, self.T) + 1 + self.BS - 1) // self.BS
        nb_total = min(max(nb_total, nb_prompt), self.max_blocks)
        blocks = self._alloc_blocks(row, nb_total)
        return ids, mask, img_pos, pixels, blocks, nb_prompt, S, L

    def _admit_buffers(self, owner: str, L: int) -> _AdmitBuffers:
        """The static buffers of ``owner``'s admissions at bucket L (made at
        first use, outside any capture); the bucket's hidden states too."""
        key = (owner, L)
        if key not in self._admit_bufs:
            dev, H = self.device, self.cfg.text_config.hidden_size
            self._admit_bufs[key] = _AdmitBuffers(
                inputs={},
                embeds=torch.zeros(1, L, H, dtype=self.dtype, device=dev),
                positions=torch.zeros(1, L, dtype=torch.int64, device=dev),
                mask=torch.zeros(1, L, dtype=torch.bool, device=dev),
                scratch=self.model.text.init_kv_cache(1, L, self.dtype, device=dev),
                blocks=torch.zeros(L // self.BS, dtype=torch.int64, device=dev))
            if L not in self._hidden:
                self._hidden[L] = torch.zeros(1, L, H, dtype=self.dtype, device=dev)
        return self._admit_bufs[key]

    def _run_stage(self, key, fn, generators=()) -> None:
        """One admission stage ``fn``: a replay of its graph, captured under
        ``key`` in key space "prefill" at first use (eagerly on CPU tensors
        and in ``graphs.eager()``).  ``counts["admit_stages"]`` counts the
        stages run (bumped inside the step, so a replay adds it),
        ``counts["admit_replays"]`` those replayed from a graph."""
        def stage():
            fn()
            self.counts["admit_stages"] += 1

        replays = self.graphs.replays
        self.graphs.run(key, stage, self.device, generators=generators, counters=[self.counts],
                        space="prefill")
        self.counts["admit_replays"] += self.graphs.replays - replays

    def _encode_stage(self, buf: _AdmitBuffers, inp: PrefillInputs) -> None:
        """The image encode and splice over the padded prompt (the device
        position form: nothing read back), into ``buf``'s embeddings, rope
        positions and mask."""
        embeds = visualcla.multimodal_embeds(self.model, self.cfg, inp.ids, inp.img_pos,
                                             inp.pixels)
        buf.embeds.copy_(embeds)
        buf.mask.copy_(inp.mask.bool())
        buf.positions.copy_((inp.mask.cumsum(-1) - 1).clamp(min=0))

    def _tower_stage(self, buf: _AdmitBuffers, c0: int, width: int,
                     parity: Optional[int] = None) -> None:
        """The text tower over slots [c0, c0 + width) into ``buf``'s scratch
        cache; the hidden states into the bucket's static buffer.  A Jamba
        tower's chunk starts from saved state ``parity`` (``Jamba.forward``)."""
        L = buf.mask.shape[1]
        c1 = c0 + width
        # real slots before the chunk's end: a query at slot j sees the valid
        # kv slots <= j, exactly the one-shot prefill's set
        kv_valid = buf.mask & (torch.arange(L, device=buf.mask.device) < c1)[None]
        kw = ({"tally": self._state.moe_tally, "chunk_parity": parity} if self.stateful
              else {})
        hidden, _ = self.model.text(buf.embeds[:, c0:c1], buf.positions[:, c0:c1], buf.scratch,
                                    kv_valid, c0, **kw)
        self._hidden[L][:, c0:c1].copy_(hidden)
        self.counts["prefill_passes"] += 1

    def _scatter_stage(self, buf: _AdmitBuffers) -> None:
        """Copy the scratch cache's K/V (L, 1, Nkv, Lb, hd) into the pool
        blocks ``buf.blocks`` (int8 pool: quantized per token and head on the
        way).  Slots the chunks never wrote carry a stale earlier admission's
        values into the row's blocks: they lie at or past the prompt's end,
        where decode writes each slot before any query reads it."""
        s = self._state
        Lyr, _, Nkv, Lb, hd = buf.scratch["k"].shape
        nb = Lb // self.BS

        def blocks(t):  # (L, 1, Nkv, Lb, hd) -> (L, nb, BS, Nkv, hd)
            return t[:, 0].transpose(1, 2).reshape(Lyr, nb, self.BS, Nkv, hd)

        kb, vb = blocks(buf.scratch["k"]), blocks(buf.scratch["v"])
        if s.k_scales is not None:
            (kb, vb), (ks, vs) = (t.unbind(0) for t in quantize_kv(torch.stack((kb, vb))))
            s.k_scales.index_copy_(1, buf.blocks, ks)
            s.v_scales.index_copy_(1, buf.blocks, vs)
        for pool, t in ((s.k_pool, kb), (s.v_pool, vb)):
            pool.index_copy_(1, buf.blocks, t.reshape(Lyr, nb, self.BS, Nkv * hd).to(pool.dtype))
        if self.stateful:  # the row's Mamba states, at the last real token
            s.conv.index_copy_(1, self._admit_row, buf.scratch["conv"])
            s.ssm.index_copy_(1, self._admit_row, buf.scratch["ssm"])
            self.counts["ssm_state_writes"] += s.ssm.shape[0]

    def _tail_stage(self, L: int, flags: dict) -> None:
        """Sample the first token from the last REAL prompt position's hidden
        state (``_tail_ctl``: row, S - 1, max_new_tokens) with the knobs
        ``_tail_knobs`` and activate the row at a device row index; the
        right-padded ids ``_tail_ids`` seed its token history, the first
        token goes to index S."""
        s = self._state
        dev, T = self.device, self.T
        row, last, max_new = self._tail_ctl[0:1], self._tail_ctl[1:2], self._tail_ctl[2:3]
        hidden = self._hidden[L].index_select(1, last)  # (1, 1, H)
        logits = self.model.text.logits(hidden)[:, 0]  # (1, V)
        kn = self._tail_knobs[None]  # (1, 11)
        token, mu_row = sample_step_rowwise(
            logits, torch.zeros(1, T, dtype=torch.int64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev), s.generator, self.sampling,
            **knob_kwargs(kn, 2.0 * kn[:, 7]), flags=flags)
        s.all_ids.index_put_((row.expand(L), torch.arange(L, device=dev)), self._tail_ids[0, :L])
        s.all_ids.index_put_((row, (last + 1).clamp(max=self.Smax - 1)), token)
        s.last_token.index_copy_(0, row, token)
        s.positions.index_copy_(0, row, last + 1)
        s.gen_ids.index_copy_(0, row, F.pad(token[:, None], (0, T - 1)))
        s.gen_len.index_fill_(0, row, 1)
        s.max_len.index_copy_(0, row, max_new)
        s.active.index_fill_(0, row, True)
        # the admission commits token 1: a max_new_tokens=1 request is complete
        s.finished.index_copy_(0, row, (token == self.eos) | (max_new <= 1))
        s.mu.index_copy_(0, row, mu_row)
        s.knobs.index_copy_(0, row, kn)

    @torch.no_grad()
    def prefill_row(self, row: int, input_ids: np.ndarray, pixel_values, img_start_pos,
                    max_new_tokens: int, overrides: Optional[dict] = None) -> None:
        """One-shot admission: a chunked admission whose one chunk is as wide
        as the bucket, every stage in this call (buffers of its own, so it
        may run while a chunked admission is part way)."""
        pending = PendingPrefill(self, row, input_ids, pixel_values, img_start_pos,
                                 max_new_tokens, overrides, chunk=None)
        with LOCK:
            while not pending._step():
                pass

    def begin_prefill(self, row: int, input_ids: np.ndarray, pixel_values, img_start_pos,
                      max_new_tokens: int, overrides: Optional[dict] = None,
                      chunk: int = 256) -> "PendingPrefill":
        """Start a CHUNKED admission: the prompt goes through the text tower
        ``chunk`` tokens a call of ``step()`` on the returned object, so the
        scheduler can run decode steps for the other rows between chunks.
        Same tokens as ``prefill_row``; blocks are reserved up front and
        ``abort()`` returns them.  One chunked admission at a time."""
        if self._chunked_busy:
            raise RuntimeError("a chunked admission is already in flight (one at a time)")
        return PendingPrefill(self, row, input_ids, pixel_values, img_start_pos,
                              max_new_tokens, overrides, chunk)

    # -- decode ----------------------------------------------------------------

    def decode_inputs(self, lens: torch.Tensor, run: torch.Tensor, tables: torch.Tensor):
        """The device inputs of a decode step appending at ``lens`` - 1 for
        the rows in ``run``: (blk, off, lens_attn).  Rows that do not run
        append into dummy block 0 and attend over length 1."""
        new_slot = lens - 1
        blk = torch.gather(tables, 1, (new_slot // self.BS).clamp(min=0)[:, None])[:, 0]
        blk = torch.where(run, blk, torch.zeros_like(blk))
        off = new_slot % self.BS
        return blk, off, torch.where(run, lens, torch.ones_like(lens))

    def _gate(self):
        """(run, go): the running rows and the JAX ``_step_n_impl`` cond (a
        row runs, none finished since the chunk began), ANDed into run."""
        s = self._state
        run = s.active & ~s.finished
        go = (run.any() & ~(s.finished & ~self._finished0).any()
              & self.graphs.enable(self.device))
        return run & go, go

    def _decode_step(self, flags: dict) -> None:
        """One gated decode step over the static buffers, in place: every
        running row appends its token at ``lens`` (B4 in every layer) and
        commits the next."""
        s = self._state
        run, go = self._gate()
        lens = self._lens_dev
        lens += run.long()  # the token being appended this step
        blk, off, lens_attn = self.decode_inputs(lens, run, self._tables_dev)
        text = self.model.text
        hidden = paged_decode_forward(text, text.embed(s.last_token[:, None]), s.positions,
                                      s, self._tables_dev, blk, off, lens_attn, run=run)
        self._finish_step(run, lens, text.logits(hidden)[:, 0], flags)
        self._live[0] += go.long()
        self.counts["decode_passes"] += 1

    def _finish_step(self, run, lens, step_logits, flags: dict) -> None:
        s = self._state
        rows = self._rows
        token, new_mu = sample_step_rowwise(
            step_logits, s.gen_ids, s.gen_len, s.generator, self.sampling,
            **knob_kwargs(s.knobs, s.mu), flags=flags)
        s.mu.copy_(torch.where(run, new_mu, s.mu))
        token = torch.where(run, token, torch.full_like(token, self.pad))
        idx = s.gen_len.clamp(max=self.T - 1)
        s.gen_ids[rows, idx] = torch.where(run, token, s.gen_ids[rows, idx])
        s.gen_len += run.long()
        # the token history's next index is positions + 1
        aidx = (s.positions + 1).clamp(max=self.Smax - 1)
        s.all_ids[rows, aidx] = torch.where(run & (s.positions + 1 < self.Smax), token,
                                            s.all_ids[rows, aidx])
        hit_eos = run & (token == self.eos)
        hit_cap = run & ((s.gen_len >= s.max_len) | (lens + 1 >= self.Smax))
        s.last_token.copy_(torch.where(run, token, s.last_token))
        s.positions += run.long()
        s.finished |= hit_eos | hit_cap

    def _run_chunk(self, kind: str, n: int, step) -> None:
        """A chunk of ``n`` gated steps ``step(flags)``: replays of the step
        captured on the card under its kind and the sampler's branch flags.
        The host tables and lengths go up before it; the lengths, the live
        steps, the rows' generated lengths and finished flags come back
        after it in one device-to-host copy.  A decode chunk replays no step
        past the first row's cap (its max_new_tokens or Smax, known on the
        host): the loop stops there, and later replays would only be gated.
        Recorded as spans ``decode.launch`` (host prep, copies up, replays)
        and ``decode.readback`` (the copy back, which waits for the chunk)."""
        with span("decode.launch"):
            run = self._host_active & ~self._host_finished
            if kind == "decode" and run.any():
                to_cap = np.minimum(self._host_max_len - self._host_gen_len,
                                    self.Smax - 1 - self.ctx_len.astype(np.int64))
                n = min(n, max(1, int(to_cap[run].min())))
            flags = knob_flags(self._host_knobs[self._host_active])
            self._tables_dev.copy_(torch.from_numpy(self.tables))
            self._lens_dev.copy_(torch.from_numpy(self.ctx_len.astype(np.int64)))
            self._finished0.copy_(self._state.finished)
            self.graphs.run((kind, tuple(sorted(flags.items()))), lambda: step(flags),
                            self.device, generators=[self._state.generator],
                            counters=[self.counts], replays=n)
        with span("decode.readback"):
            s = self._state
            moe = [s.moe_tally[0].reshape(-1), s.moe_tally[1][None]] if self.stateful else []
            ctl = torch.cat([self._lens_dev, s.gen_len, s.finished.long(),
                             self._live, *moe]).cpu().numpy()
        B = self.B
        if self.stateful:
            n = s.moe_tally[0].numel()
            self.counts["moe_expert_tokens"] = tuple(int(v) for v in ctl[3 * B + 2:3 * B + 2 + n])
            self.counts["moe_experts_hit"] = int(ctl[-1])
            ctl = ctl[:3 * B + 2]
        self.ctx_len = ctl[:B].astype(np.int32)
        self._host_gen_len = ctl[B:2 * B].copy()
        self._host_finished = ctl[2 * B:3 * B].astype(bool)
        live = ctl[3 * B:] - self._live_host
        self._live_host = ctl[3 * B:]
        self.decode_steps += int(live[0])
        self.spec_steps += int(live[1])
        self.counts["live_decode_passes"] += int(live[0])

    @torch.no_grad()
    def step(self) -> None:
        """One decode step for every running row."""
        self._run_chunk("decode", 1, self._decode_step)

    @torch.no_grad()
    def step_n(self, n: int) -> None:
        """Up to ``n`` decode steps; stops early when a row finishes (so its
        retirement and the next admission are not delayed) or none runs:
        ``n`` replays of the captured gated step, those after the stop
        changing nothing.  Prefill reserved every block a request can touch,
        so the steps need no allocator call."""
        self._run_chunk("decode", n, self._decode_step)

    # -- speculative decoding inside the pool (engine/paged_spec.py) -----------

    def spec_ready(self) -> bool:
        """Whether a speculative iteration can gain anything: ``spec_k > 0``
        and a running row is ``spec_eligible``, from the host mirrors (no
        device sync)."""
        from .paged_spec import spec_eligible

        run = self._host_active & ~self._host_finished
        return self.spec_k > 0 and bool((run & spec_eligible(self._host_knobs)).any())

    def _spec_finish(self, run, lens, logits, drafts, k: int, flags: Optional[dict] = None):
        """Acceptance and bookkeeping of one verify step, in place: logits
        (B, k+1, V), drafts (B, k), lens (B,) the committed context.  Eligible
        rows commit the longest draft prefix matching their argmax chain plus
        one token; every other running row commits ONE token, sampled from
        the j = 0 logits by the plain step's row-wise sampler.  Commits never
        pass max_new_tokens or Smax, and stop after an EOS.  -> lens, advanced
        in place."""
        from .paged_spec import spec_eligible

        s = self._state
        B, Sq, dev = self.B, k + 1, self.device
        if flags is None:
            flags = knob_flags(self._host_knobs[self._host_active])
        jj = torch.arange(Sq, device=dev)[None, :]
        lf = logits.float()
        chain = lf.argmax(dim=-1)  # (B, Sq)
        tok0, new_mu = sample_step_rowwise(
            lf[:, 0], s.gen_ids, s.gen_len, s.generator, self.sampling,
            **knob_kwargs(s.knobs, s.mu), flags=flags)
        clean = spec_eligible(s.knobs)
        # draft j is accepted iff it equals the prediction at position j
        accepted = (drafts == chain[:, :k]).long().cumprod(dim=1).sum(dim=1)
        n_new = torch.where(clean, accepted + 1, torch.ones_like(accepted))
        cap = torch.minimum(s.max_len - s.gen_len, self.Smax - 1 - lens).clamp(min=1)
        toks = torch.where(clean[:, None], chain, tok0[:, None].expand(B, Sq))
        eos_pos = torch.where(toks == self.eos, jj, Sq).amin(dim=1)
        n_commit = torch.minimum(torch.minimum(n_new, cap), eos_pos + 1)
        n_commit = torch.where(run, n_commit, torch.zeros_like(n_commit))

        def commit_into(buf, first):  # toks[:, :n_commit] at columns first + j
            rel = torch.arange(buf.shape[1], device=dev)[None, :] - first[:, None]
            put = (rel >= 0) & (rel < n_commit[:, None])
            buf.copy_(torch.where(put, torch.gather(toks, 1, rel.clamp(0, Sq - 1)), buf))

        commit_into(s.gen_ids, s.gen_len)
        commit_into(s.all_ids, s.positions + 1)
        last = torch.gather(toks, 1, (n_commit - 1).clamp(min=0)[:, None])[:, 0]
        lens += n_commit
        s.gen_len += n_commit
        hit_eos = run & (eos_pos < n_commit)
        hit_cap = run & ((s.gen_len >= s.max_len) | (lens + 1 >= self.Smax))
        s.last_token.copy_(torch.where(run, last, s.last_token))
        s.positions += n_commit
        s.finished |= hit_eos | hit_cap
        s.mu.copy_(torch.where(run, new_mu, s.mu))
        return lens

    def _spec_step(self, flags: dict) -> None:
        """One gated speculative iteration over the static buffers, in place:
        draft spec_k tokens a row from its token history, verify every row's
        k+1 tokens in one forward (B5 in every layer), commit."""
        from .paged_spec import draft_all_rows, paged_verify_forward

        s = self._state
        k, text = self.spec_k, self.model.text
        run, go = self._gate()
        drafts = draft_all_rows(s.all_ids, s.positions + 1, k, self.spec_max_ngram)
        embeds = text.embed(torch.cat([s.last_token[:, None], drafts], dim=1))
        jj = torch.arange(k + 1, device=self.device)[None, :]
        hidden = paged_verify_forward(text, embeds, s.positions[:, None] + jj, s,
                                      self._tables_dev, self._lens_dev, run)
        self._spec_finish(run, self._lens_dev, text.logits(hidden), drafts, k, flags)
        self._live[1] += go.long()
        self.counts["spec_passes"] += 1

    @torch.no_grad()
    def spec_step_n(self, n: int) -> None:
        """Up to ``n`` speculative iterations (``spec_k > 0``), stopping as
        ``step_n`` does; each drafts spec_k tokens a row from its token
        history, verifies every row's k+1 tokens in one forward (B5 in every
        layer) and commits 1..spec_k+1 tokens a running row: ``n`` replays
        of the captured gated iteration, one host read after them."""
        if self.spec_k <= 0:
            raise ValueError("spec_step_n needs an engine built with spec_k > 0")
        self._run_chunk("spec", n, self._spec_step)

    def snapshot(self) -> dict:
        """The rows' control fields in one device-to-host copy."""
        s = self._state
        packed = torch.cat([s.last_token[:, None], s.gen_len[:, None], s.active[:, None].long(),
                            s.finished[:, None].long(), s.gen_ids], dim=1).cpu().numpy()
        snap = {"last_token": packed[:, 0], "gen_len": packed[:, 1],
                "active": packed[:, 2].astype(bool), "finished": packed[:, 3].astype(bool),
                "gen_ids": packed[:, 4:]}
        self._host_finished = snap["finished"].copy()
        self._host_gen_len = snap["gen_len"].astype(np.int64)
        return snap

    def release_row(self, row: int) -> None:
        self.release_rows([row])

    def release_rows(self, rows) -> None:
        """Deactivate finished rows without a device fetch and return their
        blocks to the allocator."""
        rows = list(rows)
        idx = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
        self._state.active[idx] = False
        self._state.finished[idx] = False
        for row in rows:
            self._host_active[row] = False
            self._host_finished[row] = False
            self._free_row(row)

    def collect_row(self, row: int) -> np.ndarray:
        gen_len = int(self._state.gen_len[row])
        ids = self._state.gen_ids[row, :gen_len].cpu().numpy().copy()
        self.release_row(row)
        return ids

    def num_active(self) -> int:
        return int(self._state.active.sum())


class PendingPrefill:
    """Host state machine for one admission (see ``begin_prefill``).

    Each ``step()`` runs one bounded stage, a replay of its graph:
    0. the image encode and splice over the whole padded prompt; 1..n. a
    text-tower chunk into the scratch cache; the last chunk's call also
    scatters the scratch into the pool, samples the first token and
    activates the row.  The row stays parked (inactive) until then, so
    decode, snapshot and release never see a half-admitted row.  ``chunk``
    None: one chunk as wide as the bucket (``prefill_row``'s one-shot form,
    on buffers of its own)."""

    def __init__(self, eng: PagedServingEngine, row, input_ids, pixel_values, img_start_pos,
                 max_new_tokens, overrides, chunk):
        self.eng = eng
        self.row = int(row)
        self.knobs = sampling_knobs(eng.sampling, overrides)  # raises before any block moves
        with span("admit.host"):
            (self.ids, self.mask, self.img_pos, self.pixels, blocks, nb_prompt, S, L) = (
                eng._prepare_admission(row, input_ids, img_start_pos, pixel_values,
                                       max_new_tokens))
        self.owner = "one_shot" if chunk is None else "chunked"
        BS = eng.BS
        chunk = L if chunk is None else max(BS, (int(chunk) // BS) * BS)
        chunk = min(chunk, L)  # a window must fit the padded bucket
        # the windows: ``chunk`` wide from slot 0, never overlapping (a Mamba
        # state must see each token once), the last one ending at the
        # bucket's edge where it must, narrower; every query sees exactly the
        # kv slots up to its own
        n_chunks = -(-S // chunk)
        self.starts = [i * chunk for i in range(n_chunks)]
        self.widths = [min(chunk, L - c0) for c0 in self.starts]
        self.n_chunks = n_chunks
        self.S, self.L, self.chunk = S, L, chunk
        self.blocks = np.asarray(blocks[:nb_prompt], np.int64)
        self.i = 0  # tower chunks run
        self.max_new = min(max_new_tokens, eng.T)
        self.encoded = self.done = False
        if self.owner == "chunked":
            eng._chunked_busy = True

    @torch.no_grad()
    def step(self) -> bool:
        """Run the next stage; True once the row is live."""
        with LOCK:
            return self._step()

    def _step(self) -> bool:
        if self.done:
            return True
        try:
            return self._stage()
        except Exception:
            self.abort()
            raise

    def _stage(self) -> bool:
        eng, L, owner = self.eng, self.L, self.owner
        buf = eng._admit_buffers(owner, L)
        if not self.encoded:
            with span("admit.encode"):
                inp = PrefillInputs.staged(buf.inputs, self.ids, self.mask, self.img_pos,
                                           self.pixels, eng.device, eng.dtype)
                eng._run_stage(("encode", owner, inp.key, vision_attention_impl()),
                               lambda: eng._encode_stage(buf, inp))
            self.encoded = True
            return False
        c0, width = self.starts[self.i], self.widths[self.i]
        parity = self.i % 2 if eng.stateful else None
        with span("admit.tower"):
            eng._run_stage(("tower", owner, L, c0, width) + (() if parity is None else (parity,)),
                           lambda: eng._tower_stage(buf, c0, width, parity))
        self.i += 1
        if self.i < self.n_chunks:
            return False
        with span("admit.scatter"):
            buf.blocks.copy_(torch.from_numpy(self.blocks))
            if eng.stateful:
                eng._admit_row.fill_(self.row)
            eng._run_stage(("scatter", owner, L), lambda: eng._scatter_stage(buf))
        with span("admit.first_token"):
            flags = knob_flags(self.knobs[None])
            eng._tail_ctl.copy_(torch.tensor([self.row, self.S - 1, self.max_new]))
            eng._tail_knobs.copy_(torch.from_numpy(self.knobs))
            eng._tail_ids[:, :L].copy_(torch.from_numpy(self.ids))
            eng._run_stage(("tail", L, tuple(sorted(flags.items()))),
                           lambda: eng._tail_stage(L, flags), generators=[eng._state.generator])
        row = self.row
        eng._host_knobs[row] = self.knobs
        eng.ctx_len[row] = self.S
        eng._host_active[row] = True
        eng._host_finished[row] = False
        eng._host_gen_len[row] = 1
        eng._host_max_len[row] = self.max_new
        self._finish()
        return True

    def _finish(self) -> None:
        self.done = True
        self.pixels = None
        if self.owner == "chunked":
            self.eng._chunked_busy = False

    def abort(self) -> None:
        """Return the reserved blocks (a failed or cancelled admission)."""
        if not self.done:
            eng = self.eng
            eng._free_row(self.row)
            eng._host_active[self.row] = False
            self._finish()
