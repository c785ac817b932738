"""Generation engine: multimodal prefill + KV-cached decode (port of
visualcla_tpu/engine/generate.py).

Prompts are LEFT-padded to a bucket length, so each row's last prompt token
sits at the bucket's final slot and decode writes contiguously after it.
Caller-provided leading pads are honoured, so uneven batched prompts decode
like their single-row runs.  Generation stops on EOS (every row), at
``max_new_tokens`` or at the end of the cache; rows that finish early emit
pad.  ``generate`` returns the generated ids only (the HF ``inputs_embeds``
contract); ``stream`` yields each step's tokens (``chunk_size`` steps between
host reads).

Decode is the JAX package's ``_decode_loop`` as captured CUDA graphs
(``engine/graphs.py``): ``step`` is one decode step over device tensors only,
gated by the JAX loop's ``cond`` (``gen_len < max_steps``, not every row
finished, ``cur_slot < Smax``); it is captured once per key and replayed
``DECODE_CHUNK`` times (fewer at the end) between host reads of one control
tensor, until the host sees the ``cond`` false.  ``start`` (the JAX
package's jitted prefill and first sample) is captured too, one graph per
(B, bucket, cache length, image count and size, vision attention, the
sampler's static config): the host pads the prompt, checks the markers and
copies ids, mask, marker positions and pixels into the workspace's static
buffers of that shape, then replays the cache reset, the image encode and
splice, the text tower at the bucket (kernel B2), the last position's
logits and the first sample.
The state lives in a workspace per (B, cache length): the KV cache,
``kv_valid``, the token buffers, the sampler state and the generator, which
each prefill resets and refills in place, so a graph's addresses stay valid
from request to request.  A request claims its workspace under the engine's
lock (``workspace``) and gives it back at its end (``release``): two calls
that overlap get two workspaces, the second a private one dropped after it.
The engine keeps at most ``MAX_WORKSPACES`` workspaces (each holds a whole
KV cache, 1.07 GB for B=1 at 2048 bf16 slots at 7B) and
``graphs.MAX_GRAPHS`` graphs a key space.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..core.config import VisualCLAConfig

from ..models import llama, visualcla
from ..ops.attention import vision_attention_impl
from ..utils.profiling import GLOBAL_COUNTERS, PhaseTimer
from .graphs import LOCK, Graphs
from .sampling import SamplingConfig, sample_step

PROMPT_BUCKETS = (128, 256, 512, 1024, 2048)
DECODE_CHUNK = 8  # decode steps (replays of the captured step) between host reads
MAX_WORKSPACES = 2  # (B, cache length) shapes an Engine keeps buffers for
_TOKENS = itertools.count()


def pick_bucket(buckets: Tuple[int, ...], n: int) -> int:
    """Smallest bucket >= n."""
    if not buckets:
        raise ValueError("no prompt buckets configured (every bucket exceeded max_seq_len?)")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


def static_key(sampling: SamplingConfig) -> SamplingConfig:
    """What a decode step bakes in of ``sampling``: all of it but
    ``max_new_tokens``, which the step reads from a device buffer."""
    return dataclasses.replace(sampling, max_new_tokens=0)


class Workspace:
    """The persistent device buffers of one (B, cache length): the KV cache,
    ``kv_valid``, the decode state (``gen_ids`` as wide as the cache, which
    bounds every generation), the speculative decoder's counters and prompt
    buffers, and the generator.  ``token`` names it in graph keys."""

    def __init__(self, eng: "Engine", B: int, cache_len: int):
        dev = eng.device
        self.token = next(_TOKENS)
        self.key = (B, cache_len)
        self.busy = False  # claimed by a request (Engine.workspace .. release)
        self.cache = llama.init_kv_cache(eng.cfg.text_config, B, cache_len, eng.dtype,
                                         device=dev, kv_quant=eng.kv_quant)
        self.kv_valid = torch.zeros(B, cache_len, dtype=torch.bool, device=dev)
        self.gen_ids = torch.zeros(B, cache_len, dtype=torch.int64, device=dev)
        z = dict(dtype=torch.int64, device=dev)
        self.cur_slot, self.positions = torch.zeros(B, **z), torch.zeros(B, **z)
        self.gen_len, self.last_token = torch.zeros(B, **z), torch.zeros(B, **z)
        self.finished = torch.zeros(B, dtype=torch.bool, device=dev)
        self.mu = torch.zeros(B, dtype=torch.float32, device=dev)
        self.max_steps = torch.zeros((), **z)
        self.spec_counts = torch.zeros(3, **z)  # chunks, emitted, row-chunks
        self.prompts: dict = {}  # prompt bucket -> (ids (B, Lb), first real index (B,))
        self.inputs: dict = {}  # PrefillInputs.key -> the prefill's static inputs
        self.generator = torch.Generator(device=dev)
        self.rows = torch.arange(B, device=dev)


class PrefillInputs:
    """A prefill's static device inputs for one shape: the left-padded ids
    and mask (B, Sb), the marker positions (B,) or (B, K) (-1: no image)
    and the pixels (B[, K], 3, H, W), or None for a text prompt."""

    def __init__(self, ids: np.ndarray, mask: np.ndarray, img_pos: np.ndarray,
                 pixels: Optional[torch.Tensor], device, dtype):
        self.key = self.key_of(ids, img_pos, pixels)
        z = dict(dtype=torch.int64, device=device)
        self.ids, self.mask = torch.zeros(ids.shape, **z), torch.zeros(mask.shape, **z)
        self.img_pos = torch.zeros(img_pos.shape, **z)
        self.pixels = (None if pixels is None
                       else torch.zeros(pixels.shape, dtype=dtype, device=device))

    @staticmethod
    def key_of(ids, img_pos, pixels) -> tuple:
        return (ids.shape, img_pos.shape, None if pixels is None else tuple(pixels.shape))

    @classmethod
    def staged(cls, store: dict, ids, mask, img_pos, pixels, device, dtype) -> "PrefillInputs":
        """The buffers of this shape in ``store`` (made at first use), filled."""
        key = cls.key_of(ids, img_pos, pixels)
        if key not in store:
            store[key] = cls(ids, mask, img_pos, pixels, device, dtype)
        return store[key].fill(ids, mask, img_pos, pixels)

    def fill(self, ids, mask, img_pos, pixels) -> "PrefillInputs":
        """Copy one request's host inputs in (outside any capture)."""
        self.ids.copy_(torch.from_numpy(ids))
        self.mask.copy_(torch.from_numpy(mask))
        self.img_pos.copy_(torch.from_numpy(np.ascontiguousarray(img_pos, np.int64)))
        if pixels is not None:
            self.pixels.copy_(pixels)
        return self


def host_pixels(pixel_values) -> Optional[torch.Tensor]:
    """Pixel values (numpy or a tensor) as a tensor, not yet moved."""
    if pixel_values is None:
        return None
    if isinstance(pixel_values, torch.Tensor):
        return pixel_values
    return torch.from_numpy(np.ascontiguousarray(pixel_values))


@dataclasses.dataclass
class DecodeState:
    """Views of a workspace's buffers (every field but ``ws`` a device
    tensor; ``cur_slot`` and ``gen_len`` hold one value for every row)."""

    cache: dict
    kv_valid: torch.Tensor  # (B, Smax) bool
    cur_slot: torch.Tensor  # (B,) next cache slot to write
    positions: torch.Tensor  # (B,) next rope position per row
    gen_ids: torch.Tensor  # (B, Smax) generated tokens
    gen_len: torch.Tensor  # (B,) tokens generated so far
    last_token: torch.Tensor  # (B,)
    finished: torch.Tensor  # (B,) bool
    generator: torch.Generator
    mu: torch.Tensor  # (B,) fp32 mirostat state
    max_steps: torch.Tensor  # () the loop's bound on gen_len
    ws: Workspace

    @classmethod
    def of(cls, ws: Workspace) -> "DecodeState":
        return cls(cache=ws.cache, kv_valid=ws.kv_valid, cur_slot=ws.cur_slot,
                   positions=ws.positions, gen_ids=ws.gen_ids, gen_len=ws.gen_len,
                   last_token=ws.last_token, finished=ws.finished, generator=ws.generator,
                   mu=ws.mu, max_steps=ws.max_steps, ws=ws)


class Engine:
    """Prefill and decode for one model on one device."""

    def __init__(
        self,
        model: visualcla.VisualCLAModel,
        cfg: VisualCLAConfig,
        *,
        eos_token_id: int,
        pad_token_id: int = 0,
        max_seq_len: int = 2048,
        kv_quant: str = "none",  # "int8": int8 K/V with per-token-per-head scales
    ):
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
        self.kv_quant = kv_quant
        self.model = model
        self.cfg = cfg
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.max_seq_len = max_seq_len
        self.prompt_buckets = tuple(b for b in PROMPT_BUCKETS if b <= max_seq_len)
        if not self.prompt_buckets:
            raise ValueError(f"no prompt bucket <= max_seq_len={max_seq_len} "
                             f"(buckets={PROMPT_BUCKETS})")
        p = model.text.final_norm.weight  # a float leaf at every weight tier
        self.device, self.dtype = p.device, p.dtype
        self._workspaces: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()  # guards the workspaces' claims
        self.graphs = Graphs()
        self.timer = PhaseTimer()  # generate's prefill / decode phases
        # forward passes run on the device by the decode steps (gated ones
        # included): each launches B1 once a layer; "spec_passes" the same
        # for the speculative decoder's verify chunks (B2 once a layer);
        # "prefill_passes" the prefills (B2 once a layer; a capture's
        # warm-up is one)
        self.counts = {"decode_passes": 0, "spec_passes": 0, "prefill_passes": 0}

    def bucket_len(self, prompt_len: int) -> int:
        return pick_bucket(self.prompt_buckets, prompt_len)

    def pad_prompt(self, input_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Left-pad (B, S) ids to a bucket -> (padded ids, mask); leading
        pads (id == pad_token_id) in the input get mask 0 too."""
        B, S = input_ids.shape
        L = self.bucket_len(S)
        ids = np.full((B, L), self.pad_token_id, np.int64)
        mask = np.zeros((B, L), np.int64)
        ids[:, L - S:] = input_ids
        mask[:, L - S:] = 1
        real = input_ids != self.pad_token_id
        lead = np.where(real.any(axis=1), real.argmax(axis=1), S)
        mask[np.arange(L)[None, :] < (L - S + lead)[:, None]] = 0
        return ids, mask

    # -- workspaces -----------------------------------------------------------

    def workspace(self, B: int, cache_len: int) -> Workspace:
        """Claim a workspace of this shape for one request: the cached one if
        it is free, else a private one, dropped with its graphs at
        ``release``.  The claim is atomic: two requests never share one."""
        key = (B, cache_len)
        with self._lock:
            ws = self._workspaces.get(key)
            if ws is not None and not ws.busy:
                ws.busy = True
                self._workspaces.move_to_end(key)
                return ws
            private = ws is not None
            ws = Workspace(self, B, cache_len)
            ws.busy = True
            if private:
                return ws
            self._workspaces[key] = ws
            for old in [w for w in self._workspaces.values() if not w.busy]:
                if len(self._workspaces) <= MAX_WORKSPACES:
                    break
                del self._workspaces[old.key]
                self.graphs.drop(lambda k, t=old.token: k[0] == t)
            return ws

    def release(self, ws: Workspace) -> None:
        """The request that claimed ``ws`` ended."""
        with self._lock:
            ws.busy = False
            cached = self._workspaces.get(ws.key) is ws
        if not cached:
            self.graphs.drop(lambda k: k[0] == ws.token)

    # -- prefill --------------------------------------------------------------

    def stage_prompt(self, ws: Workspace, input_ids, pixel_values,
                     img_start_pos) -> PrefillInputs:
        """The host side of a prefill: left-pad to the bucket, shift and
        check the markers, and copy ids, mask, markers and pixels into the
        workspace's static buffers of that shape."""
        input_ids = np.asarray(input_ids, np.int64)
        B, S = input_ids.shape
        padded, mask = self.pad_prompt(input_ids)
        Sb = padded.shape[1]
        if img_start_pos is None:
            img_pos = np.full((B,), -1, np.int64)
        else:
            ip = np.asarray(img_start_pos)
            img_pos = np.where(ip < 0, -1, ip + (Sb - S))
            visualcla.check_img_start_pos(img_pos, self.cfg.num_image_tokens, Sb)
        return PrefillInputs.staged(ws.inputs, padded, mask, img_pos, host_pixels(pixel_values),
                                    self.device, self.dtype)

    def _prefill_device(self, ws: Workspace, inp: PrefillInputs):
        """The device side of a prefill, over static buffers only: reset the
        cache (zeros, int8 scales one, no valid slot), embed with the image
        splice and run the text tower at the bucket.
        -> (final-normed hidden (B, Sb, H), rope positions (B, Sb))."""
        for name, buf in ws.cache.items():
            buf.fill_(1 if name.endswith("_scale") else 0)
        embeds = visualcla.multimodal_embeds(self.model, self.cfg, inp.ids, inp.img_pos,
                                             inp.pixels)
        positions = (inp.mask.cumsum(-1) - 1).clamp(min=0)
        ws.kv_valid.zero_()
        ws.kv_valid[:, :inp.ids.shape[1]] = inp.mask.bool()
        hidden, _ = self.model.text(embeds, positions, ws.cache, ws.kv_valid, 0)
        self.counts["prefill_passes"] += 1
        return hidden, positions

    @torch.no_grad()
    def prefill(self, input_ids, pixel_values, img_start_pos, cache_len: int,
                ws: Optional[Workspace] = None):
        """Left-pad, embed (with the image splice) and run the text tower over
        the ``cache_len``-slot cache of ``ws`` (by default a workspace of that
        shape, claimed for the call), reset first, eagerly.  Returns
        (final-normed hidden (B, S, H), cache, kv_valid (B, cache_len), rope
        positions (B, S))."""
        own = ws is None
        if own:
            ws = self.workspace(np.asarray(input_ids).shape[0], cache_len)
        try:
            inp = self.stage_prompt(ws, input_ids, pixel_values, img_start_pos)
            with LOCK:
                hidden, positions = self._prefill_device(ws, inp)
            return hidden, ws.cache, ws.kv_valid, positions
        finally:
            if own:
                self.release(ws)

    def cache_len(self, Sb: int, max_new_tokens: int, extra_slots: int = 0) -> int:
        """The cache holds the bucket plus every new token, in 256-slot steps."""
        n = max(self.max_seq_len, Sb + max_new_tokens + extra_slots)
        return -(-n // 256) * 256

    def _start_step(self, ws: Workspace, inp: PrefillInputs, sampling: SamplingConfig) -> None:
        """The captured start: the prefill, the last position's logits, the
        first sample and the decode state, over static buffers only."""
        hidden, positions = self._prefill_device(ws, inp)
        last_logits = self.model.text.logits(hidden[:, -1:])[:, 0]
        B = last_logits.shape[0]
        ws.gen_ids.zero_()
        ws.mu.fill_(2.0 * sampling.mirostat_tau)
        zeros = torch.zeros(B, dtype=torch.int64, device=self.device)
        token, mu = sample_step(last_logits, ws.gen_ids, zeros, ws.generator, ws.mu, sampling)
        ws.gen_ids[:, 0] = token
        ws.mu.copy_(mu)
        ws.last_token.copy_(token)
        ws.finished.copy_(token == self.eos_token_id)
        ws.cur_slot.fill_(inp.ids.shape[1])
        ws.positions.copy_(positions[:, -1] + 1)
        ws.gen_len.fill_(1)
        ws.spec_counts.zero_()

    @torch.no_grad()
    def start(self, input_ids, pixel_values, img_start_pos, sampling: SamplingConfig,
              seed: int = 0, extra_slots: int = 0) -> DecodeState:
        """Claim a workspace, prefill and sample the first token into it: a
        replay of the start captured for this shape (eagerly on CPU
        tensors).  ``extra_slots`` adds cache headroom (a speculative verify
        chunk writes K+1 slots at once).  The caller ends the request with
        ``release(state.ws)``."""
        B, S = np.asarray(input_ids).shape
        Sb = self.bucket_len(S)
        ws = self.workspace(B, self.cache_len(Sb, sampling.max_new_tokens, extra_slots))
        try:
            inp = self.stage_prompt(ws, input_ids, pixel_values, img_start_pos)
            ws.generator.manual_seed(seed)
            ws.max_steps.fill_(sampling.max_new_tokens)
            self.graphs.run((ws.token, "start", inp.key, vision_attention_impl(),
                             static_key(sampling)),
                            lambda: self._start_step(ws, inp, sampling), self.device,
                            generators=[ws.generator], counters=[self.counts], space="prefill")
        except BaseException:
            self.release(ws)
            raise
        return DecodeState.of(ws)

    # -- decode ---------------------------------------------------------------

    @torch.no_grad()
    def step(self, state: DecodeState, sampling: SamplingConfig) -> DecodeState:
        """One decode step over device tensors only, in place, gated by the
        JAX loop's ``cond``: with ``go`` false it writes K/V into the next
        slot (not valid, or the last one once the cache is full: the loop
        has stopped for good then) and changes nothing else."""
        B, Smax = state.kv_valid.shape
        T = state.gen_ids.shape[1]
        go = (((state.gen_len < state.max_steps) & (state.cur_slot < Smax)).all()
              & ~state.finished.all() & self.graphs.enable(self.device))
        rows = state.ws.rows
        slot = state.cur_slot.clamp(max=Smax - 1)
        state.kv_valid[rows, slot] = state.kv_valid[rows, slot] | go
        text = self.model.text
        hidden, _ = text(text.embed(state.last_token[:, None]), state.positions[:, None],
                         state.cache, state.kv_valid, slot)
        step_logits = text.logits(hidden)[:, 0]
        token, mu = sample_step(step_logits, state.gen_ids, state.gen_len, state.generator,
                                state.mu, sampling)
        token = torch.where(state.finished, torch.full_like(token, self.pad_token_id), token)
        at = state.gen_len.clamp(max=T - 1)
        state.gen_ids[rows, at] = torch.where(go, token, state.gen_ids[rows, at])
        state.finished |= go & (token == self.eos_token_id)
        state.last_token.copy_(torch.where(go, token, state.last_token))
        state.mu.copy_(torch.where(go, mu, state.mu))
        adv = go.long()
        state.cur_slot += adv
        state.positions += adv
        state.gen_len += adv
        self.counts["decode_passes"] += 1
        return state

    def _decode(self, state: DecodeState, sampling: SamplingConfig, n: int) -> None:
        """``n`` gated steps: replays of the step captured on the card."""
        self.graphs.run((state.ws.token, "decode", static_key(sampling)),
                        lambda: self.step(state, sampling), self.device,
                        generators=[state.generator], counters=[self.counts], replays=n)

    @staticmethod
    def control(state: DecodeState) -> Tuple[int, int, bool]:
        """(gen_len, cur_slot, every row finished): one device-to-host copy."""
        c = torch.stack((state.gen_len[0], state.cur_slot[0],
                         state.finished.all().long())).cpu().numpy()
        return int(c[0]), int(c[1]), bool(c[2])

    @torch.no_grad()
    def decode(self, state: DecodeState, sampling: SamplingConfig,
               max_steps: Optional[int] = None) -> int:
        """Decode until the JAX loop's stop rule: ``gen_len`` reaches
        ``max_steps`` (default ``max_new_tokens``), every row finished, or
        the cache is full: ``DECODE_CHUNK`` steps (fewer where fewer remain)
        between host reads.  -> gen_len."""
        target = sampling.max_new_tokens if max_steps is None else max_steps
        Smax = state.kv_valid.shape[1]
        state.max_steps.fill_(target)
        gen_len, cur_slot, done = self.control(state)
        while gen_len < target and not done and cur_slot < Smax:
            self._decode(state, sampling, min(target - gen_len, Smax - cur_slot, DECODE_CHUNK))
            gen_len, cur_slot, done = self.control(state)
        return gen_len

    def generate(self, input_ids, pixel_values=None, img_start_pos=None,
                 sampling: Optional[SamplingConfig] = None, seed: int = 0) -> np.ndarray:
        """(B, <= max_new_tokens) generated ids.  Times the "prefill" and
        "decode" phases on ``timer`` and adds ``generated_tokens`` and
        ``requests`` to ``GLOBAL_COUNTERS``, as the JAX engine does."""
        sampling = sampling or SamplingConfig.greedy()
        with self.timer.phase("prefill") as p:
            state = self.start(input_ids, pixel_values, img_start_pos, sampling, seed)
            p["sync_on"] = state.last_token
        try:
            with self.timer.phase("decode"):
                gen_len = self.decode(state, sampling)
            # a copy: on the CPU .numpy() would alias the workspace's buffer
            out = state.gen_ids[:, :gen_len].cpu().numpy().copy()
        finally:
            self.release(state.ws)
        GLOBAL_COUNTERS.add("generated_tokens", gen_len * out.shape[0])
        GLOBAL_COUNTERS.add("requests", out.shape[0])
        return out

    def stream(self, input_ids, pixel_values=None, img_start_pos=None,
               sampling: Optional[SamplingConfig] = None,
               seed: int = 0, chunk_size: int = 1) -> Iterator[np.ndarray]:
        """Yield the (B,) token ids of each step as they are produced.

        ``chunk_size > 1`` replays the captured step that many times between
        host reads (one copy of the chunk's tokens instead of one a step)
        and still yields token by token; the stream ends after the step at
        which every row has finished, as with ``chunk_size=1``."""
        sampling = sampling or SamplingConfig.greedy()
        state = self.start(input_ids, pixel_values, img_start_pos, sampling, seed)
        try:
            yield state.last_token.cpu().numpy()
            T = sampling.max_new_tokens
            Smax = state.kv_valid.shape[1]
            B = state.last_token.shape[0]
            k = max(chunk_size, 1)
            gen_len, cur_slot, done = self.control(state)
            while gen_len < T and not done and cur_slot < Smax:
                state.max_steps.fill_(min(gen_len + k, T))
                with torch.no_grad():
                    self._decode(state, sampling, min(k, T - gen_len))
                row = torch.cat([state.gen_len[:1], state.cur_slot[:1],
                                 state.finished.all().long()[None],
                                 state.gen_ids[:, gen_len:gen_len + k].reshape(-1)])
                row = row.cpu().numpy()
                new_len, cur_slot, done = int(row[0]), int(row[1]), bool(row[2])
                toks = row[3:].reshape(B, -1)
                for j in range(new_len - gen_len):
                    yield toks[:, j]
                gen_len = new_len
        finally:
            self.release(state.ws)
