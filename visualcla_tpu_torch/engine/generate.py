"""Generation engine: multimodal prefill + KV-cached decode (port of
visualcla_tpu/engine/generate.py).

Prompts are LEFT-padded to a bucket length, so each row's last prompt token
sits at the bucket's final slot and decode writes contiguously after it.
Caller-provided leading pads are honoured, so uneven batched prompts decode
like their single-row runs.  Generation stops on EOS (every row), at
``max_new_tokens`` or at the end of the cache; rows that finish early emit
pad.  ``generate`` returns the generated ids only (the HF ``inputs_embeds``
contract); ``stream`` yields each step's tokens.  Decode is a Python loop of
eager steps (no CUDA graph yet).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from visualcla_tpu.core.config import VisualCLAConfig

from ..models import llama, visualcla
from .sampling import SamplingConfig, check_supported, sample_step

PROMPT_BUCKETS = (128, 256, 512, 1024, 2048)


def pick_bucket(buckets: Tuple[int, ...], n: int) -> int:
    """Smallest bucket >= n."""
    if not buckets:
        raise ValueError("no prompt buckets configured (every bucket exceeded max_seq_len?)")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


@dataclasses.dataclass
class DecodeState:
    cache: dict
    kv_valid: torch.Tensor  # (B, Smax) bool
    cur_slot: int  # next cache slot to write
    positions: torch.Tensor  # (B,) next rope position per row
    gen_ids: torch.Tensor  # (B, max_new_tokens) generated tokens
    gen_len: int  # tokens generated so far
    last_token: torch.Tensor  # (B,)
    finished: torch.Tensor  # (B,) bool
    generator: torch.Generator

    def done(self, max_new_tokens: int) -> bool:
        return (self.gen_len >= max_new_tokens
                or self.cur_slot >= self.kv_valid.shape[1]
                or bool(self.finished.all()))


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
    ):
        self.model = model
        self.cfg = cfg
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.max_seq_len = max_seq_len
        self.prompt_buckets = tuple(b for b in PROMPT_BUCKETS if b <= max_seq_len)
        if not self.prompt_buckets:
            raise ValueError(f"no prompt bucket <= max_seq_len={max_seq_len} "
                             f"(buckets={PROMPT_BUCKETS})")
        p = model.text.embed_tokens
        self.device, self.dtype = p.device, p.dtype

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

    @torch.no_grad()
    def prefill(self, input_ids, pixel_values, img_start_pos, cache_len: int):
        """Left-pad, embed (with the image splice) and run the text tower over
        a fresh ``cache_len``-slot cache.  Returns (final-normed hidden
        (B, S, H), cache, kv_valid (B, cache_len), rope positions (B, S))."""
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
        dev = self.device
        if pixel_values is not None:
            pixel_values = torch.as_tensor(np.asarray(pixel_values)).to(dev, self.dtype)
        cache = llama.init_kv_cache(self.cfg.text_config, B, cache_len, self.dtype,
                                    device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        embeds = visualcla.multimodal_embeds(
            self.model, self.cfg, torch.as_tensor(padded, device=dev), img_pos,
            pixel_values)
        positions = (mask_t.cumsum(-1) - 1).clamp(min=0)
        kv_valid = torch.zeros(B, cache_len, dtype=torch.bool, device=dev)
        kv_valid[:, :Sb] = mask_t.bool()
        hidden, cache = self.model.text(embeds, positions, cache, kv_valid, 0)
        return hidden, cache, kv_valid, positions

    @torch.no_grad()
    def start(self, input_ids, pixel_values, img_start_pos, sampling: SamplingConfig,
              seed: int = 0) -> DecodeState:
        """Prefill and sample the first token."""
        check_supported(sampling)
        B, S = np.asarray(input_ids).shape
        Sb = self.bucket_len(S)
        # the cache holds the bucket plus every new token, in 256-slot steps
        cache_len = max(self.max_seq_len, Sb + sampling.max_new_tokens)
        cache_len = -(-cache_len // 256) * 256
        hidden, cache, kv_valid, positions = self.prefill(
            input_ids, pixel_values, img_start_pos, cache_len)
        last_logits = self.model.text.logits(hidden[:, -1:])[:, 0]
        dev = self.device
        generator = torch.Generator(device=dev).manual_seed(seed)
        gen_ids = torch.zeros(B, sampling.max_new_tokens, dtype=torch.int64, device=dev)
        zeros = torch.zeros(B, dtype=torch.int64, device=dev)
        token = sample_step(last_logits, gen_ids, zeros, generator, sampling)
        gen_ids[:, 0] = token
        return DecodeState(
            cache=cache, kv_valid=kv_valid, cur_slot=Sb,
            positions=positions[:, -1] + 1, gen_ids=gen_ids, gen_len=1,
            last_token=token, finished=token == self.eos_token_id,
            generator=generator)

    @torch.no_grad()
    def step(self, state: DecodeState, sampling: SamplingConfig) -> DecodeState:
        """One decode step, updating ``state`` in place."""
        B = state.last_token.shape[0]
        text = self.model.text
        state.kv_valid[:, state.cur_slot] = True
        embeds = text.embed(state.last_token[:, None])
        hidden, _ = text(embeds, state.positions[:, None], state.cache,
                         state.kv_valid, state.cur_slot)
        step_logits = text.logits(hidden)[:, 0]
        gen_len_b = torch.full((B,), state.gen_len, dtype=torch.int64,
                               device=self.device)
        token = sample_step(step_logits, state.gen_ids, gen_len_b, state.generator,
                            sampling)
        token = torch.where(state.finished, torch.full_like(token, self.pad_token_id),
                            token)
        state.gen_ids[:, state.gen_len] = token
        state.finished |= token == self.eos_token_id
        state.last_token = token
        state.cur_slot += 1
        state.positions = state.positions + 1
        state.gen_len += 1
        return state

    def generate(self, input_ids, pixel_values=None, img_start_pos=None,
                 sampling: Optional[SamplingConfig] = None, seed: int = 0) -> np.ndarray:
        """(B, <= max_new_tokens) generated ids."""
        sampling = sampling or SamplingConfig.greedy()
        state = self.start(input_ids, pixel_values, img_start_pos, sampling, seed)
        while not state.done(sampling.max_new_tokens):
            state = self.step(state, sampling)
        return state.gen_ids[:, :state.gen_len].cpu().numpy()

    def stream(self, input_ids, pixel_values=None, img_start_pos=None,
               sampling: Optional[SamplingConfig] = None,
               seed: int = 0) -> Iterator[np.ndarray]:
        """Yield the (B,) token ids of each step as they are produced."""
        sampling = sampling or SamplingConfig.greedy()
        state = self.start(input_ids, pixel_values, img_start_pos, sampling, seed)
        yield state.last_token.cpu().numpy()
        while not state.done(sampling.max_new_tokens):
            state = self.step(state, sampling)
            yield state.last_token.cpu().numpy()
