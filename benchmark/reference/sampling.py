"""What the served sampler may pick, as a request's generation config states
it, over the reference's logits: HF's processors and warpers in their order
(repetition penalty, no-repeat-ngram, then temperature, top-k and top-p),
each position seeing the tokens generated before it, as HF does when it
generates from ``inputs_embeds``.  A request that does not sample may pick
only the best processed logit.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def processed(logits: torch.Tensor, generated: List[int], config: dict) -> torch.Tensor:
    """(n, V) logits, row i predicting ``generated[i]`` -> the same after the
    repetition penalty over ``generated[:i]`` and the ban of every token that
    would repeat an n-gram of it (-inf)."""
    n, V = logits.shape
    out = logits
    penalty = config.get("repetition_penalty", 1.0)
    if penalty != 1.0:
        first: Dict[int, int] = {}
        for i, t in enumerate(generated[:n]):
            first.setdefault(t, i)
        seen = torch.zeros(n, V, dtype=torch.bool, device=logits.device)
        for t, i in first.items():
            seen[i + 1:, t] = True
        out = torch.where(seen, torch.where(out < 0, out * penalty, out / penalty), out)
    size = config.get("no_repeat_ngram_size", 0)
    if size > 0:
        banned = torch.zeros(n, V, dtype=torch.bool, device=logits.device)
        follows: Dict[Tuple[int, ...], set] = {}
        for i in range(n):
            if i >= size:  # the n-gram that ended at i - 1 is now in the context
                follows.setdefault(tuple(generated[i - size:i - 1]), set()).add(generated[i - 1])
            if i >= size - 1:
                for t in follows.get(tuple(generated[i - size + 1:i]), ()):
                    banned[i, t] = True
        out = out.masked_fill(banned, float("-inf"))
    return out


def kept(proc: torch.Tensor, config: dict) -> torch.Tensor:
    """(n, V) processed logits -> (n, V) bool: the tokens the sampler may draw
    at each position (the best alone where it does not sample)."""
    if not config.get("do_sample", False):
        return proc >= proc.max(-1, keepdim=True).values
    x = proc / config.get("temperature", 1.0)
    k = config.get("top_k", 0)
    if k > 0:
        kth = torch.topk(x, min(k, x.shape[-1]), dim=-1).values[:, -1:]
        x = x.masked_fill(x < kth, float("-inf"))
    p = config.get("top_p", 1.0)
    if p < 1.0:
        s, order = torch.sort(x, dim=-1, stable=True)
        remove = s.softmax(-1).cumsum(-1) <= 1.0 - p
        remove[:, -1] = False
        x = x.masked_fill(torch.zeros_like(remove).scatter(1, order, remove), float("-inf"))
    return x > float("-inf")


def ngram_repeats(tokens: List[int], size: int) -> int:
    """How many of ``tokens``' n-grams occurred earlier in them."""
    if size <= 0:
        return 0
    grams = [tuple(tokens[i:i + size]) for i in range(len(tokens) - size + 1)]
    return len(grams) - len(set(grams))
