"""The one traffic generator: an open loop of single-turn multimodal chats
from a workload file's parameters and the run's seed.

The arrivals are one Poisson path, the same for every run of a window's
length: the exponential distribution's quantiles at n evenly spaced
probabilities (n = rate x seconds), in an order drawn from the workload
file's ``arrival_seed``.  Every seed gets the same multiset of requests in
another order: the instruction and answer lengths are the log-normal's
quantiles, clipped, exactly ``sampled_share`` of the requests sample (the
rest are greedy), and the seed permutes each list on its own and draws the
text and the images.  So two seeds differ in which requests meet a clump of
arrivals, and not in how much there is to do or when it comes.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List

import numpy as np

from .vocab import instruction_alphabet


@dataclasses.dataclass
class Planned:
    due: float  # seconds after the window opens
    instruction: str
    instruction_tokens: int
    max_new_tokens: int
    sampled: bool
    image_seed: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lognormal_lengths(spec: dict, n: int) -> np.ndarray:
    """n lengths at the log-normal's stratified quantiles, clipped and rounded."""
    z = np.asarray([NormalDist().inv_cdf(u) for u in _quantiles(n)])
    x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def arrival_times(rate: float, seconds: float, n: int, rng) -> np.ndarray:
    """n due times in [0, seconds): permuted exponential gaps, the first at 0,
    scaled so that the mean rate is exactly ``rate`` over the window."""
    if n == 0:
        return np.zeros(0)
    gaps = rng.permutation(-np.log1p(-_quantiles(n)))
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return t * (seconds / gaps.sum())


def schedule(cell: dict, seed: int, seconds: float, vocab_size: int,
             rate: float = None) -> List[Planned]:
    """The requests due in a window of ``seconds``, in due order."""
    rate = cell["rate_per_s"] if rate is None else rate
    n = int(round(rate * seconds))
    due = arrival_times(rate, seconds, n, np.random.default_rng(cell["arrival_seed"]))
    rng = np.random.default_rng(seed)
    instr = rng.permutation(lognormal_lengths(cell["instruction_tokens"], n))
    new = rng.permutation(lognormal_lengths(cell["max_new_tokens"], n))
    sampled = np.zeros(n, bool)
    sampled[:int(round(cell["sampled_share"] * n))] = True
    sampled = rng.permutation(sampled)
    alphabet = np.asarray(instruction_alphabet(vocab_size))
    out = []
    for i in range(n):
        text = "".join(rng.choice(alphabet, int(instr[i])))
        out.append(Planned(float(due[i]), text, int(instr[i]), int(new[i]), bool(sampled[i]),
                           int(rng.integers(2 ** 62))))
    return out


def image(seed: int, height: int, width: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (height, width, 3), dtype=np.uint8)


def generation_config(cell: dict, p: Planned) -> dict:
    """The request's ``generation_config``: the greedy or the sampled preset
    and its answer cap."""
    preset = cell["sampled_preset"] if p.sampled else cell["greedy_preset"]
    return {**preset, "max_new_tokens": p.max_new_tokens}
