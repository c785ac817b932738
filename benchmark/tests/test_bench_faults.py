"""The comparison that decides ``correct`` fails a broken timed path: a
whole run (the chip's look skipped, the CPU in its place, a tiny
configuration) with one fault planted under the served path each time —
a token altered where it is produced (in every row, or in the rows that
sample alone), a decode step that leaves the pool unchanged, half of the
pool's rows left out — reads ``correct`` false, and the sound run true.  (One chip: no exchange between chips to leave out.)"""
from __future__ import annotations

import copy

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_config

CELL = "ds7b-serve-poisson"
# the widest-gap limit at this size: the tiny tower's logits spread about a
# fifth as wide as the full-width towers' (std ~0.25 against ~1.3), and its
# sound bf16 runs read about 1e-3
TINY_MAX_GAP = 0.02


def _cell():
    cell = copy.deepcopy(run.load_json(run.BENCH, "workloads", CELL + ".json"))
    cell.update(rate_per_s=6.0, max_new_tokens={"median": 10, "sigma": 0.4, "min": 4, "max": 16},
                instruction_tokens={"median": 16, "sigma": 0.5, "min": 8, "max": 40},
                limits={"max_gap": TINY_MAX_GAP})
    return cell


def _run(cfg=None):
    cfg = cfg or tiny_config()
    cfg["pool"]["rows"] = 2
    return run.run_cell(CELL, 2 ** 31 + 11, 2.0, False, device=torch.device("cpu"), cfg=cfg,
                        cell=_cell())


def _alter_tokens(monkeypatch):
    from visualcla_tpu_torch.engine import paged

    orig = paged.sample_step_rowwise

    def altered(logits, *a, **k):
        tok, mu = orig(logits, *a, **k)
        return (tok + 1) % logits.shape[-1], mu

    monkeypatch.setattr(paged, "sample_step_rowwise", altered)


def _alter_sampled_tokens(monkeypatch):
    """Only the rows that sample: a token outside what top-k and top-p keep."""
    from visualcla_tpu_torch.engine import paged

    orig = paged.sample_step_rowwise

    def altered(logits, *a, **k):
        tok, mu = orig(logits, *a, **k)
        return torch.where(k["do_sample"], (tok + 1) % logits.shape[-1], tok), mu

    monkeypatch.setattr(paged, "sample_step_rowwise", altered)


def _unchanged_pool(monkeypatch):
    from visualcla_tpu_torch.engine import paged

    orig = paged.paged_append_attention

    def on_copies(q, k, v, k_pool, v_pool, *a, **k2):
        return orig(q, k, v, k_pool.clone(), v_pool.clone(), *a, **k2)

    monkeypatch.setattr(paged, "paged_append_attention", on_copies)


def _half_the_rows(monkeypatch):
    from visualcla_tpu_torch.engine import paged

    orig = paged.paged_decode_forward

    def first_half(*a, **k):
        h = orig(*a, **k)
        half = h.shape[0] // 2
        return torch.cat([h[:half], h[:h.shape[0] - half]])

    monkeypatch.setattr(paged, "paged_decode_forward", first_half)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 12


@pytest.mark.parametrize("fault", [_alter_tokens, _alter_sampled_tokens, _unchanged_pool,
                                   _half_the_rows])
def test_a_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run()
    assert not res["correct"], res["checks"]
