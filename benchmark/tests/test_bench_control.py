"""The control comes out not correct: the reference put in the program's
place one precision below what the configuration states (fp8 weights for a
bf16 tower; an int4 KV cache for an int8 one) reads a widest gap that the
cell's limit refuses, where the program's own reading passes it.  At the
cells' own size on the card (marked ``cuda``), and at a tiny size on the CPU
against the program's reading there."""
from __future__ import annotations

import copy
import os
import types

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_config
from benchmark.tools.readings import control_readings

CELLS = ["ds7b-serve-poisson", "mistral7b-int4-serve-poisson"]


def _driver(cell):
    return run.load_module(os.path.join(run.BENCH, "drivers", cell["driver"] + ".py"),
                           "benchmark_driver_" + cell["driver"])


def _readings(cell, cfg, seed, seconds, device):
    driver = _driver(cell)
    ctx = types.SimpleNamespace(cfg=cfg, cell=cell, seed=seed, seconds=seconds, trace=False,
                                device=device, log=lambda m: None)
    record = driver.run(ctx)
    return control_readings(record, ctx, driver, faults=True)


@pytest.mark.parametrize("tiers", [("bf16", "bf16", {"weights": "fp8", "activations": "fp8", "kv": "bf16"}),
                                   ("int4", "int8", {"weights": "int4", "kv": "int4"})])
def test_the_control_reads_far_above_the_program_at_a_tiny_size(tiers):
    weights, kv, control = tiers
    cfg = tiny_config(weights=weights, kv_cache=kv)
    cfg["control"] = control
    cell = copy.deepcopy(run.load_json(run.BENCH, "workloads", CELLS[0] + ".json"))
    cell.update(rate_per_s=4.0, max_new_tokens={"median": 24, "sigma": 0.3, "min": 16, "max": 32},
                instruction_tokens={"median": 16, "sigma": 0.5, "min": 8, "max": 40})
    r = _readings(cell, cfg, 2 ** 31 + 5, 2.0, torch.device("cpu"))
    assert r["control"] >= 3 * r["program"], r
    assert r["fault_token_altered"] >= 3 * r["program"], r


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cells_limit_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the cell's own size")
    cell = run.load_json(run.BENCH, "workloads", name + ".json")
    cfg = run.load_config(cell["config"])
    r = _readings(cell, cfg, 2 ** 31 + 17, 10.0, torch.device("cuda"))
    limit = cell["limits"]["max_gap"]
    assert r["program"] <= limit < r["control"], r
