"""The ``ds7b-chat-b1`` cell's ``drivers/chat_closed_loop.py`` on the CPU at a
tiny size: one user's turns back to back through ``api.chat_in_stream``, a
record that the existing readers read (the end-to-end metrics, ``tail.*``,
and ``mfu`` / ``device_idle_share.serve`` over a profiled slice), the turns
sent inside the window only, and ``serve_open_loop.check``'s comparison
reading the run correct, and not correct with a token altered."""
from __future__ import annotations

import copy
import os
import types

import torch

from benchmark import run
from benchmark.tests.tiny import tiny_config

CELL = "ds7b-chat-b1"
TINY_MAX_GAP = 0.02  # test_bench_faults.py's limit for this tower at this size


def _cell():
    cell = copy.deepcopy(run.load_json(run.BENCH, "workloads", CELL + ".json"))
    cell.update(max_new_tokens={"median": 8, "sigma": 0.4, "min": 4, "max": 12},
                instruction_tokens={"median": 16, "sigma": 0.5, "min": 8, "max": 40},
                limits={"max_gap": TINY_MAX_GAP})
    return cell


def _driver(cell):
    return run.load_module(os.path.join(run.BENCH, "drivers", cell["driver"] + ".py"),
                           "benchmark_driver_" + cell["driver"])


def test_the_closed_loop_record_reads_and_checks():
    cell = _cell()
    ctx = types.SimpleNamespace(cfg=tiny_config(), cell=cell, seed=2 ** 31 + 9, seconds=2.0,
                                trace=False, device=torch.device("cpu"), log=lambda m: None)
    record = _driver(cell).run(ctx)
    reqs = record["requests"]
    assert reqs and all(r.final is not None and r.error is None for r in reqs)
    assert all(r.due < record["t1"] for r in reqs)  # none sent after the window
    for a, b in zip(reqs, reqs[1:]):  # closed loop: a turn is sent after the last ends
        assert b.due >= a.times[-1]
    record["setup_s"] = 1.0
    manifest = run.load_json(run.REPO, "BENCHMARK.json")
    e2e = run.read_metrics(run.cell_metrics(manifest, CELL, False), record)
    assert set(e2e) == {"ttft_p50_ms", "output_tok_s", "setup_s"}
    assert 0 < e2e["ttft_p50_ms"]["value"] < 2e3 and e2e["output_tok_s"]["value"] > 0
    per = run.cell_metrics(manifest, CELL, True)
    assert {m["name"] for m in per} == {"tail.ttft_p95_ms", "tail.tpot_p95_ms", "mfu",
                                        "device_idle_share.serve"}
    # a profiled slice (as the card's run keeps it): the whole window, half busy
    record["slice"] = {"t0": record["t0"], "t1": record["t1"], "busy_s": 1.0, "window_s": 2.0,
                       "c0": record["c0"], "c1": record["c1"], "kernels": {}}
    got = run.read_metrics(per, record)
    assert set(got) == {m["name"] for m in per}
    assert got["device_idle_share.serve"]["value"] == 50.0 and got["mfu"]["value"] > 0
    checks = _driver(cell).check(record, ctx)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_a_token_altered_is_not_correct(monkeypatch):
    from visualcla_tpu_torch.engine import generate

    orig = generate.sample_step

    def altered(logits, *a, **k):
        tok, mu = orig(logits, *a, **k)
        return (tok + 1) % logits.shape[-1], mu

    monkeypatch.setattr(generate, "sample_step", altered)
    res = run.run_cell(CELL, 2 ** 31 + 9, 2.0, False, device=torch.device("cpu"),
                       cfg=tiny_config(), cell=_cell())
    assert not res["correct"], res["checks"]
