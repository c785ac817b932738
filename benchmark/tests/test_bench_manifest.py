"""``BENCHMARK.json`` against the rules it is checked by, and every name in
it resolving to a file of the benchmark; the traffic generator deterministic
for a seed, and the same work for every seed."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import run
from benchmark.harness import traffic

MANIFEST = run.load_json(run.REPO, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_.%/-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_names_and_units():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS + [m["name"] for m in _metrics()]
             + [w["config"] for w in MANIFEST["workloads"]]
             + [w["traffic"] for w in MANIFEST["workloads"]]
             + [k for c in MANIFEST["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (MANIFEST["configs"], MANIFEST["workloads"], _metrics()):
        assert len({g["name"] for g in group}) == len(group)


def test_keys_bounds_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(run.REPO, c["file"]))
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_name_resolves_to_a_file():
    configs = {c["name"] for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        cell = run.load_json(run.BENCH, "workloads", w["traffic"] + ".json")
        assert cell["config"] == w["config"] in configs
        assert os.path.exists(os.path.join(run.BENCH, "drivers", cell["driver"] + ".py"))
        cfg = run.load_config(w["config"])
        assert cfg["name"] == w["config"]
        for m in run.cell_metrics(MANIFEST, w["name"], False) + run.cell_metrics(
                MANIFEST, w["name"], True):
            assert os.path.exists(os.path.join(run.BENCH, "metrics", m["name"] + ".py")), m
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert os.path.exists(os.path.join(run.BENCH, "metrics", m["name"] + ".kernels.json"))


def test_every_cell_reports_what_its_per_layer_metrics_move():
    for cell in CELLS:
        e2e = {m["name"] for m in run.cell_metrics(MANIFEST, cell, False)}
        per = run.cell_metrics(MANIFEST, cell, True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        for m in per:
            assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_is_deterministic_and_the_same_work_for_every_seed(cell):
    """Equal for equal seeds; for another seed the same arrivals and the same
    multiset of requests, in another order and with other contents."""
    spec = run.load_json(run.BENCH, "workloads", cell + ".json")
    V = run.load_config(spec["config"])["vocab_size"]
    a = traffic.schedule(spec, 2 ** 31 + 7, 10, V)
    b = traffic.schedule(spec, 2 ** 31 + 7, 10, V)
    c = traffic.schedule(spec, 99, 10, V)
    assert a == b and a != c
    assert len(a) == len(c) == round(spec["rate_per_s"] * 10)
    for field in ("instruction_tokens", "max_new_tokens", "sampled"):
        assert sorted(getattr(p, field) for p in a) == sorted(getattr(p, field) for p in c)
    assert [p.due for p in a] == [p.due for p in c]  # one arrival path for every seed
    assert all(0 <= p.due < 10 for p in a)
    assert all(len(p.instruction) == p.instruction_tokens for p in a)


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 1
    assert capsys.readouterr().out == ""


def test_command_names_no_file_outside_the_benchmark():
    for word in MANIFEST["command"][1:]:
        assert word.startswith("benchmark/") and ".." not in word
    json.dumps(MANIFEST)
    assert os.path.getsize(os.path.join(run.REPO, "BENCHMARK.json")) < 64 * 1024
