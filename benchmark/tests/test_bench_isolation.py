"""What the runner loads, in a fresh interpreter: nothing whose top-level
name is JAX's or the JAX package's; and the plain reference loads nothing of
the port."""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=REPO, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": REPO})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_runner_and_all_it_reaches_load_no_jax():
    """``benchmark/run.py``, every driver, metric reader and harness module,
    the reference, and the port's modules that the harness builds the
    served stack from."""
    code = """
import glob, os, importlib
import benchmark.run as run
for sub in ("harness", "reference", "drivers", "tools"):
    for p in sorted(glob.glob(os.path.join("benchmark", sub, "*.py"))):
        importlib.import_module("benchmark.%s.%s" % (sub, os.path.basename(p)[:-3]))
for p in sorted(glob.glob(os.path.join("benchmark", "metrics", "*.py"))):
    run.load_module(p, "m_" + os.path.basename(p)[:-3].replace(".", "_"))
import visualcla_tpu_torch.api, visualcla_tpu_torch.apps.serve
import visualcla_tpu_torch.checkpoint.convert, visualcla_tpu_torch.engine.paged
import visualcla_tpu_torch.models.visualcla, visualcla_tpu_torch.ops.cuda.build
"""
    loaded = _modules(code)
    assert "visualcla_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "visualcla_tpu"}, loaded


def test_the_reference_loads_nothing_of_the_port():
    loaded = _modules("import benchmark.reference.model, benchmark.reference.tokenize, "
                      "benchmark.reference.preprocess, benchmark.reference.sampling")
    assert "torch" in loaded
    assert not loaded & {"visualcla_tpu_torch", "visualcla_tpu", "jax"}, loaded
