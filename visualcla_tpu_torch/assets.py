"""Locator for the vendored golden eval assets (the port's own copy of
visualcla_tpu/assets.py).

The reference's only reproducible behavioral artifacts are its bundled
question sets + frozen predictions (reference ``examples/*.json``).  The repo
vendors them under ``examples/`` at its root, so ``apps/evaluate.py`` runs
on a machine without the reference checkout.
"""
from __future__ import annotations

import os


def examples_dir() -> str:
    """Return the vendored ``examples/`` directory.

    Resolution order: ``$VISUALCLA_EXAMPLES_DIR``, the repo-root ``examples/``
    next to the package (source checkout), then a package-local ``examples/``
    (wheel installs that chose to ship the data inside the package).
    """
    env = os.environ.get("VISUALCLA_EXAMPLES_DIR")
    if env:
        return env
    pkg = os.path.dirname(os.path.abspath(__file__))
    for cand in (os.path.join(os.path.dirname(pkg), "examples"),
                 os.path.join(pkg, "examples")):
        if os.path.isdir(cand):
            return cand
    raise FileNotFoundError(
        "vendored examples/ directory not found; set VISUALCLA_EXAMPLES_DIR")


def golden_path(name: str) -> str:
    """Absolute path of one vendored asset, e.g. 'llava_test_zh_questions.json'.

    ``name`` may also be a shorthand: 'llava' / 'owl' resolve to the question
    sets; 'llava_predictions' / 'owl_predictions' to the frozen outputs.
    """
    short = {
        "llava": "llava_test_zh_questions.json",
        "owl": "owl_test_zh_questions.json",
        "llava_predictions": "llava_visualcla_7b_predictions.json",
        "owl_predictions": "owl_visualcla_7b_predictions.json",
    }
    fname = short.get(name, name)
    path = os.path.join(examples_dir(), fname)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return path
