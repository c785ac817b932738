"""Training checkpoint and resume (port of visualcla_tpu/train/checkpointing.py).

A train state (``trainer.TrainState``: the trainable parameters, the
optimizer's moments and count, the step) is written with ``torch.save`` to
``<path>/train_state.pt``, every tensor moved to the host; a restore copies
it into a live state's tensors (the model's own parameters among them), so a
resumed run continues bit for bit.  The JAX package writes orbax directories
instead: neither package reads the other's train states.

Over a mesh the file is the same single-device file: every rank takes part
in assembling each whole tensor from its shards and owners
(``parallel.sharding.gather_whole``), rank 0 writes it, and a restore gives
each rank its piece (``take_local``).
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

from ..parallel.distributed import rank

_FILE = "train_state.pt"


def _host(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def _placed(params) -> bool:
    from ..parallel.sharding import is_placed

    return any(is_placed(p) for p in params.values())


def _whole(state) -> dict:
    """The state's tensors whole, on the host on rank 0 (a collective)."""
    from ..parallel.sharding import gather_whole

    keep = rank() == 0

    def tree(ts: dict) -> dict:
        out = {}
        for n, t in ts.items():
            w = gather_whole(state.params[n], t)
            out[n] = w.detach().cpu().clone() if keep else None
        return out

    opt = dict(state.opt_state)
    opt["mu"], opt["nu"] = tree(opt["mu"]), tree(opt["nu"])
    return {"params": tree(state.params), "opt_state": _host(opt), "step": int(state.step)}


def save_train_state(path: str, state) -> None:
    """Write ``state`` (params, opt_state, step) under the directory ``path``
    (over a mesh: the whole tensors, by rank 0; every rank calls it)."""
    if not _placed(state.params):
        os.makedirs(path, exist_ok=True)
        torch.save({"params": _host(state.params), "opt_state": _host(state.opt_state),
                    "step": int(state.step)}, os.path.join(path, _FILE))
        return
    import torch.distributed as dist

    whole = _whole(state)
    if rank() == 0:
        os.makedirs(path, exist_ok=True)
        torch.save(whole, os.path.join(path, _FILE))
    dist.barrier()


@torch.no_grad()
def _copy_into(dst: Any, src: Any, where: str) -> Any:
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"{where}: saved {src.dtype} {tuple(src.shape)}, "
                             f"live {dst.dtype} {tuple(dst.shape)}")
        dst.copy_(src)
        return dst
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise ValueError(f"{where}: saved keys differ from the live state's "
                             f"({sorted(set(dst) ^ set(src))[:5]})")
        for k in dst:
            dst[k] = _copy_into(dst[k], src[k], f"{where}/{k}")
        return dst
    return src


def restore_train_state(path: str, abstract_state):
    """Copy the state saved under ``path`` into ``abstract_state`` (a live
    state of the same structure, e.g. a fresh ``init_train_state``) in place,
    and return it (over a mesh, each rank its pieces); raises if a key, shape
    or dtype differs."""
    from .trainer import TrainState

    saved = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    params = abstract_state.params
    if _placed(params):  # each rank its pieces of the whole tensors
        from ..parallel.sharding import take_local

        def local(ts: dict) -> dict:
            return {n: take_local(params[n], t) if n in params else t for n, t in ts.items()}

        saved["params"] = local(saved["params"])
        for k in ("mu", "nu"):
            saved["opt_state"][k] = local(saved["opt_state"][k])
    return TrainState(params=_copy_into(abstract_state.params, saved["params"], "params"),
                      opt_state=_copy_into(abstract_state.opt_state, saved["opt_state"],
                                           "opt_state"),
                      step=saved["step"])


def latest_step_dir(root: str) -> Optional[str]:
    """Find the newest ``step_N`` checkpoint under ``root`` (or None)."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and name[5:].isdigit():
            steps.append(int(name[5:]))
    if not steps:
        return None
    return os.path.join(root, f"step_{max(steps)}")
