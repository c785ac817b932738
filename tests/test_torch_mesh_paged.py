"""The port's paged pool over a mesh, on the CPU in four spawned gloo ranks
(``tests/torch_mesh_ranks.py``): the JAX package's
``test_paged_tp_b8_token_identity`` set-up (an int8 pool, B = 8, even rows
admitted one-shot and odd rows chunked, 8 steps) on (data=2, model=2),
token for token against the JAX ``PagedServingEngine`` on
``Mesh(devices[:4].reshape(2, 2))`` and the port's unmeshed pool; and the
speculative pool (kernel B5 on the rank's kv heads) against the port's
unmeshed speculative pool (the JAX package refuses speculation over a
mesh).

Tolerance: none; token for token (fp32)."""
import os

import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import run_pool, spawn


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tests.test_torch_host import port_config
    from visualcla_tpu.checkpoint.serialize import flatten_tree
    from visualcla_tpu.core.config import tiny_visualcla_config
    from visualcla_tpu.engine.paged import PagedServingEngine as JPaged
    from visualcla_tpu.models import visualcla as j_vis
    from visualcla_tpu.parallel import sharding as j_shd
    from visualcla_tpu_torch.checkpoint.from_jax import build_model
    from visualcla_tpu_torch.engine.paged import PagedServingEngine as TPaged

    jcfg = tiny_visualcla_config(vocab_size=96, hidden_size=16)
    params = j_vis.init_params(jax.random.PRNGKey(21), jcfg, jnp.float32)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(4, 90, size=(int(n),)).astype(np.int64)
               for n in rng.integers(6, 40, size=8)]
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    cfg = port_config(jcfg)
    tree = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    p = {"cfg": cfg, "tree": tree, "prompts": prompts}

    class JaxPool(JPaged):  # the JAX pool, run by the same run_pool
        def __init__(self, model, cfg_, **kw):
            kw.pop("spec_k")
            super().__init__(j_shd.shard_params(params, mesh), jcfg, dtype=jnp.float32,
                             **{**kw, "mesh": mesh})

    want = run_pool(JaxPool, None, p, mesh)

    def port(spec_k):
        model = build_model(tree, cfg, device="cpu", dtype=torch.float32)
        return run_pool(TPaged, model, p, None, spec_k=spec_k)

    ranks = spawn("paged", 4, os.path.join(str(tmp_path_factory.mktemp("mesh_paged")),
                                           "ranks"), p)
    return {"jax": want, "port": port(0), "port_spec": port(3), "ranks": ranks}


def test_paged_tp_b8_int8_matches_jax_mesh(setup):
    for r in setup["ranks"]:
        assert r["pool"] == [[int(t) for t in row] for row in setup["jax"]]


def test_paged_tp_b8_int8_matches_unmeshed_port(setup):
    for r in setup["ranks"]:
        assert r["pool"] == setup["port"]


def test_speculative_pool_over_mesh_matches_unmeshed(setup):
    for r in setup["ranks"]:
        assert r["spec"] == setup["port_spec"]
