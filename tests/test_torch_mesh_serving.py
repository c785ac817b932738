"""Serving a meshed model, on the CPU in four spawned gloo ranks
(``tests/torch_mesh_ranks.py``), token for token in fp32:

- the contiguous ``ServingEngine(mesh=)`` by direct calls on (data=2,
  model=2) and (1, 4), against the JAX ``ServingEngine`` over
  ``shard_params(params, mesh)`` on ``Mesh(devices[:4])`` of the same shape
  (GSPMD runs it on the virtual devices) and the port's unmeshed pool;
- ``PoolWorker`` over a model loaded with ``mesh=`` on (2, 2), the
  contiguous pool and the paged one (speculating, ``spec_k=3``, with a
  prompt long enough for the chunked admission): 6 greedy requests of mixed
  length (one with an image) through rank 0's ``Scheduler``
  (``generate_sync``), ranks 1-3 in ``follow``; each request's ids against
  the JAX ``Scheduler`` over the JAX contiguous pool, unmeshed (fp32:
  neither batching nor the pool nor speculation changes greedy ids);
- ``PoolWorker`` over an unmeshed model in the same four ranks: each rank
  serves its own request through its own ``Scheduler`` (no rank leads), ids
  against the JAX Scheduler's;
- rank 0's loop crashing (its snapshot raises): every follower raises with
  its message; an idle spell longer than the deadline (heartbeats only),
  then ``Scheduler.stop()``: every follower returns; the loop ending
  without a word: every follower raises ``TimeoutError`` at its deadline.

Tolerance: none; token for token."""
import os

import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import run_contiguous, spawn

MAX_SEQ = 256
DEADLINE_S = 5.0
PREFILL_CHUNK = 64
GREEDY = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
              no_repeat_ngram_size=0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import visualcla_tpu as vj
    from tests.test_api import make_native_ckpt
    from tests.test_torch_host import port_config
    from visualcla_tpu.checkpoint.serialize import flatten_tree
    from visualcla_tpu.engine import server as j_server
    from visualcla_tpu.parallel import sharding as j_shd
    from visualcla_tpu_torch.checkpoint.from_jax import build_model
    from visualcla_tpu_torch.engine.server import ServingEngine as TServing

    tmp = str(tmp_path_factory.mktemp("mesh_serving"))
    ckpt, jcfg = make_native_ckpt(tmp)
    jm, tok, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=MAX_SEQ)
    params = jm.params
    rng = np.random.default_rng(31)
    prompts = [rng.integers(4, 20, size=(int(n),)).astype(np.int64) for n in (9, 14, 30, 40)]
    pixels = rng.normal(size=(1, 3, 28, 28)).astype(np.float32)
    lengths = (10, 12, 20, 8, 100, 15)  # the fifth is longer than PREFILL_CHUNK
    new = (24, 8, 10, 6, 8, 9)
    requests = []
    for i, (n, m) in enumerate(zip(lengths, new)):
        ids = rng.integers(4, 20, size=(n,)).astype(np.int64)
        requests.append((ids, pixels, 2, m) if i == 1 else (ids, None, None, m))
    p = {"ckpt": ckpt, "max_seq": MAX_SEQ, "cfg": port_config(jcfg), "eos": tok.eos_token_id,
         "tree": {k: np.asarray(v) for k, v in flatten_tree(params).items()},
         "prompts": prompts, "pixels": pixels, "requests": requests, "greedy": GREEDY,
         "prefill_chunk": PREFILL_CHUNK, "deadline_s": DEADLINE_S}

    def jax_pool(shape):
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), ("data", "model"))

        class JaxPool(j_server.ServingEngine):  # the JAX pool, run by run_contiguous
            def __init__(self, model, cfg_, **kw):
                kw.pop("mesh")
                super().__init__(j_shd.shard_params(params, mesh), jcfg, dtype=jnp.float32,
                                 **kw)

        return run_contiguous(JaxPool, None, p, mesh)

    want = {shape: jax_pool(shape) for shape in ((2, 2), (1, 4))}
    port = run_contiguous(TServing, build_model(p["tree"], p["cfg"], device="cpu",
                                                dtype=torch.float32), p, None)
    # the JAX Scheduler over its unmeshed contiguous pool, as the JAX PoolWorker builds it
    j_eng = j_server.ServingEngine(params, jm.config, eos_token_id=tok.eos_token_id,
                                   pad_token_id=tok.pad_token_id, pool_size=4,
                                   max_seq_len=MAX_SEQ, dtype=jnp.float32)
    sched = j_server.Scheduler(j_eng)
    try:
        jax_served = [[int(t) for t in j_server.generate_sync(
            sched, ids, px, img, m, sampling_overrides=GREEDY, timeout=120)]
            for ids, px, img, m in requests]
    finally:
        sched.stop()
    ranks = spawn("serving", 4, os.path.join(tmp, "ranks"), p)
    return {"jax": want, "port": port, "jax_served": jax_served, "ranks": ranks}


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_contiguous_pool_over_mesh_matches_jax_mesh_and_unmeshed_port(setup, shape):
    want = setup["jax"][shape]
    assert want == setup["port"]
    for r in setup["ranks"]:
        assert r[f"contiguous{shape}"] == want


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_pool_worker_over_mesh_matches_jax_scheduler(setup, pool):
    lead = setup["ranks"][0]
    assert lead[pool] == setup["jax_served"]
    assert len(setup["jax_served"][0]) == 24  # the first request lives through the others
    stats = lead[pool + "_stats"]
    assert stats["prefills"] + stats["chunked_admissions"] == 6
    for r in setup["ranks"][1:]:
        followed = r[pool + "_followed"]
        assert followed["failed"] == 0
        assert followed["messages"] == lead[pool + "_messages"]
        assert not r["jax_loaded"]
    if pool == "paged":  # the long prompt took the chunked admission; rows speculated
        assert stats["chunked_admissions"] == 1 and stats["prefill_chunks"] >= 2
        assert stats["spec_dispatches"] > 0
        assert setup["ranks"][1]["paged_followed"]["pp_step"] == stats["prefill_chunks"] + 1
    else:
        assert stats["chunked_admissions"] == 0  # the contiguous pool has no begin_prefill


def test_unmeshed_pool_worker_serves_on_every_rank(setup):
    for rank, r in enumerate(setup["ranks"]):
        assert r["own"] == setup["jax_served"][rank]
        assert "meshed model" in r["own_follow"]  # no rank follows another


def test_crash_on_rank0_releases_every_follower(setup):
    assert "scheduler loop died: forced failure" in setup["ranks"][0]["crash"]
    for r in setup["ranks"][1:]:
        kind, seconds, msg = r["crash"]
        assert kind == "RuntimeError" and "forced failure" in msg
        assert seconds < DEADLINE_S * 20  # the crash message, not a deadline


def test_stop_after_idle_releases_every_follower(setup):
    lead = setup["ranks"][0]
    assert lead["stop_ids"] == setup["jax_served"][3]
    for r in setup["ranks"][1:]:
        kind, seconds, _ = r["stop"]
        assert kind == "returned"
        assert seconds > 1.5 * DEADLINE_S  # it waited through the idle spell on heartbeats


def test_silent_leader_times_out_at_the_deadline(setup):
    for r in setup["ranks"][1:]:
        kind, seconds, msg = r["silent"]
        assert kind == "TimeoutError", (kind, msg)
        assert DEADLINE_S * 0.9 <= seconds < DEADLINE_S + 10
