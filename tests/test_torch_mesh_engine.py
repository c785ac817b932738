"""The port's engines over a mesh, on the CPU in four spawned gloo ranks
(``tests/torch_mesh_ranks.py``), token for token in fp32: ``Engine.generate``
greedy on (data=2, model=2) against the JAX Engine on
``Mesh(devices[:4].reshape(2, 2))`` and the port's unmeshed Engine; a
sampled generate split over ``data`` against the unsplit port run (the
noise drawn for the whole batch); the stream; the speculative decoder and
2-beam search through the factory against the JAX factory on the same mesh
and the port unmeshed; and a context-parallel prefill of a 512-token prompt
on (data=1, seq=4) against the JAX Engine on its (data, seq) mesh and the
port unmeshed.  The checkpoint is made in-process (``tests.test_api
.make_native_ckpt``).

Tolerance: none; token for token."""
import os

import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import spawn

MAX_SEQ = 256
NEW = 6
CP_LEN = 512
GREEDY = dict(do_sample=False, temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0,
              no_repeat_ngram_size=0)
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=40, top_p=0.9, repetition_penalty=1.1,
               no_repeat_ngram_size=0, max_new_tokens=NEW)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import visualcla_tpu as vj
    import visualcla_tpu_torch as vt
    from tests.test_api import make_native_ckpt
    from visualcla_tpu.engine import sampling as j_samp
    from visualcla_tpu.engine.generate import Engine as JEngine
    from visualcla_tpu.parallel import sharding as j_shd
    from visualcla_tpu_torch.engine import sampling as t_samp
    from visualcla_tpu_torch.engine.generate import Engine as TEngine

    tmp = str(tmp_path_factory.mktemp("mesh_engine"))
    ckpt, jcfg = make_native_ckpt(tmp)
    rng = np.random.default_rng(5)
    B = 2
    ids = rng.integers(4, 20, (B, 12)).astype(np.int64)
    pixels = rng.normal(size=(B, 3, 28, 28)).astype(np.float32)
    img_pos = np.full((B,), 2, np.int64)
    chat_ids = rng.integers(4, 20, (1, 12)).astype(np.int64)
    long_ids = rng.integers(4, 20, (2, CP_LEN)).astype(np.int64)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    cp_mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "seq"))

    jm, tok, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=MAX_SEQ, mesh=mesh)
    eos = tok.eos_token_id
    jg = j_samp.SamplingConfig.greedy(max_new_tokens=NEW)
    j_eng = JEngine(j_shd.shard_params(jm.params, mesh), jm.config, eos_token_id=eos,
                    pad_token_id=tok.pad_token_id, max_seq_len=MAX_SEQ, dtype=jnp.float32,
                    mesh=mesh)
    jax_ref = {
        "greedy": np.asarray(j_eng.generate(ids, pixels, img_pos, jg)),
        "spec": np.asarray(jm.generate(chat_ids, generation_config=jg, speculative=True,
                                       spec_k=3)),
        "beam": np.asarray(jm.generate(chat_ids, generation_config=j_samp.SamplingConfig(
            **GREEDY, max_new_tokens=NEW, num_beams=2))),
    }
    jp, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=MAX_SEQ)
    j_cp = JEngine(jp.params, jp.config, eos_token_id=eos, pad_token_id=0,
                   max_seq_len=CP_LEN + 64, prompt_buckets=(CP_LEN,), dtype=jnp.float32,
                   mesh=cp_mesh)
    jax_ref["cp"] = np.asarray(j_cp.generate(long_ids, sampling=jg))

    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=MAX_SEQ)
    tg = t_samp.SamplingConfig.greedy(max_new_tokens=NEW)
    te = tm.engine
    port_ref = {
        "greedy": te.generate(ids, pixels, img_pos, tg),
        "sampled": te.generate(ids, pixels, img_pos, t_samp.SamplingConfig(**SAMPLED), seed=3),
        "stream": np.stack(list(te.stream(ids[:1], pixels[:1], img_pos[:1], tg)), axis=1),
        "stream_split": np.stack(list(te.stream(ids, pixels, img_pos,
                                                t_samp.SamplingConfig(**SAMPLED), seed=3,
                                                chunk_size=3)), axis=1),
        "spec": tm.generate(chat_ids, generation_config=tg, speculative=True, spec_k=3),
        "beam": tm.generate(chat_ids, generation_config=t_samp.SamplingConfig(
            **GREEDY, max_new_tokens=NEW, num_beams=2)),
        "cp": TEngine(tm.model, tm.config, eos_token_id=eos, pad_token_id=0,
                      max_seq_len=CP_LEN + 64).generate(long_ids, sampling=tg),
    }
    payload = {"ckpt": ckpt, "max_seq": MAX_SEQ, "new": NEW, "ids": ids, "pixels": pixels,
               "img_pos": img_pos, "chat_ids": chat_ids, "long_ids": long_ids, "eos": eos,
               "cp_max_seq": CP_LEN + 64, "sampled": SAMPLED, "greedy_kw": GREEDY}
    ranks = spawn("engine", 4, os.path.join(tmp, "ranks"), payload)
    return {"jax": jax_ref, "port": port_ref, "ranks": ranks, "cfg": jcfg}


@pytest.mark.parametrize("case", ["greedy", "spec", "beam", "cp"])
def test_meshed_port_matches_jax_mesh(setup, case):
    for r in setup["ranks"]:
        np.testing.assert_array_equal(r[case], setup["jax"][case])


@pytest.mark.parametrize("case", ["greedy", "spec", "beam", "cp", "stream"])
def test_meshed_port_matches_unmeshed_port(setup, case):
    for r in setup["ranks"]:
        np.testing.assert_array_equal(r[case], setup["port"][case])


def test_dp_split_sampled_stream_equals_unsplit(setup):
    """``stream`` over data = 2: each rank streams its row (3 steps a host
    read), every step's tokens gathered: the unsplit stream's, step for
    step, and the same ids as the sampled generate."""
    for r in setup["ranks"]:
        np.testing.assert_array_equal(r["stream_split"], setup["port"]["stream_split"])
    # the stream's ids are the generate's: its first yield no longer aliases
    # the workspace's last token on the CPU
    np.testing.assert_array_equal(setup["port"]["stream_split"], setup["port"]["sampled"])


def test_dp_split_sampled_generate_equals_unsplit(setup):
    """B = 2 over data = 2: each data rank samples its row from the whole
    batch's noise, so the gathered ids are the unsplit run's."""
    for r in setup["ranks"]:
        np.testing.assert_array_equal(r["sampled"], setup["port"]["sampled"])
        assert r["ws_rows"] == [1]  # each data rank's workspace held its one row


def test_dp_x_cp_matches_unmeshed_port(setup):
    """(data=2, seq=2): each data rank prefills its row over a two-rank ring."""
    for r in setup["ranks"]:
        np.testing.assert_array_equal(r["dp_cp"], setup["port"]["cp"])


def test_cp_prefill_rides_the_ring(setup):
    """Each of the 2 layers runs ring attention on the rank's 128 slots of
    the 512-slot bucket, once (the prefill; decode reads the cache)."""
    for r in setup["ranks"]:
        assert r["ring_chunks"] == [CP_LEN // 4] * 2


def test_cache_holds_the_rank_kv_heads(setup):
    heads = setup["cfg"].text_config.num_key_value_heads
    assert [r["kv_heads"] for r in setup["ranks"]] == [heads // 2] * 4


def test_row_window_keys_the_captured_graphs():
    """A data rank's sampled call draws its rows of the whole batch's noise
    (``global_rows``), and a captured start or decode bakes that window in:
    the window is part of both graph keys, so a split call and an unsplit
    call of the same local B on one engine never share a graph, in either
    order.  The split call gives row 1 of the unsplit B = 2 run, the unsplit
    call a fresh engine's; token for token."""
    from visualcla_tpu_torch.core.config import tiny_visualcla_config
    from visualcla_tpu_torch.engine.generate import Engine
    from visualcla_tpu_torch.engine.sampling import SamplingConfig, global_rows
    from visualcla_tpu_torch.models.visualcla import VisualCLAModel, init_random_

    cfg = tiny_visualcla_config(vocab_size=128, hidden_size=64)
    model = init_random_(VisualCLAModel(cfg, device="cpu", dtype=torch.float32),
                         torch.Generator().manual_seed(0), std=0.1)
    ids = np.random.default_rng(2).integers(3, 128, (2, 10))
    s = SamplingConfig(**SAMPLED)

    def engine():
        return Engine(model, cfg, eos_token_id=1, max_seq_len=MAX_SEQ)

    whole = engine().generate(ids, sampling=s, seed=3)
    alone = engine().generate(ids[1:], sampling=s, seed=3)
    for split_first in (True, False):
        eng, keys = engine(), {}
        run = eng.graphs.run

        def record(key, *a, **kw):
            keys.setdefault(kind, set()).add(key)
            return run(key, *a, **kw)

        eng.graphs.run = record
        for kind in (("split", "unsplit") if split_first else ("unsplit", "split")):
            if kind == "split":
                with global_rows(2, 1):
                    split = eng.generate(ids[1:], sampling=s, seed=3)
            else:
                unsplit = eng.generate(ids[1:], sampling=s, seed=3)
        assert keys["split"].isdisjoint(keys["unsplit"])
        np.testing.assert_array_equal(unsplit, alone)
        np.testing.assert_array_equal(split, whole[1:, :split.shape[1]])
        assert (whole[1:, split.shape[1]:] == 0).all()  # pad past the row's EOS
