"""The port's pipeline parallelism (``parallel/pipeline.py``) against the JAX
package's, on the CPU: the JAX file's cases (tests/test_pipeline_parallel.py)
in one spawn of four gloo ranks (``tests/torch_mesh_ranks.py``), each case
on a (rep, pipe, data) or (pipe, model) mesh over the four ranks.  The
parent computes JAX's ``pipeline_forward`` on ``make_pipe_mesh`` /
``make_pipe_tp_mesh`` over conftest's virtual devices, and the port's
unmeshed ``Llama.forward``.

Tolerances: against JAX in fp32, hidden states and caches atol = rtol = 1e-5
(the int8 cache bitwise); against the port's unmeshed forward in fp64,
1e-12 (the schedule only reorders independent rows); gradients and the
composite train step in fp32 against JAX's within 1e-5 (loss and grad_norm
relative, parameters absolute); over (pipe 2, data 2) in fp64 against the
port's unmeshed step, loss and grad_norm rtol 1e-7 and parameters atol 1e-8
(``DP_RTOL`` says why not 1e-12)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_host import port_config
from tests.torch_mesh_ranks import spawn
from visualcla_tpu_torch.checkpoint.from_jax import build_model, params_to_jax
from visualcla_tpu_torch.models import llama as t_llama
from visualcla_tpu_torch.parallel import pipeline as t_pp

ATOL = 1e-5
EXACT = 1e-12
# an fp64 step over two data ranks: the RMSNorm statistics and the rope
# tables stay fp32 in an fp64 model (the JAX package's numerics), so the
# gradients the data ranks sum add fp32 roundings in another order
DP_RTOL, DP_ATOL = 1e-7, 1e-8
CASES = [(2, 1, 1), (4, 1, 1), (2, 1, 2), (2, 2, 2)]
B, S, SMAX = 4, 8, 16


def jax_config():
    from visualcla_tpu.core.config import tiny_visualcla_config

    cfg = tiny_visualcla_config(vocab_size=64)
    return dataclasses.replace(cfg, text_config=dataclasses.replace(
        cfg.text_config, num_hidden_layers=4))


def _flat(tree):
    from visualcla_tpu.checkpoint.serialize import flatten_tree

    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _assemble(ranks, key, L):
    """The global cache of a case from the ranks' local ones (rows over
    ``data``, layers over ``pipe``, heads over ``model``)."""
    out = {}
    for r in ranks:
        _, cache, co = r[key]
        for name, t in cache.items():
            t = t.numpy()
            Lp = t.shape[0]
            nd = co.get("data")
            glob = out.setdefault(name, {})
            glob[(co["pipe"], nd if nd is not None else 0,
                  co.get("model", 0) if co.get("kv_local") else 0)] = t
    full = {}
    for name, parts in out.items():
        P = 1 + max(k[0] for k in parts)
        nd = 1 + max(k[1] for k in parts)
        nm = 1 + max(k[2] for k in parts)
        rows = [np.concatenate([np.concatenate([parts[(s, d, h)] for h in range(nm)], axis=2)
                                for d in range(nd)], axis=1) for s in range(P)]
        full[name] = np.concatenate(rows, axis=0)
        assert full[name].shape[0] == L
    return full


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from visualcla_tpu.models import llama as j_llama
    from visualcla_tpu.models import visualcla as j_vis
    from visualcla_tpu.parallel import pipeline as j_pp
    from visualcla_tpu.train import trainer as j_trainer

    tmp = str(tmp_path_factory.mktemp("pipe"))
    jcfg = jax_config()
    tcfg = jcfg.text_config
    params = j_vis.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    flat = _flat(params)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 60, (B, S)).astype(np.int64)
    decode = [rng.integers(3, 60, (B, 1)).astype(np.int64) for _ in range(3)]
    embeds = j_llama.embed(params["text"], jnp.asarray(ids, jnp.int32))
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    valid = jnp.concatenate([jnp.ones((B, S), bool), jnp.zeros((B, SMAX - S), bool)], axis=-1)
    want = {}
    for P, nd, M in CASES:
        cache = j_llama.init_kv_cache(tcfg, B, SMAX, jnp.float32)
        h, c = j_pp.pipeline_forward(params["text"], tcfg, embeds, positions, cache, valid,
                                     jnp.int32(0), j_pp.make_pipe_mesh(P, nd), n_micro=M)
        want[("prefill", P, nd, M)] = (np.asarray(h), {k: np.asarray(v) for k, v in c.items()})
    mesh2 = j_pp.make_pipe_mesh(2, 1)
    # per-row slots, the int8 cache, PP x TP
    slot = jnp.asarray([3, 7], jnp.int32)
    h, c = j_pp.pipeline_forward(params["text"], tcfg, embeds[:2, :1], slot[:, None],
                                 j_llama.init_kv_cache(tcfg, 2, SMAX, jnp.float32),
                                 jnp.arange(SMAX)[None, :] <= slot[:, None], slot, mesh2)
    want["per_row"] = (np.asarray(h), {k: np.asarray(v) for k, v in c.items()})
    h, c = j_pp.pipeline_forward(params["text"], tcfg, embeds, positions,
                                 j_llama.init_kv_cache(tcfg, B, SMAX, jnp.float32,
                                                       kv_quant="int8"),
                                 valid, jnp.int32(0), mesh2)
    want["int8"] = (np.asarray(h), {k: np.asarray(v) for k, v in c.items()})
    tpm = j_pp.make_pipe_tp_mesh(2, 2, devices=jax.devices()[:4])
    h, c = j_pp.pipeline_forward(j_pp.shard_text_params(params["text"], tpm, tcfg), tcfg, embeds,
                                 positions, j_llama.init_kv_cache(tcfg, B, SMAX, jnp.float32),
                                 valid, jnp.int32(0), tpm)
    want["pp_tp"] = (np.asarray(h), {k: np.asarray(v) for k, v in c.items()})
    # the composite train step, 2 steps, through JAX's pipeline
    size = jcfg.vision_config.image_size
    n_img = jcfg.num_image_tokens
    Sb = 24
    batch = {"input_ids": rng.integers(3, 60, (B, Sb)).astype(np.int64),
             "attention_mask": np.ones((B, Sb), np.int64),
             "labels": np.concatenate([np.full((B, n_img + 2), -100), rng.integers(
                 3, 60, (B, Sb - n_img - 2))], axis=-1).astype(np.int64),
             "img_start_pos": np.asarray([0, 0, 3, -1]),
             "pixel_values": rng.standard_normal((B, 3, size, size)).astype(np.float32)}
    batch["attention_mask"][3, -4:] = 0
    batch["labels"][3, -4:] = -100
    opt = j_trainer.make_optimizer(learning_rate=1e-3, schedule="const")
    jstep = jax.jit(j_trainer.make_train_step(jcfg, opt, pipeline_mesh=mesh2, n_micro=2))
    state = j_trainer.init_train_state(params, opt)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics = []
    for _ in range(2):
        state, m = jstep(state, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    want["step"] = (metrics, _flat(state.params))
    cfg = port_config(jcfg)
    flat64 = {k: v.astype(np.float64) for k, v in flat.items()}
    payload = {"cfg": cfg, "flat": {"f32": flat, "f64": flat64},
               "flat_vis": {"f32": flat, "f64": flat64}, "ids": ids, "decode": decode,
               "Smax": SMAX, "cases": CASES, "batch": batch}
    ranks = spawn("pipeline", 4, os.path.join(tmp, "ranks"), payload)
    return {"want": want, "ranks": ranks, "cfg": cfg, "flat": flat, "flat64": flat64,
            "ids": ids, "decode": decode, "batch": batch, "jcfg": jcfg}


def _plain(setup, dtype=torch.float64):
    """The port's unmeshed model in ``dtype`` and its prefill (hidden, cache)."""
    cfg = setup["cfg"]
    model = build_model(setup["flat64"] if dtype == torch.float64 else setup["flat"], cfg,
                        device="cpu", dtype=dtype)
    ids = torch.from_numpy(setup["ids"])
    pos = torch.arange(S)[None].expand(B, S)
    valid = torch.zeros(B, SMAX, dtype=torch.bool)
    valid[:, :S] = True
    cache = t_llama.init_kv_cache(cfg.text_config, B, SMAX, dtype)
    with torch.no_grad():
        h, cache = model.text(model.text.embed(ids), pos, cache, valid, 0)
    return model, h.numpy(), {k: v.numpy() for k, v in cache.items()}


def test_ranks_load_no_jax(setup):
    assert not any(r["jax_loaded"] for r in setup["ranks"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "P%d-data%d-M%d" % c)
def test_prefill_matches_jax_and_unmeshed(setup, case):
    P, nd, M = case
    L = setup["cfg"].text_config.num_hidden_layers
    h_want, c_want = setup["want"][("prefill",) + case]
    _, h64, c64 = _plain(setup)
    for r in setup["ranks"]:
        np.testing.assert_allclose(r[("prefill",) + case + ("f32",)][0], h_want,
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(r[("prefill",) + case + ("f64",)][0], h64,
                                   atol=EXACT, rtol=EXACT)
    got = _assemble(setup["ranks"], ("prefill",) + case + ("f32",), L)
    for k in c_want:
        np.testing.assert_allclose(got[k], c_want[k], atol=ATOL, rtol=ATOL, err_msg=k)
    got = _assemble(setup["ranks"], ("prefill",) + case + ("f64",), L)
    for k in c64:
        np.testing.assert_allclose(got[k], c64[k], atol=EXACT, rtol=EXACT, err_msg=k)


def test_decode_steps_match_unmeshed(setup):
    """Prefill, then 3 one-token steps with the cache handed between calls,
    against the unmeshed forward run step by step (fp32: the same ops on the
    same rows)."""
    cfg = setup["cfg"]
    model, _, _ = _plain(setup, torch.float32)
    text = model.text
    ids = torch.from_numpy(setup["ids"])
    valid = torch.zeros(B, SMAX, dtype=torch.bool)
    valid[:, :S] = True
    cache = t_llama.init_kv_cache(cfg.text_config, B, SMAX, torch.float32)
    with torch.no_grad():
        text(text.embed(ids), torch.arange(S)[None].expand(B, S), cache, valid, 0)
        for step, tok in enumerate(setup["decode"]):
            valid[:, S + step] = True
            h, cache = text(text.embed(torch.from_numpy(tok)), torch.full((B, 1), S + step),
                            cache, valid, S + step)
            for r in setup["ranks"]:
                np.testing.assert_allclose(r["decode"][step], h.numpy(), atol=EXACT, rtol=EXACT)


def test_per_row_slots(setup):
    L = setup["cfg"].text_config.num_hidden_layers
    h_want, c_want = setup["want"]["per_row"]
    for r in setup["ranks"]:
        np.testing.assert_allclose(r[("per_row", "f32")][0], h_want, atol=ATOL, rtol=ATOL)
    got = _assemble(setup["ranks"], ("per_row", "f32"), L)
    for k in c_want:
        np.testing.assert_allclose(got[k], c_want[k], atol=ATOL, rtol=ATOL, err_msg=k)


def test_int8_cache_bitwise(setup):
    L = setup["cfg"].text_config.num_hidden_layers
    h_want, c_want = setup["want"]["int8"]
    for r in setup["ranks"]:
        np.testing.assert_allclose(r["int8"][0], h_want, atol=ATOL, rtol=ATOL)
    got = _assemble(setup["ranks"], "int8", L)
    np.testing.assert_array_equal(got["k"], c_want["k"])
    np.testing.assert_array_equal(got["v"], c_want["v"])
    np.testing.assert_allclose(got["k_scale"], c_want["k_scale"], rtol=ATOL)


def test_pp_tp_matches_jax_and_unmeshed(setup):
    L = setup["cfg"].text_config.num_hidden_layers
    h_want, c_want = setup["want"]["pp_tp"]
    _, h64, c64 = _plain(setup)
    for r in setup["ranks"]:
        np.testing.assert_allclose(r[("pp_tp", "f32")][0], h_want, atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(r[("pp_tp", "f64")][0], h64, atol=EXACT, rtol=EXACT)
    got = _assemble(setup["ranks"], ("pp_tp", "f32"), L)
    for k in c_want:
        np.testing.assert_allclose(got[k], c_want[k], atol=ATOL, rtol=ATOL, err_msg=k)


def test_stage_param_specs_and_held_layers(setup):
    from visualcla_tpu.parallel import pipeline as j_pp

    tcfg = setup["jcfg"].text_config
    for tp in (False, True):
        j = j_pp.stage_param_specs(2, tcfg, tp=tp)
        t = t_pp.stage_param_specs(2, setup["cfg"].text_config, tp=tp)
        assert {k: tuple(v) for k, v in j.items() if k != "layers"} == \
            {k: v for k, v in t.items() if k != "layers"}
        assert {k: tuple(v) for k, v in j["layers"].items()} == t["layers"]
    for fn in (j_pp.stage_param_specs, t_pp.stage_param_specs):
        with pytest.raises(ValueError):
            fn(3, tcfg)
    per_layer = sum(p.numel() for p in build_model(
        setup["flat"], setup["cfg"], device="cpu", dtype=torch.float32).text.layers[0].parameters())
    for r in setup["ranks"]:
        n, layers = r["held"]
        assert n == 2 * per_layer and len(layers) == 2  # L/P = 2 of the 4 layers


def test_bad_microbatch_count_raises(setup):
    for r in setup["ranks"]:
        assert "divisible by n_micro*data=3" in r["n_micro_3"]


def test_pipeline_grads_equal_plain_on_every_rank(setup):
    """Gradients of sum(h^2) through the schedule (M = 2): each stage's
    layers' and, on every stage, the embedding table's and the final norm's,
    against the unmeshed forward's (fp64)."""
    model, _, _ = _plain(setup)
    for p in model.parameters():
        p.requires_grad_(True)
    ids = torch.from_numpy(setup["ids"])
    valid = torch.ones(B, S, dtype=torch.bool)
    h, _ = model.text(model.text.embed(ids), torch.arange(S)[None].expand(B, S), None, valid, 0)
    (h ** 2).sum().backward()
    want = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    stages = set()
    for r in setup["ranks"]:
        got = r["grads"]
        for n in ("text.embed_tokens", "text.final_norm.weight"):
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), atol=EXACT, rtol=1e-10,
                                       err_msg=n)
        layers = {int(n.split(".")[2]) for n in got if n.startswith("text.layers.")}
        stages.add(r["grad_coords"]["pipe"])
        assert layers == {2 * r["grad_coords"]["pipe"], 2 * r["grad_coords"]["pipe"] + 1}
        for n, g in got.items():
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=EXACT, rtol=1e-10,
                                       err_msg=n)
    assert stages == {0, 1}


def test_composite_train_step(setup):
    """``make_train_step(pipeline_mesh=, n_micro=2)``: (pipe 2, data 1) in
    fp32 against JAX's pipelined step, (pipe 2, data 2) in fp64 against the
    port's unmeshed step, 2 steps each."""
    from visualcla_tpu_torch.train import trainer

    metrics_j, params_j = setup["want"]["step"]
    model = build_model(setup["flat64"], setup["cfg"], device="cpu", dtype=torch.float64)
    opt = trainer.make_optimizer(learning_rate=1e-3, schedule="const")
    step = trainer.make_train_step(model, setup["cfg"], opt)
    state = trainer.init_train_state(model, opt)
    metrics_p = []
    for _ in range(2):
        state, m = step(state, setup["batch"])
        metrics_p.append((float(m["loss"]), float(m["grad_norm"])))
    params_p = {k: v.numpy() for k, v in params_to_jax(model).items()}
    for r in setup["ranks"]:
        metrics, params = r[("step", 2, 1)]
        np.testing.assert_allclose(metrics, metrics_j, rtol=ATOL)
        for k in params_j:
            np.testing.assert_allclose(params[k], params_j[k], atol=ATOL, err_msg=k)
        metrics, params = r[("step", 2, 2)]
        np.testing.assert_allclose(metrics, metrics_p, rtol=DP_RTOL)
        for k in params_p:
            np.testing.assert_allclose(params[k], params_p[k], atol=DP_ATOL, err_msg=k)
