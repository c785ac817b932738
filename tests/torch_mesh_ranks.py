"""Rank side of the port's multi-rank CPU tests (``tests/test_torch_mesh*.py``).

``spawn`` starts ``world`` gloo ranks (a ``file://`` store under the test's
temporary directory, so no port is bound and xdist workers never meet;
``timeout=60 s`` on the group; one thread a rank), runs one suite of checks
in every rank and returns each rank's results.  A rank that raises fails the
test with its traceback; ranks still running at the deadline are killed and
the test fails.  This module imports torch, numpy and the port only: the
spawned ranks never load jax.
"""
from __future__ import annotations

import os
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import torch

JOIN_S = 240  # a spawn's deadline


def spawn(suite: str, world: int, workdir: str, payload: dict) -> list:
    """Run ``SUITES[suite](payload)`` in ``world`` gloo ranks -> each rank's
    result dict, in rank order."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, workdir, suite, payload), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"suite {suite!r}: ranks still running after {JOIN_S} s")
    except mp.ProcessRaisedException:
        pass  # the ranks' tracebacks are in their .err files, read below
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    errors = [open(os.path.join(workdir, f)).read() for f in sorted(os.listdir(workdir))
              if f.endswith(".err")]
    if errors:
        raise AssertionError("\n".join(errors))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, world: int, workdir: str, suite: str, payload: dict) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        out = SUITES[suite](payload)
        out["jax_loaded"] = any(m == "jax" or m.startswith(("jax.", "visualcla_tpu."))
                                for m in sys.modules)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def mesh(shape=(2, 2), names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=names)


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

def _forward_logits(model, cfg, inp: dict, dp=None) -> np.ndarray:
    """prefill_forward logits of ``inp``'s batch; with a ``data`` axis ``dp``
    each data rank runs its rows and the logits are gathered."""
    from visualcla_tpu_torch.models import llama, visualcla
    from visualcla_tpu_torch.parallel import tp

    ids, mask = inp["ids"], inp["mask"]
    pos, pix = inp["img_pos"], inp["pixels"]
    B, S = ids.shape
    if dp is not None:
        b = B // dp.size
        rows = slice(dp.rank * b, (dp.rank + 1) * b)
        ids, mask, pos, pix = ids[rows], mask[rows], pos[rows], pix[rows]
    cache = llama.init_kv_cache(cfg.text_config, ids.shape[0], S, torch.float32,
                                kv_heads=model.text.kv_heads)
    with torch.no_grad():
        logits, _ = visualcla.prefill_forward(
            model, cfg, torch.from_numpy(ids), torch.from_numpy(mask), pos,
            torch.from_numpy(pix), cache)
    if dp is not None:
        logits = tp.gather_rows_from_data(logits, dp.group, dp.size)
    return logits.numpy()


def forward_suite(p: dict) -> dict:
    """TP x DP forward logits per tier, ring attention on (1, 4), the sharded
    load, and what each rank holds."""
    from visualcla_tpu_torch.checkpoint import serialize
    from visualcla_tpu_torch.checkpoint.from_jax import build_model
    from visualcla_tpu_torch.parallel import ring, sharding, tp

    from visualcla_tpu_torch.parallel import distributed

    distributed.initialize("cpu")  # the group is up: a no-op
    pod = distributed.pod_mesh(n_data=2)
    out = {"pod": (pod.mesh_dim_names, tuple(pod.mesh.shape)),
           "default": tuple(sharding.make_mesh().mesh.shape)}
    m = mesh()
    dp = tp.axis(m, "data")
    for tier, flat in p["trees"].items():
        model = build_model(flat, p["cfg"], device="cpu", dtype=torch.float32)
        sharding.shard_params(model, m)
        out[f"logits_{tier}"] = _forward_logits(model, p["cfg"], p["inp"], dp)
        out[f"shapes_{tier}"] = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        out[f"heads_{tier}"] = [layer.heads for layer in model.text.layers]
    # the sharded load reads the rank's bytes only, and holds what shard_params holds
    serialize.READ_BYTES[0] = 0
    loaded, _ = serialize.load_checkpoint(p["ckpt"], device="cpu", dtype=torch.float32, mesh=m)
    out["read_bytes"] = serialize.READ_BYTES[0]
    out["local_bytes"] = sum(t.numel() * t.element_size()
                             for k, t in loaded.state_dict().items()
                             if k != "resampler.head_mask")
    ref = build_model(p["trees"]["dense"], p["cfg"], device="cpu", dtype=torch.float32)
    sharding.shard_params(ref, m)
    out["load_equal"] = all(torch.equal(a, b) for a, b in zip(
        loaded.state_dict().values(), ref.state_dict().values()))
    out["logits_loaded"] = _forward_logits(loaded, p["cfg"], p["inp"], dp)
    built = {tier: build_model(flat, p["cfg"], device="cpu", dtype=torch.float32, mesh=m)
             for tier, flat in p["trees"].items()}
    out["built_equal"] = {tier: all(torch.equal(a, b) for a, b in zip(
        b.state_dict().values(), ref.state_dict().values())) for tier, b in built.items()
        if tier == "dense"}
    out["built_logits"] = {tier: _forward_logits(b, p["cfg"], p["inp"], dp)
                           for tier, b in built.items()}
    # B2u's mesh form: each rank its rows and kv heads, the output gathered
    from visualcla_tpu_torch.ops import attention

    f = {n: torch.from_numpy(a) for n, a in p["flash"].items()}
    out["flash_sharded"] = attention._flash_sharded(f["q"], f["k"], f["v"], f["valid"], 4,
                                                    m).numpy()
    q3 = f["q"][:, :, :3]  # 3 heads do not divide model = 2
    k3, v3 = f["k"][:, :3], f["v"][:, :3]
    out["flash_indivisible"] = attention._flash_sharded(q3, k3, v3, f["valid"], 4, m)
    with attention.attention_mesh_scope(m):
        out["flash_fallback"] = attention.cached_attention(
            q3, k3, v3, f["valid"], 4).numpy()
    # ring attention over a (data=1, seq=4) mesh
    cp = mesh((1, 4), ("data", "seq"))
    q, k, v, valid = (torch.from_numpy(p["ring"][n]) for n in ("q", "k", "v", "valid"))
    out["ring"] = ring.ring_attention_sharded(q, k, v, cp, kv_valid=valid).numpy()
    return out


def _load(p: dict, mesh_):
    import visualcla_tpu_torch as vt

    model, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=p["ckpt"], dtype=torch.float32, device="cpu",
        max_seq_len=p["max_seq"], mesh=mesh_)
    return model


def engine_suite(p: dict) -> dict:
    """Engine greedy and sampled on (2, 2), CP on (1, 4), speculative and
    beams through the factory on (2, 2)."""
    from visualcla_tpu_torch.engine.generate import Engine
    from visualcla_tpu_torch.engine.sampling import SamplingConfig

    out = {}
    m = mesh()
    model = _load(p, m)
    eng = model.engine
    g = SamplingConfig.greedy(max_new_tokens=p["new"])
    out["greedy"] = eng.generate(p["ids"], p["pixels"], p["img_pos"], g)
    out["ws_rows"] = sorted({key[0] for key in eng._workspaces})  # B / data rows each
    out["sampled"] = eng.generate(p["ids"], p["pixels"], p["img_pos"],
                                  SamplingConfig(**p["sampled"]), seed=3)
    out["stream"] = np.stack(list(eng.stream(p["ids"][:1], p["pixels"][:1],
                                             p["img_pos"][:1], g)), axis=1)
    # B = 2 over data = 2, sampled, 3 steps a host read: each rank streams its row
    out["stream_split"] = np.stack(list(eng.stream(
        p["ids"], p["pixels"], p["img_pos"], SamplingConfig(**p["sampled"]), seed=3,
        chunk_size=3)), axis=1)
    out["spec"] = model.generate(p["chat_ids"], generation_config=g, speculative=True,
                                 spec_k=3)
    out["beam"] = model.generate(p["chat_ids"], generation_config=SamplingConfig(
        **{**p["greedy_kw"], "max_new_tokens": p["new"], "num_beams": 2}))
    out["kv_heads"] = model.model.text.kv_heads
    # context parallelism: a (data=1, seq=4) mesh, the prompt a bucket of 512
    from visualcla_tpu_torch.models import llama

    cp = mesh((1, 4), ("data", "seq"))
    model_cp = _load(p, cp)
    cp_eng = Engine(model_cp.model, model_cp.config, eos_token_id=p["eos"], pad_token_id=0,
                    max_seq_len=p["cp_max_seq"], mesh=cp)
    calls, ring_fn = [], llama.ring_attention

    def counted(q, *a, **k):
        calls.append(q.shape[1])  # the rank's chunk of the prompt
        return ring_fn(q, *a, **k)

    llama.ring_attention = counted
    try:
        out["cp"] = cp_eng.generate(p["long_ids"], sampling=SamplingConfig.greedy(p["new"]))
    finally:
        llama.ring_attention = ring_fn
    out["ring_chunks"] = calls
    # DP x CP: (data=2, seq=2), a row a data rank, its prompt over two seq ranks
    dcp = mesh((2, 2), ("data", "seq"))
    model_dcp = _load(p, dcp)
    out["dp_cp"] = Engine(model_dcp.model, model_dcp.config, eos_token_id=p["eos"],
                          pad_token_id=0, max_seq_len=p["cp_max_seq"], mesh=dcp).generate(
        p["long_ids"], sampling=SamplingConfig.greedy(p["new"]))
    return out


def paged_suite(p: dict) -> dict:
    """PagedServingEngine on (2, 2) with an int8 pool, B = 8, mixed one-shot
    and chunked admissions; and a speculative pool."""
    from visualcla_tpu_torch.checkpoint.from_jax import build_model
    from visualcla_tpu_torch.engine.paged import PagedServingEngine

    m = mesh()
    model = build_model(p["tree"], p["cfg"], device="cpu", dtype=torch.float32)
    return {"pool": run_pool(PagedServingEngine, model, p, m),
            "spec": run_pool(PagedServingEngine, model, p, m, spec_k=3)}


def run_pool(cls, model, p: dict, mesh_, spec_k: int = 0) -> list:
    """The JAX paged test's set-up: 8 prompts, even rows one-shot, odd rows
    chunked, 8 steps (speculative iterations with ``spec_k``)."""
    from visualcla_tpu_torch.engine.sampling import SamplingConfig

    eng = cls(model, p["cfg"], eos_token_id=2, pad_token_id=0, pool_size=8, block_size=8,
              num_blocks=96, max_seq_len=96, max_new_tokens_cap=8, prompt_buckets=(16, 32, 48),
              sampling=SamplingConfig.greedy(max_new_tokens=8), kv_quant="int8", mesh=mesh_,
              spec_k=spec_k)
    for r, prompt in enumerate(p["prompts"]):
        if r % 2:
            pp = eng.begin_prefill(r, prompt, None, None, 8, chunk=16)
            while not pp.step():
                pass
        else:
            eng.prefill_row(r, prompt, None, None, 8)
    for _ in range(8):
        if spec_k:
            eng.spec_step_n(1)
        else:
            eng.step()
    return [list(eng.collect_row(r)) for r in range(8)]


# ---------------------------------------------------------------------------
# training over a mesh: the pipeline, the (data, model) steps, the CLI
# ---------------------------------------------------------------------------

def _model(flat, cfg, dtype):
    from visualcla_tpu_torch.checkpoint.from_jax import build_model

    return build_model(flat, cfg, device="cpu", dtype=dtype)


def _local_cache(cache) -> dict:
    return {k: v.clone() for k, v in cache.items()}


def _pipe_mesh(P, n_other, other="data"):
    """A (rep, pipe, ``other``) mesh over the 4 ranks: ``rep`` copies of a
    (P, n_other) mesh."""
    return mesh((4 // (P * n_other), P, n_other), ("rep", "pipe", other))


def _coords(m) -> dict:
    return {n: m.get_local_rank(n) for n in m.mesh_dim_names}


def pipeline_suite(p: dict) -> dict:
    """Prefill cases over (P, data, M), decode steps, per-row slots, an int8
    cache, PP x TP, the refusal of a bad microbatch count, gradients through
    the schedule and the composite train step."""
    from visualcla_tpu_torch.parallel import pipeline as pp
    from visualcla_tpu_torch.train import trainer

    cfg = p["cfg"]
    tc = cfg.text_config
    ids, Smax = torch.from_numpy(p["ids"]), p["Smax"]
    B, S = ids.shape
    pos = torch.arange(S)[None].expand(B, S)
    valid = torch.zeros(B, Smax, dtype=torch.bool)
    valid[:, :S] = True
    out = {}
    with torch.no_grad():
        for (P, nd, M) in p["cases"]:
            m = _pipe_mesh(P, nd)
            for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
                model = _model(p["flat"][name], cfg, dtype)
                pp.shard_text_params(model, m)
                text = model.text
                cache = pp.pipeline_kv_cache(tc, B, Smax, dtype, m, device="cpu")
                h, cache = pp.pipeline_forward(text, tc, text.embed(ids), pos, cache, valid, 0, m,
                                               n_micro=M)
                out[("prefill", P, nd, M, name)] = (h.numpy(), _local_cache(cache), _coords(m))
                if (P, nd, M, name) == (2, 1, 1, "f32"):
                    # a rank holds its stage's layers only; the decode steps follow
                    out["held"] = (sum(t.numel() for t in text.layers.parameters()),
                                   [l for l, layer in enumerate(text.layers)
                                    if layer.q_proj.weight.numel()])
                    steps = []
                    kv = valid.clone()
                    for step, tok in enumerate(p["decode"]):
                        kv[:, S + step] = True
                        h, cache = pp.pipeline_forward(
                            text, tc, text.embed(torch.from_numpy(tok)),
                            torch.full((B, 1), S + step), cache, kv, S + step, m)
                        steps.append(h.numpy())
                    out["decode"] = steps
        m = _pipe_mesh(2, 1)
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            model = _model(p["flat"][name], cfg, dtype)
            pp.shard_text_params(model, m)
            text = model.text
            # per-row write slots: one token a row at slots 3 and 7
            slot = torch.tensor([3, 7])
            kvr = torch.arange(Smax)[None, :] <= slot[:, None]
            cache = pp.pipeline_kv_cache(tc, 2, Smax, dtype, m, device="cpu")
            h, cache = pp.pipeline_forward(text, tc, text.embed(ids[:2, :1]), slot[:, None], cache,
                                           kvr, slot, m)
            out[("per_row", name)] = (h.numpy(), _local_cache(cache), _coords(m))
        model = _model(p["flat"]["f32"], cfg, torch.float32)
        pp.shard_text_params(model, m)
        cache = pp.pipeline_kv_cache(tc, B, Smax, torch.float32, m, kv_quant="int8", device="cpu")
        h, cache = pp.pipeline_forward(model.text, tc, model.text.embed(ids), pos, cache, valid, 0, m)
        out["int8"] = (h.numpy(), _local_cache(cache), _coords(m))
        try:
            pp.pipeline_forward(model.text, tc, model.text.embed(ids[:2]), pos[:2], None,
                                valid[:2, :S], 0, m, n_micro=3)
        except ValueError as e:
            out["n_micro_3"] = str(e)
        # PP x TP: (pipe 2, model 2)
        tpm = mesh((2, 2), ("pipe", "model"))
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            model = _model(p["flat"][name], cfg, dtype)
            pp.shard_text_params(model, tpm)
            cache = pp.pipeline_kv_cache(tc, B, Smax, dtype, tpm, kv_heads=model.text.kv_heads,
                                         device="cpu")
            h, cache = pp.pipeline_forward(model.text, tc, model.text.embed(ids), pos, cache,
                                           valid, 0, tpm)
            out[("pp_tp", name)] = (h.numpy(), _local_cache(cache), {
                **_coords(tpm), "kv_local": model.text.kv_heads < tc.num_key_value_heads})
    # gradients of sum(h^2) through the cache-free schedule (f64, M = 2)
    model = _model(p["flat"]["f64"], cfg, torch.float64)
    pp.shard_text_params(model, m)
    for t in model.parameters():
        t.requires_grad_(True)
    text = model.text
    h, _ = pp.pipeline_forward(text, tc, text.embed(ids), pos, None, valid[:, :S], 0, m, n_micro=2)
    (h ** 2).sum().backward()
    out["grads"] = {n: t.grad.clone() for n, t in model.named_parameters()
                    if t.grad is not None and t.grad.numel()}
    out["grad_coords"] = _coords(m)
    # the composite train step: (pipe 2, data 1) in f32 against JAX, and
    # (pipe 2, data 2) in f64 against the port's unmeshed step
    for key, (P, nd), name, dtype in ((("step", 2, 1), (2, 1), "f32", torch.float32),
                                      (("step", 2, 2), (2, 2), "f64", torch.float64)):
        sm = _pipe_mesh(P, nd)
        model = _model(p["flat_vis"][name], cfg, dtype)
        pp.shard_text_params(model, sm)
        opt = trainer.make_optimizer(learning_rate=1e-3, schedule="const")
        step = trainer.make_train_step(model, cfg, opt, pipeline_mesh=sm, n_micro=2)
        state = trainer.init_train_state(model, opt)
        metrics = []
        for _ in range(2):
            state, mt = step(state, p["batch"])
            metrics.append((float(mt["loss"]), float(mt["grad_norm"])))
        from visualcla_tpu_torch.checkpoint.from_jax import params_to_jax

        out[key] = (metrics, {k: v.numpy() for k, v in params_to_jax(model).items()})
    return out


def _steps(model, cfg, trainable, batch, n: int, clip: float, subset: bool):
    """``n`` steps of the subset (or masked) step over ``model``'s mesh ->
    ([(loss, grad_norm)], the trainable leaves whole, JAX layout)."""
    from visualcla_tpu_torch.checkpoint.from_jax import params_to_jax
    from visualcla_tpu_torch.train import trainer

    opt = trainer.make_optimizer(learning_rate=1e-3, schedule="const", grad_clip=clip)
    if subset:
        train, frozen = trainer.partition_params(model, trainable)
        step = trainer.make_train_step_subset(model, cfg, opt, trainable)
        state = trainer.init_train_state(train, opt)
    else:
        step = trainer.make_train_step(model, cfg, opt, trainable)
        state = trainer.init_train_state(model, opt)
    metrics = []
    for _ in range(n):
        state, m = (step(state, frozen, batch) if subset else step(state, batch))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    flat = params_to_jax(model)  # whole, every rank taking part
    return metrics, {k: v.numpy() for k, v in flat.items() if trainable(tuple(k.split("/")))}


def mesh_train_suite(p: dict) -> dict:
    """Steps over a (data 2, model 2) mesh: stage 1, stage 2 over an int8
    (QLoRA) base with a clip that engages, unequal token counts over the data
    ranks, FSDP against TP-only, and the adapter export and merge."""
    from visualcla_tpu_torch.checkpoint.from_jax import build_model, params_to_jax
    from visualcla_tpu_torch.train import lora, trainer

    cfg, m = p["cfg"], mesh()
    out = {}
    for key, tree, pred, subset, clip, batch in (
            ("stage1", "dense", trainer.stage1_trainable, False, 1.0, "batch"),
            ("stage2", "qlora", lora.lora_trainable, True, 1e-3, "batch"),
            ("unequal", "dense", trainer.stage1_trainable, False, 1.0, "unequal")):
        model = build_model(p["trees"][tree], cfg, device="cpu", dtype=torch.float32, mesh=m)
        out[key] = _steps(model, cfg, pred, p[batch], p["n_steps"], clip, subset)
    # FSDP against TP-only: the stage-2 step over a dense base with LoRA
    layer_bytes = {}
    for fsdp in (False, True):
        model = build_model(p["trees"]["lora"], cfg, device="cpu", dtype=torch.float32, mesh=m)
        if fsdp:
            from visualcla_tpu_torch.parallel.fsdp import shard_layers

            shard_layers(model, m)
        layer_bytes[fsdp] = sum(t.numel() * t.element_size()
                                for t in model.text.layers.parameters())
        out[("fsdp", fsdp)] = _steps(model, cfg, lora.lora_trainable, p["batch"], p["n_steps"],
                                     1.0, True)
    out["layer_bytes"] = layer_bytes
    # the adapter written and the merge folded over the mesh (FSDP too)
    model = build_model(p["trees"]["lora"], cfg, device="cpu", dtype=torch.float32, mesh=m)
    from visualcla_tpu_torch.parallel.fsdp import shard_layers

    shard_layers(model, m)
    lora.export_adapter(model, p["adapter_dir"], r=p["r"], alpha=p["alpha"])
    lora.merge_lora(model)
    flat = params_to_jax(model)
    if torch.distributed.get_rank() == 0:
        out["merged"] = {k: v.numpy() for k, v in flat.items()}
    return out


def cli_suite(p: dict) -> dict:
    """``run_training.main`` under each set of mesh flags: 2 steps saving
    every step, then a run resumed from step 1."""
    from visualcla_tpu_torch.train.run_training import main

    out = {}
    for name, flags in p["runs"].items():
        d = os.path.join(p["root"], name)
        st = main(p["args"] + ["--output", d, "--save_every", "1", *flags])
        re = main(p["args"] + ["--output", d + "_resumed", "--save_every", "1", "--resume",
                               os.path.join(d, "train_state", "step_1"), *flags])
        out[name] = (st.step, re.step)
    return out


SUITES = {"forward": forward_suite, "engine": engine_suite, "paged": paged_suite,
          "pipeline": pipeline_suite, "mesh_train": mesh_train_suite, "cli": cli_suite}
