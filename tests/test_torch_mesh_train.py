"""Training over a (data 2, model 2) mesh in the port against the JAX
package's meshed step and the port's unmeshed step, on the CPU: one spawn
of four gloo ranks (``tests/torch_mesh_ranks.py``); the parent runs JAX's
step jitted on ``Mesh(devices[:4].reshape(2, 2))`` over ``shard_params``
trees and a batch sharded on ``data`` (what the JAX CLI runs), and the
port's unmeshed step.  The config is the serving mesh tests' (an odd
vocabulary: the LM head stays whole; GQA heads; 2 layers a tower).

Cases: the stage-1 masked step; the stage-2 LoRA subset step over an int8
(QLoRA) base with a clip that engages; a batch whose data ranks hold
different token counts (the loss is the global token-weighted mean, not
the mean of the ranks' means); FSDP against TP-only, with each rank's layer
bytes; the adapter export and the merge over the mesh against the unmeshed
files.

Tolerances (fp32): loss and grad_norm rtol 1e-5, parameters after 2 steps
atol 1e-5, against JAX and against the unmeshed port (the sums over the
mesh's ranks add in another order); FSDP against TP-only, which add the
same partial sums, rtol 1e-6 and atol 1e-7; the adapter file and the merged
tensors bitwise."""
import os

import numpy as np
import pytest
import torch

from tests.test_torch_host import port_config
from tests.test_torch_mesh import jax_config
from tests.torch_mesh_ranks import spawn
from visualcla_tpu_torch.checkpoint.from_jax import build_model, params_to_jax

RTOL = ATOL = 1e-5
R, ALPHA = 4, 8.0
N_STEPS = 2


def _flat(tree):
    from visualcla_tpu.checkpoint.serialize import flatten_tree

    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


def _batch(rng, jcfg, counts=None):
    """B = 4 rows of 24 tokens with an image at 1; ``counts`` (per row): the
    trained labels at the end of each row (the rest -100)."""
    B, S = 4, 24
    ids = rng.integers(5, 90, (B, S)).astype(np.int64)
    labels = np.full((B, S), -100, np.int64)
    counts = counts or [S - jcfg.num_image_tokens - 4] * B
    for b, n in enumerate(counts):
        labels[b, S - n:] = ids[b, S - n:]
    mask = np.ones((B, S), np.int64)
    mask[3, -2:] = 0
    labels[3, -2:] = -100
    size = jcfg.vision_config.image_size
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "img_start_pos": np.asarray([1, 1, 1, 1]),
            "pixel_values": rng.standard_normal((B, 3, size, size)).astype(np.float32)}


def _jax_steps(tree, jcfg, trainable, batch, clip, subset, mesh):
    """JAX's step jitted over ``mesh`` (``shard_params`` tree, batch on
    ``data``), N_STEPS times -> (metrics, the trainable leaves)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from visualcla_tpu.checkpoint.serialize import unflatten_tree
    from visualcla_tpu.parallel import sharding as j_shd
    from visualcla_tpu.train import trainer as j_trainer

    opt = j_trainer.make_optimizer(learning_rate=1e-3, schedule="const", grad_clip=clip)
    tree = j_shd.shard_params(jax.tree.map(jnp.asarray, unflatten_tree(tree)), mesh)
    b = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
         for k, v in batch.items()}
    metrics = []
    with mesh:
        if subset:
            train, frozen = j_trainer.partition_params(tree, trainable)
            step = jax.jit(j_trainer.make_train_step_subset(jcfg, opt, trainable))
            state = j_trainer.init_train_state(train, opt)
            for _ in range(N_STEPS):
                state, m = step(state, frozen, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        else:
            step = jax.jit(j_trainer.make_train_step(jcfg, opt, trainable=trainable))
            state = j_trainer.init_train_state(tree, opt)
            for _ in range(N_STEPS):
                state, m = step(state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
    flat = _flat(jax.device_get(state.params))
    return metrics, {k: v for k, v in flat.items() if trainable(tuple(k.split("/")))}


def _port_steps(flat, cfg, trainable, batch, clip, subset):
    """The port's unmeshed step, N_STEPS times -> (metrics, trainable leaves)."""
    from visualcla_tpu_torch.train import trainer

    model = build_model(flat, cfg, device="cpu", dtype=torch.float32)
    opt = trainer.make_optimizer(learning_rate=1e-3, schedule="const", grad_clip=clip)
    if subset:
        train, frozen = trainer.partition_params(model, trainable)
        step = trainer.make_train_step_subset(model, cfg, opt, trainable)
        state = trainer.init_train_state(train, opt)
    else:
        step = trainer.make_train_step(model, cfg, opt, trainable)
        state = trainer.init_train_state(model, opt)
    metrics = []
    for _ in range(N_STEPS):
        state, m = step(state, frozen, batch) if subset else step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, {k: v.numpy() for k, v in params_to_jax(model).items()
                     if trainable(tuple(k.split("/")))}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tests.test_torch_train import qlora_base
    from visualcla_tpu.models import visualcla as j_vis
    from visualcla_tpu.train import lora as j_lora
    from visualcla_tpu.train import trainer as j_trainer

    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    jcfg = jax_config()
    base = j_vis.init_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    lp = j_lora.add_lora(base, r=R, alpha=ALPHA, rng=jax.random.PRNGKey(6))
    rng = np.random.default_rng(6)
    for tower in ("text", "vision"):  # B made non-zero (add_lora starts it at zero)
        for node in lp[tower]["layers"].values():
            if isinstance(node, dict) and "lora_B" in node:
                node["lora_B"] = jnp.asarray(
                    rng.standard_normal(node["lora_B"].shape).astype(np.float32) * 0.05)
    ql = j_lora.add_lora(qlora_base(base), r=R, alpha=ALPHA, rng=jax.random.PRNGKey(7))
    trees = {"dense": _flat(base), "lora": _flat(lp), "qlora": _flat(ql)}
    batch = _batch(rng, jcfg)
    # data rank 0 (rows 0-1) trains 2 tokens a row, data rank 1 (rows 2-3) 14
    unequal = _batch(rng, jcfg, counts=[2, 2, 14, 14])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    stage1 = j_trainer.stage1_trainable
    want = {"stage1": _jax_steps(trees["dense"], jcfg, stage1, batch, 1.0, False, mesh),
            "stage2": _jax_steps(trees["qlora"], jcfg, j_lora.lora_trainable, batch, 1e-3,
                                 True, mesh),
            "unequal": _jax_steps(trees["dense"], jcfg, stage1, unequal, 1.0, False, mesh)}
    cfg = port_config(jcfg)
    from visualcla_tpu_torch.train import lora as t_lora
    from visualcla_tpu_torch.train import trainer as t_trainer

    plain = {"stage1": _port_steps(trees["dense"], cfg, t_trainer.stage1_trainable, batch, 1.0,
                                   False),
             "stage2": _port_steps(trees["qlora"], cfg, t_lora.lora_trainable, batch, 1e-3,
                                   True),
             "unequal": _port_steps(trees["dense"], cfg, t_trainer.stage1_trainable, unequal,
                                    1.0, False)}
    payload = {"cfg": cfg, "trees": trees, "batch": batch, "unequal": unequal,
               "n_steps": N_STEPS, "adapter_dir": os.path.join(tmp, "adapter_mesh"),
               "r": R, "alpha": ALPHA}
    ranks = spawn("mesh_train", 4, os.path.join(tmp, "ranks"), payload)
    return {"want": want, "plain": plain, "ranks": ranks, "cfg": cfg, "trees": trees,
            "tmp": tmp, "unequal": unequal}


def _close(got, want, rtol=RTOL, atol=ATOL):
    metrics, params = got
    w_metrics, w_params = want
    np.testing.assert_allclose(metrics, w_metrics, rtol=rtol)
    assert sorted(params) == sorted(w_params)
    for k in w_params:
        np.testing.assert_allclose(params[k], w_params[k], atol=atol, err_msg=k)


def test_ranks_load_no_jax(setup):
    assert not any(r["jax_loaded"] for r in setup["ranks"])


@pytest.mark.parametrize("case", ["stage1", "stage2", "unequal"])
def test_mesh_step_matches_jax_and_unmeshed(setup, case):
    for r in setup["ranks"]:
        _close(r[case], setup["want"][case])
        _close(r[case], setup["plain"][case])


def test_clip_engages(setup):
    """The stage-2 step's clip (1e-3) engages: its global norm (of the
    logical arrays: embed_tokens' and the LoRA leaves' pieces over the mesh)
    is above it, equal on every rank, and the parameters moved as JAX's."""
    norms = {r["stage2"][0][0][1] for r in setup["ranks"]}
    assert len(norms) == 1 and norms.pop() > 1e-3


def test_loss_is_the_global_token_mean(setup):
    """Data rank 0's rows train 2 tokens each, rank 1's 14: the loss is the
    token-weighted mean of the whole batch, which the mean of the two ranks'
    means misses by far more than the tolerance."""
    from visualcla_tpu_torch.train import trainer

    model = build_model(setup["trees"]["dense"], setup["cfg"], device="cpu", dtype=torch.float32)
    b = trainer.batch_to_device(model, setup["unequal"])
    with torch.no_grad():
        logits = trainer.train_forward_logits(model, setup["cfg"], b["input_ids"],
                                              b["attention_mask"], b["img_start_pos"],
                                              b["pixel_values"])
    halves = [float(trainer.causal_lm_loss(logits[r], b["labels"][r]))
              for r in (slice(0, 2), slice(2, 4))]
    mean_of_means = sum(halves) / 2
    loss = setup["ranks"][0]["unequal"][0][0][0]
    assert abs(loss - mean_of_means) > 100 * RTOL * abs(loss)
    np.testing.assert_allclose(loss, setup["want"]["unequal"][0][0][0], rtol=RTOL)


def test_fsdp_matches_tp_only(setup):
    for r in setup["ranks"]:
        _close(r[("fsdp", True)], r[("fsdp", False)], rtol=1e-6, atol=1e-7)
        tp_only, fsdp = r["layer_bytes"][False], r["layer_bytes"][True]
        assert fsdp * 2 == tp_only  # each data rank holds 1 of the 2 layers


def test_adapter_and_merge_equal_unmeshed(setup):
    from visualcla_tpu_torch.train import lora

    model = build_model(setup["trees"]["lora"], setup["cfg"], device="cpu", dtype=torch.float32)
    plain_dir = os.path.join(setup["tmp"], "adapter_plain")
    lora.export_adapter(model, plain_dir, r=R, alpha=ALPHA)
    a = torch.load(os.path.join(plain_dir, "adapter_model.bin"), weights_only=True)
    b = torch.load(os.path.join(setup["tmp"], "adapter_mesh", "adapter_model.bin"),
                   weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    lora.merge_lora(model)
    want = {k: v.numpy() for k, v in params_to_jax(model).items()}
    got = setup["ranks"][0]["merged"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
