"""Training in the PyTorch port against the JAX package, on the CPU in fp32
on the tiny config: the loss, the cache-free forward, per-leaf gradients
(stage 1, stage 2 with LoRA, QLoRA over an int8 base, stage 1 over an int4
text tower), parameters after three optimizer steps against optax (the
masked step, the subset step, the cosine schedule, stage 1 over int4 with
and without remat), remat, the partition guard, B3's input gradient
against ``jax.vjp`` of the XLA form, the attention kernels' refusal of
autograd, and the chat after a training step.

Tolerances (fp32, the two packages sum in different orders): loss and
grad_norm rtol 1e-5; gradients rtol 1e-4 / atol 1e-6; parameters after 3
steps at lr 1e-3 atol 1e-5; logits 1e-5; B3's input gradient rtol 1e-5 /
atol 1e-6 (one product of the same dequantized weight in JAX's large-T
branch; per group, scaled after the product, in its small-T branch)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from visualcla_tpu.checkpoint.serialize import flatten_tree as j_flatten
from visualcla_tpu.checkpoint.serialize import unflatten_tree as j_unflatten
from visualcla_tpu.core.config import tiny_visualcla_config
from visualcla_tpu.models import llama as j_llama
from visualcla_tpu.models import visualcla as j_vmod
from visualcla_tpu.ops.quantization import INT8_TEXT_LEAVES
from visualcla_tpu.ops.quantization import _q_matmul_grouped as j_q_matmul_grouped
from visualcla_tpu.ops.quantization import quantize as j_quantize
from visualcla_tpu.ops.quantization import quantize_grouped as j_quantize_grouped
from visualcla_tpu.ops.quantization import quantize_tree as j_quantize_tree
from visualcla_tpu.train import lora as j_lora
from visualcla_tpu.train import trainer as j_trainer
from visualcla_tpu_torch.checkpoint import from_jax
from visualcla_tpu_torch.core.config import VisualCLAConfig as TConfig
from visualcla_tpu_torch.models import llama as t_llama
from visualcla_tpu_torch.models import visualcla as t_vmod
from visualcla_tpu_torch.ops import attention as t_attention
from visualcla_tpu_torch.ops import linear as t_linear
from visualcla_tpu_torch.ops.cuda import flash_attention as t_fa
from visualcla_tpu_torch.ops.cuda import int4_matmul as t_i4
from visualcla_tpu_torch.ops.cuda import paged_attention as t_pa
from visualcla_tpu_torch.train import lora as t_lora
from visualcla_tpu_torch.train import trainer as t_trainer

R, ALPHA = 4, 8.0
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL = 1e-5
LOGIT_ATOL = 1e-5
I4_GRAD_RTOL, I4_GRAD_ATOL = 1e-5, 1e-6


def t_cfg(cfg) -> TConfig:
    return TConfig.from_hf_dict(dataclasses.asdict(cfg))


def flat_np(tree) -> dict:
    return {k: np.asarray(v) for k, v in j_flatten(tree).items()}


def port_model(params, cfg):
    """The port's fp32 CPU model holding the JAX tree's values."""
    return from_jax.build_model(flat_np(params), t_cfg(cfg), device="cpu", dtype=torch.float32)


def base_params(cfg, seed=0):
    return j_vmod.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)


def lora_params(params, seed=1, b_scale=0.05):
    """JAX ``add_lora`` on the text and vision projections, B made non-zero
    from the seed (``add_lora`` starts B at zero)."""
    lp = j_lora.add_lora(params, r=R, alpha=ALPHA, rng=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for tower in ("text", "vision"):
        for node in lp[tower]["layers"].values():
            if isinstance(node, dict) and "lora_B" in node:
                node["lora_B"] = jnp.asarray(
                    rng.standard_normal(node["lora_B"].shape).astype(np.float32) * b_scale)
    return lp


def qlora_base(params):
    """The JAX QLoRA recipe's tree: int8 layer matmuls, float embed_tokens
    and lm_head (they train)."""
    flat = j_flatten(params["text"])
    q8 = {}
    for k, v in flat.items():
        if "text/" + k in INT8_TEXT_LEAVES and k not in ("embed_tokens", "lm_head"):
            q8[k] = j_quantize(np.asarray(v, np.float32))
        else:
            q8[k] = v
    out = dict(params)
    out["text"] = j_unflatten(q8)
    return out


def make_batch(cfg, seed=1, B=2, S=24, image=True, pad=0):
    """Seeded batch (numpy): ids, labels with the prompt region masked, a
    right-padded second row (``pad`` slots), ``<img>`` at 1 or text-only."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.text_config.vocab_size, (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[:, : cfg.num_image_tokens + 4] = -100
    mask = np.ones((B, S), np.int32)
    if pad:
        mask[-1, -pad:] = 0
        labels[-1, -pad:] = -100
    size = cfg.vision_config.image_size
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "img_start_pos": np.full((B,), 1 if image else -1, np.int32),
            "pixel_values": (rng.standard_normal((B, 3, size, size)).astype(np.float32)
                             if image else None)}


def j_batch(batch):
    return {k: (None if v is None else jnp.asarray(v)) for k, v in batch.items()}


def j_loss_fn(cfg, batch):
    b = j_batch(batch)

    def loss(params):
        logits = j_trainer.train_forward_logits(
            params, cfg, b["input_ids"], b["attention_mask"], b["img_start_pos"],
            b["pixel_values"])
        return j_trainer.causal_lm_loss(logits, b["labels"])

    return loss


def port_grads(model, cfg, batch, trainable):
    """(loss, the trainable leaves' gradients in the JAX layout)."""
    t_trainer.partition_params(model, trainable)
    loss = t_trainer.loss_fn(model, t_cfg(cfg), batch)
    loss.backward()
    return (float(loss.detach()),
            {k: v.numpy() for k, v in from_jax.params_to_jax(model, grads=True).items()})


def assert_tree_close(port_flat, jax_flat, keys=None, atol=PARAM_ATOL, rtol=0.0):
    keys = sorted(port_flat) if keys is None else keys
    assert keys
    for k in keys:
        np.testing.assert_allclose(np.asarray(port_flat[k], np.float32),
                                   np.asarray(jax_flat[k], np.float32),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def cfg():
    return tiny_visualcla_config()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def test_loss_matches_manual_ce_and_jax():
    logits = np.random.default_rng(0).standard_normal((1, 4, 7)).astype(np.float32)
    labels = np.asarray([[-100, 2, -100, 3]])
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    expected = -(lp[0, 0, 2] + lp[0, 2, 3]) / 2
    got = t_trainer.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(expected), rtol=1e-6)
    ref = j_trainer.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(ref), rtol=LOSS_RTOL)


def test_loss_all_ignored_is_finite():
    got = t_trainer.causal_lm_loss(torch.zeros(1, 4, 7), torch.full((1, 4), -100))
    ref = j_trainer.causal_lm_loss(jnp.zeros((1, 4, 7), jnp.float32),
                                   jnp.full((1, 4), -100, jnp.int32))
    assert np.isfinite(float(got)) and float(got) == float(ref) == 0.0


# ---------------------------------------------------------------------------
# the cache-free forward
# ---------------------------------------------------------------------------

def test_cache_free_forward_matches_cached_and_jax():
    """``Llama.forward(kv_cache=None)`` against the port's cached forward and
    JAX's cache-free path, on a ragged batch."""
    cfg = tiny_visualcla_config(vocab_size=96)
    params = base_params(cfg)
    model = port_model(params, cfg)
    t = cfg.text_config
    rng = np.random.default_rng(0)
    B, S = 2, 24
    embeds = rng.standard_normal((B, S, t.hidden_size)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, -5:] = 0
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0)
    valid = torch.from_numpy(mask.astype(bool))
    with torch.no_grad():
        cache = t_llama.init_kv_cache(model.text.cfg, B, S, torch.float32)
        h_cached, _ = model.text(torch.from_numpy(embeds), torch.from_numpy(pos), cache, valid, 0)
        h_free, c = model.text(torch.from_numpy(embeds), torch.from_numpy(pos), None, valid, 0)
    assert c is None
    np.testing.assert_allclose(h_free.numpy(), h_cached.numpy(), atol=LOGIT_ATOL)
    h_jax, _ = j_llama.forward(params["text"], t, jnp.asarray(embeds), jnp.asarray(pos, jnp.int32),
                               None, jnp.asarray(mask.astype(bool)), jnp.int32(0))
    np.testing.assert_allclose(h_free.numpy(), np.asarray(h_jax), atol=LOGIT_ATOL)


@pytest.mark.parametrize("image", [False, True], ids=["text", "image"])
def test_train_forward_logits_matches_jax_and_cached_prefill(cfg, image):
    """Right-padded rows, text-only or with an image: the port's cache-free
    logits against JAX's ``train_forward_logits`` and the port's cached
    ``prefill_forward`` (compared on the valid positions)."""
    params = base_params(cfg)
    model = port_model(params, cfg)
    batch = make_batch(cfg, image=image, pad=5)
    b = t_trainer.batch_to_device(model, batch)
    tc = t_cfg(cfg)
    with torch.no_grad():
        got = t_trainer.train_forward_logits(model, tc, b["input_ids"], b["attention_mask"],
                                             b["img_start_pos"], b["pixel_values"])
        cache = t_llama.init_kv_cache(tc.text_config, 2, 32, torch.float32)
        pre, _ = t_vmod.prefill_forward(model, tc, b["input_ids"], b["attention_mask"],
                                        b["img_start_pos"], b["pixel_values"], cache)
    jb = j_batch(batch)
    ref = j_trainer.train_forward_logits(params, cfg, jb["input_ids"], jb["attention_mask"],
                                         jb["img_start_pos"], jb["pixel_values"])
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_ATOL)
    valid = batch["attention_mask"].astype(bool)
    np.testing.assert_allclose(got.numpy()[valid], pre.numpy()[valid], atol=LOGIT_ATOL)


def test_splice_is_differentiable_in_image_embeds():
    """Both splice forms pass the gradient to the image embeddings (and to
    the token embeddings they keep)."""
    rng = np.random.default_rng(0)
    emb = torch.tensor(rng.standard_normal((2, 10, 3)), requires_grad=True)
    img = torch.tensor(rng.standard_normal((2, 4, 3)), requires_grad=True)
    w = torch.tensor(rng.standard_normal((2, 10, 3)))
    grads = []
    for pos in (np.asarray([2, -1]), torch.tensor([2, -1])):
        emb.grad = img.grad = None
        (t_vmod.splice_image_embeds(emb, img, pos) * w).sum().backward()
        grads.append((emb.grad.clone(), img.grad.clone()))
        np.testing.assert_array_equal(img.grad[0].numpy(), w[0, 3:7].numpy())
        assert not img.grad[1].any()  # the text-only row
        assert not emb.grad[0, 3:7].any()
    for a, b in zip(*grads):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# gradients, leaf by leaf
# ---------------------------------------------------------------------------

def _jax_subset_grads(params, cfg, batch, trainable):
    train, frozen = j_trainer.partition_params(params, trainable)
    loss_fn = j_loss_fn(cfg, batch)
    loss, g = jax.value_and_grad(lambda t: loss_fn(j_trainer.merge_params(t, frozen)))(train)
    return float(loss), {k: np.asarray(v) for k, v in j_flatten(g).items() if v is not None}


def int4_base(params):
    """The JAX int4 tier's tree: ``quantize_tree(bits=4)`` (int4 layers and
    head, per-row int8 embedding table; the tiny widths take groups of 16
    and 32), the vision side untouched."""
    return j_quantize_tree(params, bits=4)


@pytest.mark.parametrize("case", ["stage1", "stage2_lora", "qlora_int8", "stage1_int4"])
def test_grads_match_jax(cfg, case):
    """Per-leaf gradients of the trainable partition; over the int4 tower
    they pass through every layer's B3 products and the int4 head into the
    spliced image embeddings."""
    params = base_params(cfg)
    if case in ("stage1", "stage1_int4"):
        trainable = j_trainer.stage1_trainable
        if case == "stage1_int4":
            params = int4_base(params)
    else:
        params = lora_params(qlora_base(params) if case == "qlora_int8" else params)
        trainable = j_lora.lora_trainable
    batch = make_batch(cfg, pad=3)
    j_loss, j_grads = _jax_subset_grads(params, cfg, batch, trainable)
    model = port_model(params, cfg)
    t_loss, t_grads = port_grads(model, cfg, batch, trainable)
    np.testing.assert_allclose(t_loss, j_loss, rtol=LOSS_RTOL)
    # the port differentiates exactly the trainable leaves (JAX's pooler has
    # no path to the loss: its gradient is zero in JAX and absent here)
    absent = set(j_grads) - set(t_grads)
    assert all("pooler" in k for k in absent), absent
    for k in absent:
        assert not np.any(j_grads[k]), k
    assert set(t_grads) <= set(j_grads)
    assert_tree_close(t_grads, j_grads, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if case == "qlora_int8":
        assert any(k.endswith("lora_A") for k in t_grads)
        assert not any(k.endswith(("/q", "/scale")) for k in t_grads)
    if case == "stage1_int4":
        assert isinstance(model.text.lm_head, t_linear.Int4Linear)
        assert any(k.startswith("vision/") for k in t_grads)
        assert not any(k.startswith("text/") for k in t_grads)


# ---------------------------------------------------------------------------
# steps against optax
# ---------------------------------------------------------------------------

def _run_jax(params, cfg, batch, trainable, form, opt, n=3):
    if form == "full":
        step = jax.jit(j_trainer.make_train_step(cfg, opt, trainable=trainable))
        st = j_trainer.init_train_state(params, opt)
        metrics = []
        for _ in range(n):
            st, m = step(st, j_batch(batch))
            metrics.append(m)
        return flat_np(st.params), metrics
    train, frozen = j_trainer.partition_params(params, trainable)
    step = jax.jit(j_trainer.make_train_step_subset(cfg, opt, trainable=trainable))
    st = j_trainer.TrainState(params=train, opt_state=opt.init(train), step=jnp.int32(0))
    metrics = []
    for _ in range(n):
        st, m = step(st, frozen, j_batch(batch))
        metrics.append(m)
    return flat_np(j_trainer.merge_params(st.params, frozen)), metrics


def _run_port(params, cfg, batch, trainable, form, opt, n=3, remat=False, model=None):
    model = port_model(params, cfg) if model is None else model
    tc = t_cfg(cfg)
    if form == "full":
        step = t_trainer.make_train_step(model, tc, opt, trainable=trainable, remat=remat)
        st = t_trainer.init_train_state(model, opt)
        metrics = []
        for _ in range(n):
            st, m = step(st, batch)
            metrics.append(m)
    else:
        train, frozen = t_trainer.partition_params(model, trainable)
        step = t_trainer.make_train_step_subset(model, tc, opt, trainable, remat=remat)
        st = t_trainer.init_train_state(train, opt)
        metrics = []
        for _ in range(n):
            st, m = step(st, frozen, batch)
            metrics.append(m)
    assert st.step == n
    return model, {k: v.numpy() for k, v in from_jax.params_to_jax(model).items()}, metrics


STEP_CASES = {
    # id: (form, stage, schedule)
    "full_stage1": ("full", "stage1", "const"),
    "full_stage2_lora": ("full", "lora", "const"),
    "subset_stage2_lora": ("subset", "lora", "const"),
    "subset_qlora_int8": ("subset", "qlora", "const"),
    "subset_lora_cosine": ("subset", "lora", "cosine"),
    "full_stage1_cosine_decay": ("full", "stage1", "cosine_wd"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_optax(cfg, case):
    """Parameters after 3 steps (lr 1e-3), loss and grad_norm each step:
    the masked full-tree step and the subset step, constant lr and the
    warmup-cosine schedule (its first step has lr 0), weight decay on the
    masked step (frozen leaves decay there too, as in JAX)."""
    form, stage, sched = STEP_CASES[case]
    params = base_params(cfg)
    if stage == "stage1":
        trainable = j_trainer.stage1_trainable
    else:
        params = lora_params(qlora_base(params) if stage == "qlora" else params)
        trainable = j_lora.lora_trainable
    kw = dict(learning_rate=1e-3, grad_clip=0.5)
    if sched == "const":
        kw["schedule"] = "const"
    else:
        kw.update(warmup_steps=1, total_steps=4)
        if sched == "cosine_wd":
            kw["weight_decay"] = 0.1
    batch = make_batch(cfg, pad=3)
    j_flat, j_metrics = _run_jax(params, cfg, batch, trainable, form,
                                 j_trainer.make_optimizer(**kw))
    _, t_flat, t_metrics = _run_port(params, cfg, batch, trainable, form,
                                     t_trainer.make_optimizer(**kw))
    for jm, tm in zip(j_metrics, t_metrics):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    assert set(t_flat) == set(j_flat)
    assert_tree_close(t_flat, j_flat, atol=PARAM_ATOL)
    if sched != "const":  # lr(0) = 0: the first step moved nothing
        assert float(t_metrics[0]["loss"]) == float(t_metrics[1]["loss"])


def test_cosine_schedule_matches_optax():
    sched = t_trainer.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 20)
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 3, 20)
    for c in range(25):
        np.testing.assert_allclose(sched(c), float(ref(c)), rtol=1e-6, atol=1e-12)


def test_subset_step_equals_masked_step(cfg):
    """With weight_decay 0 the subset step and the masked full-tree step
    update every parameter the same (the CLI's claim)."""
    params = lora_params(base_params(cfg))
    batch = make_batch(cfg)
    opt = t_trainer.make_optimizer(learning_rate=5e-3, schedule="const")
    _, full, fm = _run_port(params, cfg, batch, j_lora.lora_trainable, "full", opt)
    _, sub, sm = _run_port(params, cfg, batch, j_lora.lora_trainable, "subset", opt)
    for a, b in zip(fm, sm):
        np.testing.assert_allclose(float(a["loss"]), float(b["loss"]), rtol=1e-6)
    assert_tree_close(sub, full, atol=2e-6)


def test_stage1_mask_freezes_text(cfg):
    params = base_params(cfg)
    opt = t_trainer.make_optimizer(learning_rate=1e-2, schedule="const")
    model, after, _ = _run_port(params, cfg, make_batch(cfg), j_trainer.stage1_trainable,
                                "full", opt, n=1)
    before = flat_np(params)
    for k in before:
        if k.startswith("text/"):
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert not np.array_equal(after["resampler/layers/q_proj"],
                              before["resampler/layers/q_proj"])


def test_remat_equals_no_remat(cfg):
    """Recomputing every layer (ViT, resampler, decoder) in the backward
    gives the same loss and parameters, bit for bit on the CPU."""
    params = lora_params(base_params(cfg))
    batch = make_batch(cfg, pad=3)
    opt = t_trainer.make_optimizer(learning_rate=1e-3, schedule="const")
    _, a, am = _run_port(params, cfg, batch, j_lora.lora_trainable, "subset", opt, n=2)
    _, b, bm = _run_port(params, cfg, batch, j_lora.lora_trainable, "subset", opt, n=2,
                         remat=True)
    for x, y in zip(am, bm):
        assert float(x["loss"]) == float(y["loss"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_int4_steps(params, cfg, batch, opt, remat, n=3):
    train, frozen = j_trainer.partition_params(params, j_trainer.stage1_trainable)
    step = jax.jit(j_trainer.make_train_step_subset(cfg, opt, j_trainer.stage1_trainable,
                                                    remat=remat))
    st = j_trainer.TrainState(params=train, opt_state=opt.init(train), step=jnp.int32(0))
    metrics = []
    for _ in range(n):
        st, m = step(st, frozen, j_batch(batch))
        metrics.append(m)
    return flat_np(j_trainer.merge_params(st.params, frozen)), metrics


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_int4_stage1_steps_match_jax(cfg, remat, monkeypatch):
    """Three stage-1 subset steps over the frozen int4 tower (an image
    spliced into each row) against JAX's: loss and grad_norm each step, the
    trainable leaves after them, the int4 carriers and scales bitwise
    untouched.  The port's tower is ``quantize_text_tower_(model, 4)`` of
    the dense model: bitwise JAX's ``quantize_tree(bits=4)``.  Each step
    runs B3 once a product forward; with remat the recompute runs each
    layer's seven again (B3 re-run, no dequantized weight kept).  The
    whole-tree step refuses the int4 leaves, as JAX's does."""
    dense = base_params(cfg)
    params = int4_base(dense)
    model = t_vmod.quantize_text_tower_(port_model(dense, cfg), 4)
    ported = {k: v.numpy() for k, v in from_jax.params_to_jax(model).items()}
    want = flat_np(params)
    assert set(ported) == set(want)
    for k in want:
        np.testing.assert_array_equal(ported[k], want[k], err_msg=k)
    kw = dict(learning_rate=1e-3, grad_clip=0.5, schedule="const")
    batch = make_batch(cfg, pad=3)
    j_flat, j_metrics = _jax_int4_steps(params, cfg, batch, j_trainer.make_optimizer(**kw),
                                        remat)
    calls = []
    forward = t_i4._forward
    monkeypatch.setattr(t_i4, "_forward", lambda *a: calls.append(1) or forward(*a))
    _, t_flat, t_metrics = _run_port(params, cfg, batch, j_trainer.stage1_trainable, "subset",
                                     t_trainer.make_optimizer(**kw), remat=remat, model=model)
    L = cfg.text_config.num_hidden_layers
    assert len(calls) == 3 * ((2 if remat else 1) * 7 * L + 1)
    for jm, tm in zip(j_metrics, t_metrics):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=LOSS_RTOL)
    assert set(t_flat) == set(j_flat)
    assert_tree_close(t_flat, j_flat, atol=PARAM_ATOL)
    before = flat_np(params)
    for k in before:
        if k.startswith("text/"):
            np.testing.assert_array_equal(t_flat[k], before[k], err_msg=k)
    assert t_flat["text/lm_head/q"].dtype == np.uint8
    opt = t_trainer.make_optimizer(schedule="const")
    step = t_trainer.make_train_step(model, t_cfg(cfg), opt)
    with pytest.raises(TypeError, match="integer-dtype leaves"):
        step(t_trainer.init_train_state(model, opt), batch)


@pytest.mark.parametrize("T", [4, 40], ids=["grouped_T4", "dequant_T40"])
@pytest.mark.parametrize("f32", [False, True], ids=["forward", "forward_f32"])
def test_int4_input_grad_matches_jax_vjp(T, f32):
    """``Int4Linear``'s input gradient (B3's ``Int4MatmulFn`` backward)
    against ``jax.vjp`` of ``_q_matmul_grouped`` in both of its XLA
    branches (gs 32: T <= 16 one product per group, T > 16 through the
    dequantized weight), and against the plain backward."""
    rng = np.random.default_rng(T)
    in_dim, out, gs = 64, 24, 32
    w = j_quantize_grouped(jnp.asarray(rng.standard_normal((in_dim, out)).astype(np.float32)),
                           group=gs)
    x = rng.standard_normal((2, T // 2, in_dim)).astype(np.float32)
    g = rng.standard_normal((2, T // 2, out)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_q_matmul_grouped(a, w), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    lin = t_linear.Int4Linear(in_dim, out, gs)
    lin.q.data = torch.from_numpy(np.array(w["q"]))
    lin.scale.data = torch.from_numpy(np.array(w["scale"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = lin.forward_f32(xt) if f32 else lin(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=I4_GRAD_RTOL, atol=I4_GRAD_ATOL)
    plain = t_i4.int4_matmul_grad_ref(torch.from_numpy(g), lin.q, lin.scale, torch.float32)
    np.testing.assert_array_equal(xt.grad.numpy(), plain.numpy())
    assert lin.q.grad is None and lin.scale.grad is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int4_backward_dequantizes_as_dequantize_grouped(dtype):
    """The backward's dequantize (int8 shifts, the scale product rounded as
    it is stored) gives ``dequantize_grouped``'s values bit for bit, over
    every carrier byte."""
    from visualcla_tpu_torch.ops.quantization import dequantize_grouped

    q = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(2, 4, 32)
    scale = torch.from_numpy(np.random.default_rng(0).uniform(1e-3, 0.2, (2, 32))
                             .astype(np.float32))
    got = t_i4._dequantized(q, scale, dtype)
    assert got.dtype == dtype and torch.equal(got, dequantize_grouped(q, scale, dtype))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int4_card_tolerance_covers_b3_rounding(seed, monkeypatch):
    """``chip_smoke.py``'s INT4_TRAIN_TOL (the tiny int4 step's gradients on
    the card against the CPU) holds at least 4x the difference that B3's
    one rounding, of its fp32 input to bf16, makes: the CPU step with B3's
    plain version fed x rounded as the kernel rounds it, against the step
    without, on the same model and batch as the card check."""
    import copy

    import chip_smoke

    tc = t_cfg(tiny_visualcla_config())
    model = t_vmod.init_random_(t_vmod.VisualCLAModel(tc, dtype=torch.float32),
                                torch.Generator().manual_seed(seed), std=0.1)
    t_vmod.quantize_text_tower_(model, 4)
    batch = chip_smoke._tiny_train_batch(tc, seed)
    out = []
    for rounded in (False, True):
        m = copy.deepcopy(model)
        if rounded:
            monkeypatch.setattr(t_i4, "_forward", lambda x, q, s, o: t_i4.int4_matmul_ref(
                x.to(torch.bfloat16).float(), q, s, out_dtype=o))
        train, _ = t_trainer.partition_params(m, t_trainer.stage1_trainable)
        loss = t_trainer.loss_fn(m, tc, batch)
        loss.backward()
        grads = {n: p.grad for n, p in train.items() if p.grad is not None}
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        out.append((float(loss), float(norm), grads))
    (l0, n0, g0), (l1, n1, g1) = out
    top = max(float(g.abs().max()) for g in g0.values())
    worst = max(float((g1[n] - g0[n]).abs().max()) for n in g0) / top
    loss_tol, norm_tol, grad_tol = chip_smoke.INT4_TRAIN_TOL
    assert 0 < abs(l1 - l0) <= loss_tol / 4 * abs(l0)
    assert abs(n1 - n0) <= norm_tol / 4 * abs(n0)
    assert worst <= grad_tol / 4


def test_partition_params_raises_on_integer_leaf(cfg):
    """A quantized lm_head under a trainable path raises JAX's message."""
    params = j_flatten(base_params(cfg))
    params = {k: np.asarray(v) for k, v in params.items()}
    qp = {}
    for k, v in params.items():
        if k in INT8_TEXT_LEAVES:
            for sub, arr in j_quantize(v.astype(np.float32),
                                       axis=INT8_TEXT_LEAVES[k]).items():
                qp[f"{k}/{sub}"] = np.asarray(arr)
        else:
            qp[k] = v
    model = from_jax.build_model(qp, t_cfg(cfg), device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="integer-dtype leaves in the TRAINABLE partition"):
        t_trainer.partition_params(model, j_lora.lora_trainable)
    with pytest.raises(ValueError, match="integer-dtype leaves in the TRAINABLE partition"):
        j_trainer.partition_params(j_unflatten({k: jnp.asarray(v) for k, v in qp.items()}),
                                   j_lora.lora_trainable)
    opt = t_trainer.make_optimizer(schedule="const")
    step = t_trainer.make_train_step(model, t_cfg(cfg), opt)
    with pytest.raises(TypeError, match="integer-dtype leaves"):
        step(t_trainer.init_train_state(model, opt), make_batch(cfg))


def test_pipeline_mesh_steps_run_at_world_size_1(cfg, tmp_path):
    """``make_train_step`` and ``make_train_step_subset`` with
    ``pipeline_mesh=`` a (pipe 1, data 1) mesh (one gloo rank, a file store):
    one stage, two microbatches, against the unmeshed steps (fp32: the same
    products on the microbatches' rows; loss and grad_norm rtol 1e-6,
    parameters atol 1e-6)."""
    import torch.distributed as dist

    from visualcla_tpu_torch.parallel import pipeline as t_pp

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = t_pp.make_pipe_mesh(1, 1)
        batch = make_batch(cfg, pad=3)
        for subset in (False, True):
            out = []
            for pm in (None, mesh):
                model = port_model(lora_params(base_params(cfg)), cfg)
                if pm is not None:
                    t_pp.shard_text_params(model, pm)
                opt = t_trainer.make_optimizer(learning_rate=1e-3, schedule="const")
                if subset:
                    train, frozen = t_trainer.partition_params(model, j_lora.lora_trainable)
                    step = t_trainer.make_train_step_subset(
                        model, t_cfg(cfg), opt, j_lora.lora_trainable, pipeline_mesh=pm,
                        n_micro=2)
                    state, m = step(t_trainer.init_train_state(train, opt), frozen, batch)
                else:
                    step = t_trainer.make_train_step(model, t_cfg(cfg), opt, j_lora.lora_trainable,
                                                     pipeline_mesh=pm, n_micro=2)
                    state, m = step(t_trainer.init_train_state(model, opt), batch)
                out.append((float(m["loss"]), float(m["grad_norm"]),
                            {n: p.detach().clone() for n, p in state.params.items()}))
            (l0, g0, p0), (l1, g1, p1) = out
            np.testing.assert_allclose([l1, g1], [l0, g0], rtol=1e-6)
            for n in p0:
                np.testing.assert_allclose(p1[n].numpy(), p0[n].numpy(), atol=1e-6, err_msg=n)
        with pytest.raises(ValueError, match="n_micro"):
            t_trainer.train_forward_logits(
                model, t_cfg(cfg), *(torch.as_tensor(batch[k]) for k in (
                    "input_ids", "attention_mask")), batch["img_start_pos"],
                torch.as_tensor(batch["pixel_values"]), pipeline_mesh=mesh, n_micro=3)
    finally:
        dist.destroy_process_group()


def test_training_forward_pins_dense_vision_attention(cfg, monkeypatch):
    """With ``VISUALCLA_VIT_ATTN=flash`` the inference encode reaches B2u's
    wrapper; the training forward, and its remat recompute in the backward,
    never do."""
    monkeypatch.setenv("VISUALCLA_VIT_ATTN", "flash")
    calls = []
    orig = t_attention.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(t_attention, "flash_attention", counting)
    model = port_model(lora_params(base_params(cfg)), cfg)
    batch = make_batch(cfg)
    with torch.no_grad():
        t_vmod.encode_image(model, t_cfg(cfg), torch.from_numpy(batch["pixel_values"]))
    assert calls
    calls.clear()
    t_trainer.partition_params(model, t_trainer.stage1_trainable)
    t_trainer.loss_fn(model, t_cfg(cfg), batch, remat=True).backward()
    assert not calls


# ---------------------------------------------------------------------------
# the kernels refuse autograd
# ---------------------------------------------------------------------------

def _flash_args(B=1, Sq=1, S=8, N=2, hd=4, L=2):
    q = torch.randn(B, Sq, N, hd, requires_grad=True)
    k = torch.randn(L, B, N, S, hd)
    return q, k, k.clone(), torch.ones(B, S, dtype=torch.bool), 0


def _refusals():
    q, kc, vc, valid, slot = _flash_args()
    yield "B1", lambda: t_fa.flash_decode_stacked(q, kc, vc, valid, slot, 0), None
    q2, kc2, vc2, valid2, _ = _flash_args(Sq=3)
    yield "B2", lambda: t_fa.flash_prefill_stacked(q2, kc2, vc2, valid2, 0, 1), None
    yield "B2u", lambda: t_fa.flash_attention(q2, kc2[0].transpose(1, 2), vc2[0].transpose(1, 2),
                                              valid2, 0, causal=False), None
    x = torch.randn(2, 16, requires_grad=True)
    lin = t_linear.Int4Linear.from_dense(torch.randn(8, 16), 16)
    # B3 is differentiable in x: its three cases check x's gradient
    yield "B3", lambda: t_i4.int4_matmul(x, lin.q, lin.scale), (x, lin)
    yield "B3", lambda: lin(x), (x, lin)
    yield "B3", lambda: t_linear.LoraLinear(lin, 2)(x), (x, lin)  # A = B = 0
    from visualcla_tpu_torch import fixtures
    case = fixtures.paged_case([3, 5], 4, 2, hd=64, block_size=8, dtype=torch.float32)
    case["q"].requires_grad_(True)
    yield "B4", lambda: t_pa.paged_append_attention(**case), None
    vcase = fixtures.paged_verify_case([3, 5], 2, 4, 2, hd=64, block_size=8,
                                       dtype=torch.float32)
    vcase["q"].requires_grad_(True)
    yield "B5", lambda: t_pa.paged_verify_attention(**vcase), None
    dargs = fixtures.paged_decode_args(case)
    yield "B6", lambda: t_pa.paged_decode_attention(**dargs), None
    scale = lin.scale.detach().clone().requires_grad_(True)  # a trainable scale
    yield "B3", lambda: t_i4.int4_matmul(torch.randn(2, 16), lin.q, scale), None


@pytest.mark.parametrize("i", range(10))
def test_kernel_wrappers_refuse_autograd(i):
    """Each attention kernel's wrapper raises under autograd when an input
    requires grad, naming the kernel, and so does B3 given a scale that
    requires grad; B3 given an x that requires grad (the wrapper, an int4
    base, LoRA over it) gives x's gradient of the plain backward.  Under
    ``no_grad`` every call runs."""
    name, call, grad = list(_refusals())[i]
    if grad is None:
        with pytest.raises(RuntimeError, match=name):
            call()
    else:
        x, lin = grad
        x.grad = None
        y = call()
        g = torch.randn_like(y)
        y.backward(g)
        want = t_i4.int4_matmul_grad_ref(g, lin.q, lin.scale, x.dtype)
        np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert torch.isfinite(call()).all()


def test_lora_over_int4_base_trains_adapters_in_forward_only():
    """Over an int4 base, A and B still get gradients when x needs none."""
    lin = t_linear.Int4Linear.from_dense(torch.randn(8, 16), 16)
    mod = t_linear.LoraLinear(lin, 2)
    mod.lora_A.requires_grad_(True)
    mod.lora_B.requires_grad_(True)
    with torch.no_grad():
        mod.lora_A.normal_()
    mod(torch.randn(3, 16)).square().sum().backward()
    assert mod.lora_B.grad is not None and mod.lora_B.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# inference after training
# ---------------------------------------------------------------------------

def test_chat_after_a_training_step(tmp_path):
    """A trained model (parameters that require grad) still chats: the
    inference paths run under no_grad, so no kernel wrapper refuses."""
    import visualcla_tpu_torch as vt
    from tests.test_api import make_native_ckpt
    from visualcla_tpu_torch.engine.sampling import SamplingConfig

    ckpt, _ = make_native_ckpt(str(tmp_path))
    bundle, tok, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    model, tc = bundle.model, bundle.config
    t_lora.add_lora(model, r=2, alpha=4.0, generator=torch.Generator().manual_seed(0))
    opt = t_trainer.make_optimizer(learning_rate=1e-2, schedule="const")
    train, frozen = t_trainer.partition_params(model, t_lora.lora_trainable)
    step = t_trainer.make_train_step_subset(model, tc, opt, t_lora.lora_trainable)
    rng = np.random.default_rng(0)
    size = tc.vision_config.image_size
    ids = rng.integers(5, tc.text_config.vocab_size, (1, 96))
    ids[0, 1] = tok.img_start_token_id
    batch = {"input_ids": ids, "attention_mask": np.ones_like(ids), "labels": ids,
             "img_start_pos": np.asarray([1]),
             "pixel_values": rng.standard_normal((1, 3, size, size)).astype(np.float32)}
    st, m = step(t_trainer.init_train_state(train, opt), frozen, batch)
    assert np.isfinite(float(m["loss"]))
    assert any(p.requires_grad for p in model.parameters())
    image = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    reply, _ = vt.chat(bundle, image, "你好", [], SamplingConfig.greedy(max_new_tokens=6),
                       verbose=False)
    assert isinstance(reply, str)
