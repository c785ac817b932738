"""LoRA training in the PyTorch port against the JAX package, on the CPU in
fp32: ``add_lora`` (identity at init, A's scale), training that moves only
the adapters and the modules_to_save leaves, ``merge_lora`` (against the
adapter forward and JAX's merge, over dense and int8 bases),
``export_adapter`` key for key and value for value against JAX's, and the
exported adapter's round trip through the port's unmerged loader.

Tolerances: the merge and the round trip 1e-5 on logits (fp32); merged
weights against JAX's 1e-6; exported tensors bit for bit."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_train import (base_params, flat_np, lora_params, make_batch, port_model,
                                    qlora_base, t_cfg)
from visualcla_tpu.core.config import tiny_visualcla_config
from visualcla_tpu.train import lora as j_lora
from visualcla_tpu_torch.checkpoint import from_jax
from visualcla_tpu_torch.checkpoint.export import export_reference_merged
from visualcla_tpu_torch.models.visualcla import init_random_
from visualcla_tpu_torch.ops.linear import Int8Linear, Linear, LoraLinear
from visualcla_tpu_torch.train import lora as t_lora
from visualcla_tpu_torch.train import trainer as t_trainer

R, ALPHA = 4, 8.0
LOGIT_ATOL = 1e-5


@pytest.fixture(scope="module")
def cfg():
    return tiny_visualcla_config()


def _logits(model, cfg, batch):
    b = t_trainer.batch_to_device(model, batch)
    with torch.no_grad():
        return t_trainer.train_forward_logits(model, t_cfg(cfg), b["input_ids"],
                                              b["attention_mask"], b["img_start_pos"],
                                              b["pixel_values"]).numpy()


def test_add_lora_is_identity_at_init(cfg):
    params = base_params(cfg)
    batch = make_batch(cfg)
    base = _logits(port_model(params, cfg), cfg, batch)
    model = port_model(params, cfg)
    t_lora.add_lora(model, r=R, alpha=ALPHA, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(_logits(model, cfg, batch), base)  # B = 0
    for tower, targets in (("text", t_lora.TEXT_TARGETS), ("vision", t_lora.VISION_TARGETS)):
        for name in targets:
            mods = [getattr(layer, name) for layer in getattr(model, tower).layers]
            assert all(isinstance(m, LoraLinear) for m in mods)
            assert all(float(m.lora_scale) == ALPHA / R and not m.lora_B.any() for m in mods)
    # A ~ N(0, 1/fan_in): the text gate projection's draws, all layers
    a = torch.stack([layer.gate_proj.lora_A for layer in model.text.layers])
    fin = cfg.text_config.hidden_size
    assert abs(float(a.std()) * fin ** 0.5 - 1.0) < 0.2
    # the vision biases moved to the wrappers, values intact
    jb = np.asarray(params["vision"]["layers"]["q_bias"][0])
    np.testing.assert_array_equal(model.vision.layers[0].q_proj.bias.numpy(), jb)
    assert model.vision.layers[0].q_proj.base.bias is None


def test_lora_training_updates_only_adapters(cfg):
    params = base_params(cfg)
    model = port_model(params, cfg)
    t_lora.add_lora(model, r=R, alpha=ALPHA, generator=torch.Generator().manual_seed(1))
    batch = make_batch(cfg, seed=3, S=20, image=False)
    batch["labels"] = batch["input_ids"]
    opt = t_trainer.make_optimizer(learning_rate=5e-3, schedule="const")
    train, frozen = t_trainer.partition_params(model, t_lora.lora_trainable)
    step = t_trainer.make_train_step_subset(model, t_cfg(cfg), opt, t_lora.lora_trainable)
    st = t_trainer.init_train_state(train, opt)
    losses = []
    for _ in range(6):
        st, m = step(st, frozen, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    after = from_jax.params_to_jax(model)
    before = flat_np(params)
    np.testing.assert_array_equal(after["text/layers/q_proj/w"].numpy(),
                                  before["text/layers/q_proj"])
    np.testing.assert_array_equal(after["vision/layers/q_proj/w"].numpy(),
                                  before["vision/layers/q_proj"])
    assert after["text/layers/q_proj/lora_B"].any()
    assert not np.array_equal(after["text/embed_tokens"].numpy(), before["text/embed_tokens"])


def test_qlora_int8_base_stays_bitwise(cfg):
    """QLoRA: the int8 carriers and scales never move, the loss falls."""
    params = lora_params(qlora_base(base_params(cfg)))
    model = port_model(params, cfg)
    assert isinstance(model.text.layers[0].q_proj.base, Int8Linear)
    assert isinstance(model.text.lm_head, Linear)
    before = {k: v.clone() for k, v in from_jax.params_to_jax(model).items()}
    opt = t_trainer.make_optimizer(learning_rate=5e-3, schedule="const")
    train, frozen = t_trainer.partition_params(model, t_lora.lora_trainable)
    step = t_trainer.make_train_step_subset(model, t_cfg(cfg), opt, t_lora.lora_trainable,
                                            remat=True)
    st = t_trainer.init_train_state(train, opt)
    losses = []
    for _ in range(5):
        st, m = step(st, frozen, make_batch(cfg))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    after = from_jax.params_to_jax(model)
    for k in before:
        if k.endswith(("/w/q", "/w/scale")):
            assert after[k].dtype == before[k].dtype
            assert torch.equal(after[k], before[k]), k
        if k.endswith("lora_B"):
            assert not torch.equal(after[k], before[k]), k


@pytest.mark.parametrize("base", ["dense", "int8"])
def test_merge_lora_matches_adapter_forward_and_jax(cfg, base):
    params = base_params(cfg)
    params = lora_params(qlora_base(params) if base == "int8" else params, seed=2)
    batch = make_batch(cfg)
    model = port_model(params, cfg)
    out_l = _logits(model, cfg, batch)
    t_lora.merge_lora(model)
    assert isinstance(model.text.layers[0].q_proj, Linear)
    assert isinstance(model.vision.layers[0].fc1, Linear)
    np.testing.assert_allclose(_logits(model, cfg, batch), out_l, atol=LOGIT_ATOL)
    merged = flat_np(j_lora.merge_lora(params))
    got = from_jax.params_to_jax(model)
    for k in ("text/layers/q_proj", "text/layers/down_proj", "vision/layers/fc1",
              "vision/layers/q_bias"):
        np.testing.assert_allclose(got[k].numpy(), merged[k], atol=1e-6, err_msg=k)


def _lora_model_and_params(cfg, seed=4, vision=True):
    params = base_params(cfg)
    lp = j_lora.add_lora(params, r=R, alpha=ALPHA, rng=jax.random.PRNGKey(seed),
                         vision_targets=j_lora.VISION_TARGETS if vision else ())
    rng = np.random.default_rng(seed)
    for tower in ("text", "vision"):
        for node in lp[tower]["layers"].values():
            if isinstance(node, dict) and "lora_B" in node:
                node["lora_B"] = rng.standard_normal(node["lora_B"].shape).astype(np.float32) * 0.1
    return params, lp, port_model(lp, cfg)


@pytest.mark.parametrize("vision", [True, False], ids=["text_and_vision", "text_only"])
def test_export_adapter_matches_jax(cfg, tmp_path, vision):
    _, lp, model = _lora_model_and_params(cfg, vision=vision)
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_lora.export_adapter(lp, j_dir, r=R, alpha=ALPHA)
    t_lora.export_adapter(model, t_dir, r=R, alpha=ALPHA)
    j_sd = torch.load(os.path.join(j_dir, "adapter_model.bin"), weights_only=True)
    t_sd = torch.load(os.path.join(t_dir, "adapter_model.bin"), weights_only=True)
    assert list(t_sd) == list(j_sd)
    assert any("query_embeddding" in k for k in t_sd)
    for k in j_sd:
        assert t_sd[k].dtype == j_sd[k].dtype == torch.float32, k
        assert t_sd[k].is_contiguous()
        assert torch.equal(t_sd[k], j_sd[k]), k
    with open(os.path.join(j_dir, "adapter_config.json")) as f, \
            open(os.path.join(t_dir, "adapter_config.json")) as g:
        assert json.load(f) == json.load(g)


def test_exported_adapter_round_trips_through_the_unmerged_loader(cfg, tmp_path):
    """Base dirs exported from the untrained model plus the adapter of a
    trained one load (folded) to the merged model's logits."""
    import visualcla_tpu_torch as vt
    from tests.test_api import make_native_ckpt
    from visualcla_tpu_torch.checkpoint.serialize import load_checkpoint

    ckpt, _ = make_native_ckpt(str(tmp_path))
    base, tc = load_checkpoint(ckpt, device="cpu", dtype=torch.float32)
    ref_dir = str(tmp_path / "ref")
    export_reference_merged(base, tc, ref_dir, dtype="float32", side_files_from=ckpt)
    model, _ = load_checkpoint(ckpt, device="cpu", dtype=torch.float32)
    t_lora.add_lora(model, r=R, alpha=ALPHA, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # trained adapters and modules_to_save, as from a run
        for name, p in model.named_parameters():
            if name.endswith("lora_B") or name.startswith(("resampler.", "projection.")) \
                    or name in ("text.embed_tokens", "text.lm_head.weight"):
                p.add_(torch.randn(p.shape, generator=g) * 0.05)
    adapter = str(tmp_path / "adapter")
    t_lora.export_adapter(model, adapter, r=R, alpha=ALPHA)
    for name in ("tokenizer.model", "added_tokens.json", "config.json"):
        shutil.copy(os.path.join(ckpt, name), os.path.join(adapter, name))
    t_lora.merge_lora(model)
    bundle, _, _ = vt.get_model_and_tokenizer_and_processor(
        text_model=os.path.join(ref_dir, "text_encoder"),
        vision_model=os.path.join(ref_dir, "vision_encoder"), lora_model=adapter,
        dtype=torch.float32, device="cpu")
    batch = make_batch(cfg, S=20)
    batch["input_ids"] = batch["input_ids"] % tc.text_config.vocab_size
    np.testing.assert_allclose(_logits(bundle.model, tc, batch), _logits(model, tc, batch),
                               atol=LOGIT_ATOL)


def test_add_lora_in_bf16():
    """Adapters over a bf16 model come in the given dtype and shape."""
    from visualcla_tpu_torch.models.visualcla import VisualCLAModel

    model = VisualCLAModel(t_cfg(tiny_visualcla_config()), dtype=torch.bfloat16)
    init_random_(model, torch.Generator().manual_seed(0))
    t_lora.add_lora(model, r=2, generator=torch.Generator().manual_seed(0),
                    dtype=torch.bfloat16)
    mod = model.text.layers[1].v_proj
    assert mod.lora_A.dtype == mod.lora_B.dtype == torch.bfloat16
    assert mod.lora_A.shape == (2, model.text.cfg.hidden_size)
