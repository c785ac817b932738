"""Training on the card: the tiny fp32 model's stage-2 subset step on the
card against the same step on the CPU (TF32 off), remat on against off at
a 2-layer model of VisualCLA-7B's widths in fp32, and B3 under autograd:
the input gradient of ``int4_matmul`` (the forward through the kernel, the
backward ``Int4MatmulFn``'s dequantize and product) against
``int4_matmul_grad_ref`` at the 7B text tower's four carrier shapes and
T = 512.  Needs an NVIDIA GPU; skipped without.

On the machine with the card (which has no JAX, hence no conftest):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_train.py

Tolerances: card against CPU, loss and grad_norm rtol 1e-5, parameters
rtol 1e-5 / atol 1e-6 after a step at lr 1e-3; remat on against off, loss
rtol 1e-6 and parameters atol 1e-6 after two steps (fp32: only the
recompute's summation order may differ); B3's input gradient and output
within 1e-2 of the largest value (B3's tolerance: bf16 rounding of the
dequantized weight and of dY, another summation order)."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from visualcla_tpu_torch.core.config import tiny_visualcla_config, visualcla_config_for_size
from visualcla_tpu_torch.ops.cuda import int4_matmul as i4
from visualcla_tpu_torch.ops.quantization import quantize_grouped
from visualcla_tpu_torch.models.visualcla import VisualCLAModel, init_random_
from visualcla_tpu_torch.train.lora import add_lora, lora_trainable
from visualcla_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                               make_train_step_subset, partition_params)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def no_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, cfg.text_config.vocab_size, (B, S))
    labels = ids.copy()
    labels[:, :cfg.num_image_tokens + 4] = -100
    mask = np.ones((B, S), np.int64)
    mask[-1, -3:] = 0
    labels[-1, -3:] = -100
    size = cfg.vision_config.image_size
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "img_start_pos": np.full((B,), 1),
            "pixel_values": rng.standard_normal((B, 3, size, size)).astype(np.float32)}


def _lora_model(cfg, device, std=0.1):
    gen = torch.Generator().manual_seed(0)
    model = init_random_(VisualCLAModel(cfg, dtype=torch.float32), gen, std=std)
    add_lora(model, r=4, alpha=8.0, generator=gen)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("lora_B"):
                p.normal_(0.0, 0.05, generator=gen)
    return model.to(device)


def _steps(model, cfg, batch, n=1, remat=False):
    opt = make_optimizer(learning_rate=1e-3, schedule="const")
    train, frozen = partition_params(model, lora_trainable)
    step = make_train_step_subset(model, cfg, opt, lora_trainable, remat=remat)
    st = init_train_state(train, opt)
    metrics = []
    for _ in range(n):
        st, m = step(st, frozen, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach().cpu() for k, v in train.items()}


def test_stage2_step_on_the_card_equals_the_cpu():
    cfg = tiny_visualcla_config()
    cpu = _lora_model(cfg, "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    batch = _batch(cfg)
    (mc,), pc = _steps(cpu, cfg, batch)
    (mg,), pg = _steps(card, cfg, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(mg[k], mc[k], rtol=1e-5)
    for n in pc:
        torch.testing.assert_close(pg[n], pc[n], rtol=1e-5, atol=1e-6, msg=n)


def test_remat_equals_no_remat_at_full_width():
    """VisualCLA-7B's widths, two layers a tower, fp32."""
    full = visualcla_config_for_size("7B")
    cfg = dataclasses.replace(
        full,
        text_config=dataclasses.replace(full.text_config, num_hidden_layers=2),
        vision_config=dataclasses.replace(full.vision_config, num_hidden_layers=2),
        visual_resampler_config=dataclasses.replace(full.visual_resampler_config,
                                                    num_hidden_layers=2))
    model = _lora_model(cfg, "cuda", std=0.02)
    batch = _batch(cfg, B=1, S=128)
    state = copy.deepcopy(model.state_dict())
    ma, pa = _steps(model, cfg, batch, n=2)
    model.load_state_dict(state)
    mb, pb = _steps(model, cfg, batch, n=2, remat=True)
    for a, b in zip(ma, mb):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6)
    for n in pa:
        torch.testing.assert_close(pb[n], pa[n], rtol=0, atol=1e-6, msg=n)


B3_TOL = 1e-2


@pytest.mark.parametrize("shape", [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 49958)],
                         ids=["qkvo", "gate_up", "down", "head"])
def test_int4_input_grad_through_the_kernel(shape):
    """One B3 launch forward (bf16 out, fp32 for the head as the LM head
    runs it), then dX through ``Int4MatmulFn`` against the plain backward;
    the forward against the plain version."""
    in_dim, out = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    wq = quantize_grouped((torch.randn(in_dim, out, generator=gen, device="cuda") * 0.02)
                          .to(torch.bfloat16), group=128)
    q, s = wq["q"], wq["scale"]
    out_dtype = torch.float32 if out == 49958 else torch.bfloat16
    x = torch.randn(512, in_dim, generator=gen, device="cuda").to(torch.bfloat16)
    x.requires_grad_(True)
    g = torch.randn(512, out, generator=gen, device="cuda").to(out_dtype)
    before = sum(i4.LAUNCHES.values())
    y = i4.int4_matmul(x, q, s, out_dtype=out_dtype)
    assert sum(i4.LAUNCHES.values()) == before + 1
    assert y.requires_grad and y.dtype == out_dtype
    y.backward(g)
    assert sum(i4.LAUNCHES.values()) == before + 1  # the backward launches no B3
    for got, want in ((y, i4.int4_matmul_ref(x.detach().float(), q, s)),
                      (x.grad, i4.int4_matmul_grad_ref(g, q, s, torch.bfloat16))):
        want = want.float()
        err = float((got.float() - want).abs().max())
        assert torch.isfinite(got).all() and err <= B3_TOL * float(want.abs().max()), err
    assert x.grad.dtype == torch.bfloat16
