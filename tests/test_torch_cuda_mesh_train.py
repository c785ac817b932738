"""Training over a mesh on the card, at a small size (``chip_smoke.py`` phase
14's checks): a world-size-1 NCCL group (a file store, no network) and
meshes of size 1 on every axis.  The pipeline's cached form on a bf16
2-layer text tower with 128-wide heads: n_micro 1 bitwise ``Llama.forward``
and n_micro 2 bitwise two B = 1 runs (hidden states and cache, bf16 and
int8 caches), with exactly 2 x M B2 launches a prefill and 2 x M B1
launches a step; and a tiny fp32 stage-2 LoRA step on a (data 1, model 1)
mesh, with FSDP, and over a (pipe 1, data 1) pipeline at n_micro 2, each
against the unmeshed step.  Needs an NVIDIA GPU and nvcc; skipped without.

On the machine with the card (which has no JAX, hence no conftest):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mesh_train.py

Tolerances: the cached form bitwise; the fp32 steps' loss and grad_norm
rtol 1e-5 and parameters atol 1e-6 (TF32 off; the loss and the norm sum
their pieces in another grouping)."""
import dataclasses

import numpy as np
import pytest
import torch

from visualcla_tpu_torch.core.config import tiny_visualcla_config
from visualcla_tpu_torch.models import llama
from visualcla_tpu_torch.models.visualcla import VisualCLAModel, init_random_
from visualcla_tpu_torch.ops.cuda import flash_attention as fa

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def nccl(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from visualcla_tpu_torch.parallel import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    store = tmp_path_factory.mktemp("nccl")
    distributed.initialize("cuda", init_method=f"file://{store}/store", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def _passes(text, tc, embeds, kv_quant, mesh=None, M=1, steps=4):
    from visualcla_tpu_torch.parallel import pipeline as pp

    B, S0, smax = embeds.shape[0], 64, 128
    cache = (llama.init_kv_cache(tc, B, smax, torch.bfloat16, device="cuda", kv_quant=kv_quant)
             if mesh is None else
             pp.pipeline_kv_cache(tc, B, smax, torch.bfloat16, mesh, kv_quant=kv_quant))
    valid = torch.zeros(B, smax, dtype=torch.bool, device="cuda")
    valid[:, :S0] = True
    hs, counts = [], []
    with torch.no_grad():
        for t in range(steps + 1):
            n = S0 if t == 0 else 1
            start = 0 if t == 0 else S0 + t - 1
            if t:
                valid = valid.clone()
                valid[:, start] = True
            pos = torch.arange(start, start + n, device="cuda")[None].expand(B, n)
            fa.reset_launch_counts()
            e = embeds[:, start:start + n]
            if mesh is None:
                h, _ = text(e, pos, cache, valid, start)
            else:
                h, _ = pp.pipeline_forward(text, tc, e, pos, cache, valid, start, mesh, n_micro=M)
            hs.append(h)
            counts.append({k: v for k, v in fa.LAUNCHES.items() if v})
    return hs, cache, counts


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("M", [1, 2])
def test_pipeline_cached_form_bitwise(nccl, kv_quant, M):
    from visualcla_tpu_torch.parallel import pipeline as pp

    tc = dataclasses.replace(tiny_visualcla_config(hidden_size=512).text_config,
                             num_hidden_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    text = init_random_(llama.Llama(tc, device="cuda", dtype=torch.bfloat16), gen)
    mesh = pp.make_pipe_mesh(1, 1)
    pp.shard_text_params(text, mesh)
    ids = torch.randint(5, tc.vocab_size, (2, 72), generator=gen, device="cuda")
    with torch.no_grad():
        embeds = text.embed(ids)
    hp, cp, counts = _passes(text, tc, embeds, kv_quant, mesh, M)
    if M == 1:
        hw, cw, _ = _passes(text, tc, embeds, kv_quant)
    else:
        rows = [_passes(text, tc, embeds[r:r + 1], kv_quant) for r in range(2)]
        hw = [torch.cat([a, b]) for a, b in zip(rows[0][0], rows[1][0])]
        cw = {k: torch.cat([rows[0][1][k], rows[1][1][k]], dim=1) for k in rows[0][1]}
    for a, b in zip(hp, hw):
        assert torch.equal(a, b)
    for k in cw:
        assert torch.equal(cp[k], cw[k]), k
    sfx = "_kv8" if kv_quant == "int8" else ""
    assert counts[0] == {f"flash_prefill{sfx}": 2 * M}
    assert all(c == {f"flash_decode{sfx}": 2 * M} for c in counts[1:])


def _model():
    from visualcla_tpu_torch.train.lora import add_lora

    cfg = tiny_visualcla_config()
    gen = torch.Generator().manual_seed(0)
    model = init_random_(VisualCLAModel(cfg, dtype=torch.float32), gen, std=0.1)
    add_lora(model, r=4, alpha=8.0, generator=gen)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("lora_B"):
                p.normal_(0.0, 0.05, generator=gen)
    return model.to("cuda"), cfg


def _batch(cfg, B):
    rng = np.random.default_rng(0)
    ids = rng.integers(5, cfg.text_config.vocab_size, (B, 24))
    labels = ids.copy()
    labels[:, :cfg.num_image_tokens + 4] = -100
    size = cfg.vision_config.image_size
    return {"input_ids": ids, "attention_mask": np.ones((B, 24), np.int64), "labels": labels,
            "img_start_pos": np.ones(B, np.int64),
            "pixel_values": rng.standard_normal((B, 3, size, size)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["mesh", "fsdp", "pipeline"])
def test_meshed_steps_match_unmeshed(nccl, kind):
    from visualcla_tpu_torch.parallel import pipeline as pp
    from visualcla_tpu_torch.parallel.sharding import make_mesh, shard_params
    from visualcla_tpu_torch.train.lora import lora_trainable
    from visualcla_tpu_torch.train.trainer import (init_train_state, make_optimizer,
                                                   make_train_step_subset, partition_params)

    out = []
    for meshed in (False, True):
        model, cfg = _model()
        pipe = None
        if meshed and kind == "pipeline":
            pipe = pp.make_pipe_mesh(1, 1)
            pp.shard_text_params(model, pipe)
        elif meshed:
            shard_params(model, make_mesh(1, 1), fsdp=kind == "fsdp")
        opt = make_optimizer(learning_rate=1e-3, schedule="const")
        train, frozen = partition_params(model, lora_trainable)
        step = make_train_step_subset(model, cfg, opt, lora_trainable, remat=True,
                                      pipeline_mesh=pipe, n_micro=2)
        state = init_train_state(train, opt)
        metrics = []
        for _ in range(2):
            state, m = step(state, frozen, _batch(cfg, 2))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out.append((metrics, {n: p.detach().cpu() for n, p in state.params.items()}))
    (m0, p0), (m1, p1) = out
    np.testing.assert_allclose(m1, m0, rtol=RTOL)
    for n in p0:
        np.testing.assert_allclose(p1[n].numpy(), p0[n].numpy(), atol=ATOL, err_msg=n)
