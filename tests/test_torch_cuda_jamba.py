"""Kernels B7 (grouped int4 expert products) and B8 (Mamba's conv and
selective scan, chunk and step forms) against their plain PyTorch versions
on the card, and a Jamba tower served by the paged pool captured against
eager.  Needs an NVIDIA GPU and nvcc; skipped without them.

On the machine with the card:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_jamba.py

Tolerances: B7 writes f32 here and sums the same exact-nibble products as
its plain version in another order (the mma's): |err| <= 1e-4 * max|ref|.
B8 computes in f32 from bf16 inputs as its plain version does; its bf16
outputs are held to one bf16 rounding (2e-2 relative to the largest) and
its f32 states to 1e-4 of their largest (exp and softplus differ by ulps);
states the step form must leave alone are compared bit for bit.
"""
from __future__ import annotations

import math

import pytest
import torch

from visualcla_tpu_torch.ops.cuda import moe_int4 as b7
from visualcla_tpu_torch.ops.cuda import selective_scan as b8
from visualcla_tpu_torch.ops.quantization import quantize_grouped

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def experts(dev, E, K, N, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(E, K, N, generator=g, device=dev) * 0.02
    parts = [quantize_grouped(w[e], group=128) for e in range(E)]
    return (torch.stack([p["q"] for p in parts]).contiguous(),
            torch.stack([p["scale"] for p in parts]).contiguous())


def offsets_of(counts, dev):
    c = torch.as_tensor(counts, dtype=torch.int32, device=dev)
    return torch.nn.functional.pad(torch.cumsum(c, 0, dtype=torch.int32), (1, 0))


@pytest.mark.parametrize("K,N,counts,tile", [
    (4096, 28672, [5, 0, 9, 3, 0, 0, 17, 2, 4, 1, 8, 0, 6, 3, 2, 4], 16),  # decode: 64
    (14336, 4096, [5, 0, 9, 3, 0, 0, 17, 2, 4, 1, 8, 0, 6, 3, 2, 4], 16),
    (4096, 28672, [70, 0, 31, 1, 64, 65, 20, 15, 40, 30, 90, 60, 44, 33, 22, 27], 64),
    (14336, 4096, [70, 0, 31, 1, 64, 65, 20, 15, 40, 30, 90, 60, 44, 33, 22, 27], 64)])
def test_b7_matches_its_plain_version(dev, K, N, counts, tile):
    E = len(counts)
    q, s = experts(dev, E, K, N)
    offs = offsets_of(counts, dev)
    A = sum(counts)
    x = (torch.randn(A, K, device=dev) * 0.5).to(torch.bfloat16)
    got = b7.moe_int4_matmul(x, q, s, offs, max(counts), out_dtype=torch.float32, tile=tile)
    torch.cuda.synchronize()
    want = b7.moe_int4_matmul_ref(x.cpu(), q.cpu(), s.cpu(), offs.cpu(),
                                  out_dtype=torch.float32).to(dev)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    again = b7.moe_int4_matmul(x, q, s, offs, max(counts), out_dtype=torch.float32, tile=tile)
    assert torch.equal(got, again)  # a fixed sum order
    bf = b7.moe_int4_matmul(x, q, s, offs, max(counts), tile=tile)
    assert torch.equal(bf, got.to(torch.bfloat16))


def test_b7_skips_the_rows_routed_to_no_expert(dev):
    """Assignments past offsets[E] (the MoE's sentinel: padding, rows that do
    not run) are computed by no block; the routed rows equal a call over
    them alone."""
    counts = [3, 0, 5, 2]
    q, s = experts(dev, 4, 4096, 28672, seed=1)
    offs = offsets_of(counts, dev)
    x = (torch.randn(sum(counts) + 22, 4096, device=dev) * 0.5).to(torch.bfloat16)
    got = b7.moe_int4_matmul(x, q, s, offs, 16, out_dtype=torch.float32)
    alone = b7.moe_int4_matmul(x[:sum(counts)].contiguous(), q, s, offs, 16,
                               out_dtype=torch.float32)
    assert got.shape[0] == x.shape[0] and torch.equal(got[:sum(counts)], alone)


def mamba_inputs(dev, B, W, D=8192, N=16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, std=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * std).to(torch.bfloat16)

    xz = r(B, W, 2 * D)
    dt = torch.exp(torch.rand(D, generator=g, device=dev) * math.log(100.0) + math.log(1e-3))
    return dict(x=xz[..., :D], z=xz[..., D:], w=r(D, 4, std=0.5), bias=r(D, std=0.1),
                dt=r(B, W, D, std=0.5),
                dt_bias=(dt + torch.log(-torch.expm1(-dt))).to(torch.bfloat16),
                A_log=(torch.log(torch.arange(1, N + 1, device=dev).float()).expand(D, N)
                       + torch.randn(D, N, generator=g, device=dev) * 0.1).to(torch.bfloat16),
                Bm=r(B, W, N), Cm=r(B, W, N), Dsk=r(D, std=1.0),
                conv=r(B, D, 3), ssm=torch.randn(B, D, N, generator=g, device=dev))


def scan_args(i, at=slice(None)):
    """(dt, dt_bias, A_log, B, C, D, z) of ``mamba_inputs``, positions ``at``."""
    return (i["dt"][:, at], i["dt_bias"], i["A_log"], i["Bm"][:, at], i["Cm"][:, at], i["Dsk"],
            i["z"][:, at])


def close(a, b, rel):
    return (a.float() - b.float()).abs().max() <= rel * b.float().abs().max()


@pytest.mark.parametrize("lens", [[256], [200], [3], [1]])
def test_b8_chunk_matches_its_plain_version(dev, lens):
    i = mamba_inputs(dev, 1, 256)
    n = torch.tensor(lens, device=dev)
    conv, ssm = i["conv"].clone(), i["ssm"].clone()
    u = b8.conv_chunk(i["x"], i["w"], i["bias"], conv, n)
    y = b8.scan_chunk(u, *scan_args(i), ssm, n)
    torch.cuda.synchronize()
    c = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in i.items()}
    conv_r, ssm_r = c["conv"].clone(), c["ssm"].clone()
    u_r = b8.conv_chunk_ref(c["x"], c["w"], c["bias"], conv_r, n.cpu())
    y_r = b8.scan_ref(u.cpu(), *scan_args(c), ssm_r, n.cpu())
    L = lens[0]
    assert close(u.cpu()[:, :L], u_r[:, :L], 2e-2) and torch.equal(conv.cpu(), conv_r)
    assert close(y.cpu()[:, :L], y_r[:, :L], 2e-2) and close(ssm.cpu(), ssm_r, 1e-4)


def test_b8_chunks_chain(dev):
    """Two 128-wide chunks equal one 256-wide one (states and outputs)."""
    i = mamba_inputs(dev, 1, 256, seed=3)
    n = torch.tensor([256], device=dev)
    conv, ssm = i["conv"].clone(), i["ssm"].clone()
    u = b8.conv_chunk(i["x"], i["w"], i["bias"], conv, n)
    y = b8.scan_chunk(u, *scan_args(i), ssm, n)
    conv2, ssm2 = i["conv"].clone(), i["ssm"].clone()
    half = torch.tensor([128], device=dev)
    ys = []
    for a in (0, 128):
        sl = slice(a, a + 128)
        uu = b8.conv_chunk(i["x"][:, sl], i["w"], i["bias"], conv2, half)
        ys.append(b8.scan_chunk(uu, *scan_args(i, sl), ssm2, half))
    assert torch.equal(conv, conv2) and torch.equal(ssm, ssm2)
    assert torch.equal(y, torch.cat(ys, 1))


def test_b8_step_runs_the_running_rows_only(dev):
    B = 32
    i = mamba_inputs(dev, B, 1, seed=5)
    run = torch.zeros(B, dtype=torch.bool, device=dev)
    run[::3] = True
    conv, ssm = i["conv"].clone(), i["ssm"].clone()
    u = b8.conv_step(i["x"][:, 0], i["w"], i["bias"], conv, run)
    y = b8.scan_step(u, *scan_args(i, 0), ssm, run)
    torch.cuda.synchronize()
    c = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in i.items()}
    conv_r, ssm_r = c["conv"].clone(), c["ssm"].clone()
    u_r = b8.conv_step_ref(c["x"][:, 0], c["w"], c["bias"], conv_r, run.cpu())
    y_r = b8.scan_step(u.cpu(), *scan_args(c, 0), ssm_r, run.cpu())
    r = run.cpu()
    assert close(u.cpu()[r], u_r[r], 2e-2) and close(y.cpu()[r], y_r[r], 2e-2)
    assert torch.equal(conv.cpu(), conv_r) and close(ssm.cpu(), ssm_r, 1e-4)
    assert torch.equal(conv[~run], i["conv"][~run]) and torch.equal(ssm[~run], i["ssm"][~run])


def test_jamba_pool_captured_equals_eager(dev):
    """A small int4 Jamba tower served by the paged pool: admissions (one-shot
    and chunked) and decode chunks replayed from graphs give the eager run's
    tokens and Mamba states bit for bit, and launch B7 and B8."""
    import dataclasses

    from visualcla_tpu_torch.checkpoint.jamba import load_text_
    from visualcla_tpu_torch.core.config import JambaConfig, tiny_visualcla_config
    from visualcla_tpu_torch.engine import graphs
    from visualcla_tpu_torch.engine.paged import PagedServingEngine
    from visualcla_tpu_torch.engine.sampling import SamplingConfig
    from visualcla_tpu_torch.models.visualcla import VisualCLAModel
    from tests.test_torch_jamba import hf_weights

    hf = dict(vocab_size=256, hidden_size=512, intermediate_size=256, num_hidden_layers=4,
              num_attention_heads=4, num_key_value_heads=2, attn_layer_period=4,
              attn_layer_offset=1, expert_layer_period=2, expert_layer_offset=1, num_experts=4,
              num_experts_per_tok=2, mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
              mamba_dt_rank=16, mamba_conv_bias=True, mamba_proj_bias=False, rms_norm_eps=1e-6,
              tie_word_embeddings=False, hidden_act="silu")
    weights = hf_weights(hf, 3)

    def engine():
        cfg = dataclasses.replace(tiny_visualcla_config(vocab_size=256, hidden_size=512),
                                  text_config=JambaConfig.from_hf_dict({**hf,
                                                                        "model_type": "jamba"}))
        model = VisualCLAModel(cfg, dtype=torch.bfloat16, device=dev, quant="int4")
        load_text_(model.text, {k: v.clone() for k, v in weights.items()})
        return PagedServingEngine(model, cfg, eos_token_id=300, pad_token_id=0, pool_size=4,
                                  block_size=64, num_blocks=64, max_seq_len=512,
                                  sampling=SamplingConfig.greedy(64), kv_quant="int8", seed=5)

    g = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, 256, (n,), generator=g).numpy() for n in (300, 70, 150)]

    def drive(eng):
        eng.prefill_row(0, prompts[0], None, None, 40)
        eng.step_n(4)
        p = eng.begin_prefill(1, prompts[1], None, None, 40, chunk=64)
        while not p.step():
            eng.step_n(2)
        eng.prefill_row(2, prompts[2], None, None, 40)
        eng.step_n(8)
        snap = eng.snapshot()
        s = eng._state
        return snap["gen_ids"], s.rows["conv"].clone(), s.rows["ssm"].clone()

    b7.reset_launch_counts()
    b8.reset_launch_counts()
    captured = drive(engine())
    assert b7.LAUNCHES["moe_int4_matmul"] > 0 and b8.LAUNCHES["selective_scan_step"] > 0
    with graphs.eager():
        eager = drive(engine())
    for a, b in zip(captured, eager):
        assert (a == b).all()
