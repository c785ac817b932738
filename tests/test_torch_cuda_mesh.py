"""The meshed path on the card: each kernel at the shard shapes of one rank of
a TP = 2, 4 and 8 7B against its plain version (B1 and B2 at 32/nm heads,
B2u's mesh form and the ViT at 16/nm heads, B3's two forms on the rank's
int4 carriers, B4 at 32/nm heads), and a world-size-1 NCCL mesh (a file
store, no network): a tiny fp32 model's meshed ``Engine.generate``,
speculative decoder and paged pool equal to the unmeshed ones, with the
collectives inside the captured graphs, and a data rank's sampled row
window keyed into those graphs.  Needs an NVIDIA GPU and nvcc; skipped
without.

On the machine with the card (which has no JAX, hence no conftest):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_mesh.py

Tolerance: atol = rtol = 2e-2 for bf16 kernels against their fp32 plain
versions; B3 1e-2 * max|ref| + 1e-2 * |ref|; ids token for token."""
import contextlib

import numpy as np
import pytest
import torch

from visualcla_tpu_torch.core.config import tiny_visualcla_config
from visualcla_tpu_torch.engine.generate import Engine
from visualcla_tpu_torch.engine.paged import PagedServingEngine
from visualcla_tpu_torch.engine.sampling import SamplingConfig
from visualcla_tpu_torch.engine.speculative import SpeculativeDecoder
from visualcla_tpu_torch.fixtures import paged_case
from visualcla_tpu_torch.models.visualcla import VisualCLAModel, init_random_
from visualcla_tpu_torch.ops.cuda import flash_attention as fa
from visualcla_tpu_torch.ops.cuda import int4_matmul as i4
from visualcla_tpu_torch.ops.cuda import paged_attention as pa
from visualcla_tpu_torch.ops.quantization import quantize_grouped

pytestmark = pytest.mark.cuda

TOL = 2e-2
B3_TOL = 1e-2
TP = (2, 4, 8)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def _close(out, ref, tol=TOL):
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out).all()
    assert bool((err <= tol + tol * ref.float().abs()).all()), err.max().item()


@pytest.mark.parametrize("nm", TP)
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_b1_b2_at_shard_heads(card, nm, kind):
    N, S, L = 32 // nm, 2048, 2
    Sq = 1 if kind == "decode" else 256
    q = _rnd(card, 1, Sq, N, 128)
    kc, vc = _rnd(card, L, 1, N, S, 128), _rnd(card, L, 1, N, S, 128)
    if kind == "decode":
        slot = torch.tensor([300], dtype=torch.int32, device="cuda")
        valid = torch.arange(S, device="cuda")[None] <= 300
        out = fa.flash_decode_stacked(q, kc, vc, valid, slot, 1)
        ref = fa.flash_decode_stacked_ref(q.float(), kc.float(), vc.float(), valid, slot, 1)
    else:
        valid = torch.arange(S, device="cuda")[None] < Sq
        out = fa.flash_prefill_stacked(q, kc, vc, valid, 0, 1)
        ref = fa.flash_prefill_stacked_ref(q.float(), kc.float(), vc.float(), valid, 0, 1)
    _close(out, ref)


@pytest.mark.parametrize("nm", TP)
def test_b2u_mesh_form_at_shard_heads(card, nm):
    N, B, Sq, S = 32 // nm, 2, 512, 2048
    slot = torch.tensor([100, 1000], dtype=torch.int32, device="cuda")
    valid = torch.arange(S, device="cuda")[None] < slot[:, None].long() + Sq
    valid[1, :300] = False
    q, k, v = _rnd(card, B, Sq, N, 128), _rnd(card, B, N, S, 128), _rnd(card, B, N, S, 128)
    out = fa.flash_attention(q, k, v, valid, slot, kv_layout="bnsh")
    ref = fa.flash_attention_ref(q.float(), k.float(), v.float(), valid, slot, kv_layout="bnsh")
    _close(out, ref)


@pytest.mark.parametrize("nm", TP)
def test_vit_at_shard_heads(card, nm):
    N, S = 16 // nm, 257
    q, k, v = (_rnd(card, 1, S, N, 64) for _ in range(3))
    valid = torch.ones(1, S, dtype=torch.bool, device="cuda")
    out = fa.flash_attention(q, k, v, valid, 0, causal=False)
    ref = fa.flash_attention_ref(q.float(), k.float(), v.float(), valid, 0, causal=False)
    _close(out, ref)


def _local_int4_shapes(nm):
    """One rank's (in, out) int4 carriers at the 7B shapes (chip_smoke's
    ``_tp_int4_shapes``): columns out/nm, rows in/nm in whole groups of 128,
    whole where the axis does not divide."""
    shapes = {"qkv": (4096, 4096), "gate_up": (4096, 11008), "o": (4096, 4096),
              "down": (11008, 4096), "lm_head": (4096, 49958)}
    out = {}
    for name, (i, o) in shapes.items():
        if name in ("o", "down"):
            out[name] = (i // nm, o) if (i // 128) % nm == 0 else (i, o)
        else:
            out[name] = (i, o // nm) if o % nm == 0 else (i, o)
    return out


@pytest.mark.parametrize("nm", TP)
@pytest.mark.parametrize("form", ["decode", "prefill"])
@pytest.mark.parametrize("T", [1, 512])
def test_b3_on_local_carriers(card, nm, form, T):
    for name, (in_dim, out) in _local_int4_shapes(nm).items():
        w = (torch.randn(in_dim, out, generator=card, device="cuda") * 0.02).to(torch.bfloat16)
        wq = quantize_grouped(w, group=128)
        x = _rnd(card, T, in_dim)
        y = i4._launch(x, wq["q"], wq["scale"], torch.float32, form=form)
        ref = i4.int4_matmul_ref(x.float(), wq["q"], wq["scale"])
        err = (y - ref).abs()
        assert bool((err <= B3_TOL * ref.abs().max() + B3_TOL * ref.abs()).all()), (name, err.max())


@pytest.mark.parametrize("nm", TP)
def test_b4_at_shard_heads(card, nm):
    N = 32 // nm
    case = paged_case([320, 383, 330, -1], N, N, L=4, layer=2, dtype=torch.bfloat16,
                      device="cuda", seed=nm)
    ref_case = {k: (v.clone() if k in ("k_pool", "v_pool") else v) for k, v in case.items()}
    out = pa.paged_append_attention(**case)
    ref = pa.paged_append_attention_ref(**ref_case)
    _close(out, ref)
    assert torch.equal(case["k_pool"][:, 1:], ref_case["k_pool"][:, 1:])


# ---------------------------------------------------------------------------
# world size 1 over NCCL
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(card, tmp_path_factory):
    import torch.distributed as dist

    from visualcla_tpu_torch.parallel import distributed
    from visualcla_tpu_torch.parallel.sharding import make_mesh

    store = tmp_path_factory.mktemp("nccl")
    distributed.initialize("cuda", init_method=f"file://{store}/store", world_size=1, rank=0)
    yield make_mesh(1, 1)
    dist.destroy_process_group()


def _tiny(seed=0):
    cfg = tiny_visualcla_config(vocab_size=512, hidden_size=512)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return init_random_(VisualCLAModel(cfg, device="cuda", dtype=torch.float32), gen,
                        std=0.1), cfg


def _prompt(B=2, n=20):
    rng = np.random.default_rng(1)
    return np.concatenate([rng.integers(3, 512, (B, n - 12)),
                           np.tile(rng.integers(3, 512, (B, 4)), 3)], axis=1)


def test_meshed_engine_and_speculative_equal_unmeshed(nccl_mesh):
    from visualcla_tpu_torch.parallel import tp

    plain, cfg = _tiny()
    meshed, _ = _tiny()
    g = SamplingConfig.greedy(16)
    want = Engine(plain, cfg, eos_token_id=1, max_seq_len=256)
    got = Engine(meshed, cfg, eos_token_id=1, max_seq_len=256, mesh=nccl_mesh)
    calls0 = dict(tp.CALLS)
    np.testing.assert_array_equal(got.generate(_prompt(), sampling=g),
                                  want.generate(_prompt(), sampling=g))
    assert tp.CALLS["all_reduce"] > calls0["all_reduce"]  # replays add the captured collectives
    assert got.graphs.captures > 0
    np.testing.assert_array_equal(SpeculativeDecoder(got, 3).generate(_prompt(1), sampling=g),
                                  SpeculativeDecoder(want, 3).generate(_prompt(1), sampling=g))


def test_meshed_paged_pool_equals_unmeshed(nccl_mesh):
    plain, cfg = _tiny(1)
    meshed, _ = _tiny(1)
    ids = _prompt(4)

    def run(model, mesh):
        eng = PagedServingEngine(model, cfg, eos_token_id=1, pad_token_id=0, pool_size=4,
                                 block_size=16, num_blocks=64, max_seq_len=256,
                                 max_new_tokens_cap=16, prompt_buckets=(32, 64),
                                 sampling=SamplingConfig.greedy(16), kv_quant="int8", mesh=mesh)
        for r in range(4):
            eng.prefill_row(r, ids[r], None, None, 16)
        eng.step_n(12)
        return [eng.collect_row(r).tolist() for r in range(4)]

    assert run(meshed, nccl_mesh) == run(plain, None)


@pytest.mark.parametrize("split_first", [True, False])
def test_row_window_keys_the_captured_graphs(nccl_mesh, split_first):
    """A data rank's sampled call (``global_rows``: its rows of the whole
    batch's noise, baked into the captured start and decode) and an unsplit
    call of the same local B on one meshed engine, in either order, each
    equal to the unmeshed engine's eager call of the same kind (eager: a
    graph that ignored the window would make the two alike); token for
    token."""
    from visualcla_tpu_torch.engine import graphs
    from visualcla_tpu_torch.engine.sampling import global_rows

    plain, cfg = _tiny(2)
    meshed, _ = _tiny(2)
    s = SamplingConfig(do_sample=True, temperature=0.8, top_k=40, top_p=0.9,
                       repetition_penalty=1.1, no_repeat_ngram_size=0, max_new_tokens=12)
    ids = _prompt(1)

    def run(eng, split):
        with (global_rows(2, 1) if split else contextlib.nullcontext()):
            return eng.generate(ids, sampling=s, seed=3)

    ref = Engine(plain, cfg, eos_token_id=1, max_seq_len=256)
    with graphs.eager():
        want = {split: run(ref, split) for split in (False, True)}
    assert want[False].tolist() != want[True].tolist()  # the windows draw apart
    eng = Engine(meshed, cfg, eos_token_id=1, max_seq_len=256, mesh=nccl_mesh)
    for split in ((True, False) if split_first else (False, True)):
        np.testing.assert_array_equal(run(eng, split), want[split])
    assert eng.graphs.captures > 0
