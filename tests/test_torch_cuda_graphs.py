"""The port's decode loops replayed from captured CUDA graphs against the same
chunks run eagerly (``graphs.eager()``), on the card: ``Engine.generate``
and ``stream``, the paged pool's ``step_n`` and ``spec_step_n``,
``SpeculativeDecoder`` and ``beam_generate_fused``, greedy and sampled (the
generators registered with the graphs draw what the eager chunks draw); a
second request of a key replays its graphs without capturing again; a chunk
that cannot be captured raises.  A tiny model (2 layers, 4 heads of 128) on
seeded random fp32 weights.  Needs an NVIDIA GPU and nvcc; skipped without.

On the machine with the card (which has no JAX, hence no conftest):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py

Tolerance: none; token for token (the same kernels in the same order)."""
import numpy as np
import pytest
import torch

from visualcla_tpu_torch.core.config import tiny_visualcla_config
from visualcla_tpu_torch.engine import beam as t_beam
from visualcla_tpu_torch.engine import graphs as t_graphs
from visualcla_tpu_torch.engine.generate import Engine
from visualcla_tpu_torch.engine.paged import PagedServingEngine
from visualcla_tpu_torch.engine.sampling import SamplingConfig
from visualcla_tpu_torch.engine.speculative import SpeculativeDecoder
from visualcla_tpu_torch.models.visualcla import VisualCLAModel, init_random_

pytestmark = pytest.mark.cuda

EOS = 1
SAMPLED = SamplingConfig(max_new_tokens=24)  # the reference's default sampled config
GREEDY = SamplingConfig.greedy(24)


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tiny_visualcla_config(vocab_size=512, hidden_size=512)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return init_random_(VisualCLAModel(cfg, device="cuda", dtype=torch.float32), gen,
                        std=0.1), cfg


def prompt(seed, n=20, B=1):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(3, 512, (B, n - 12)), np.tile(
        rng.integers(3, 512, (B, 4)), 3)], axis=1)  # a repeat: drafts get accepted


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("B", [1, 2])
def test_generate_and_stream(model, sampling, B):
    m, cfg = model
    eng = Engine(m, cfg, eos_token_id=EOS, max_seq_len=256)
    ids = prompt(B, B=B)
    out = eng.generate(ids, sampling=sampling, seed=3)
    captures = eng.graphs.captures
    assert captures >= 1
    with t_graphs.eager():
        assert eng.generate(ids, sampling=sampling, seed=3).tolist() == out.tolist()
    assert eng.generate(ids, sampling=sampling, seed=3).tolist() == out.tolist()
    assert eng.graphs.captures == captures  # the same key: its graphs replayed
    for k in (1, 4):
        streamed = np.stack(list(eng.stream(ids, sampling=sampling, seed=3, chunk_size=k)), 1)
        assert streamed.tolist() == out.tolist()


@pytest.mark.parametrize("spec_k", [0, 3], ids=["step_n", "spec_step_n"])
def test_pool(model, spec_k):
    """The same schedule on two pools of one seed, one replaying graphs and
    one eager: equal snapshots after every call; greedy and sampled rows."""
    m, cfg = model

    def pool():
        return PagedServingEngine(m, cfg, eos_token_id=EOS, pad_token_id=0, pool_size=3,
                                  block_size=16, num_blocks=48, max_seq_len=256,
                                  max_new_tokens_cap=24, prompt_buckets=(32, 64, 128, 256),
                                  sampling=GREEDY, spec_k=spec_k, seed=5)

    def run(eng):
        snaps = []
        eng.prefill_row(0, prompt(0)[0], None, None, 20)
        eng.prefill_row(1, prompt(1)[0], None, None, 13,
                        overrides={"do_sample": True, "top_k": 40, "temperature": 0.7})
        eng.prefill_row(2, prompt(2)[0], None, None, 7)
        for _ in range(12):
            (eng.spec_step_n if spec_k else eng.step_n)(4)
            snaps.append({k: v.tolist() for k, v in eng.snapshot().items()})
            snaps.append(eng.ctx_len.tolist())
        return snaps

    graphed = pool()
    got = run(graphed)
    with t_graphs.eager():
        want = run(pool())
    assert got == want
    assert graphed.graphs.captures >= 1 and graphed.graphs.replays >= 12


@pytest.mark.parametrize("sampling", [GREEDY, SAMPLED], ids=["greedy", "sampled"])
def test_speculative(model, sampling):
    m, cfg = model
    eng = Engine(m, cfg, eos_token_id=EOS, max_seq_len=256)
    dec = SpeculativeDecoder(eng, spec_k=4)
    out = dec.generate(prompt(7), sampling=sampling, seed=2)
    stats = dict(dec.last_stats)
    with t_graphs.eager():
        assert dec.generate(prompt(7), sampling=sampling, seed=2).tolist() == out.tolist()
    assert dec.last_stats == stats
    streamed = [int(t[0]) for t in dec.stream(prompt(7), sampling=sampling, seed=2)]
    assert streamed == out[0].tolist()


def test_beam_fused(model):
    m, cfg = model
    kw = dict(num_beams=4, max_new_tokens=12, eos_token_id=EOS, pad_token_id=0)
    stats = {}
    out = t_beam.beam_generate_fused(m, cfg, prompt(9), None, None, stats=stats, **kw)
    with t_graphs.eager():
        assert t_beam.beam_generate_fused(m, cfg, prompt(9), None, None, **kw).tolist() == \
            out.tolist()
    assert t_beam.beam_generate(m, cfg, prompt(9), None, None, **kw).tolist() == out.tolist()
    again = {}
    t_beam.beam_generate_fused(m, cfg, prompt(9), None, None, stats=again, **kw)
    assert again["captures"] == stats["captures"] == 1


def test_capture_failure_raises():
    """A chunk that reads a tensor back cannot be captured: the error comes
    out of ``Graphs.run``, and nothing runs the chunk eagerly instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros(4, device="cuda")
    ran = []

    def chunk():
        ran.append(float(x.sum().item()))

    graphs = t_graphs.Graphs()
    with pytest.raises(RuntimeError):
        graphs.run("bad", chunk, x.device)
    assert len(ran) == 1 and graphs.captures == 0  # the warm-up only
    torch.cuda.synchronize()
