"""The port's decode loops replayed from captured CUDA graphs against the same
chunks run eagerly (``graphs.eager()``), on the card: ``Engine.generate``
and ``stream``, the paged pool's ``step_n``, ``spec_step_n`` and admissions, the
contiguous pool's ``prefill_row`` and ``step_n``, ``SpeculativeDecoder`` and
``beam_generate_fused``, greedy and sampled (the generators registered with
the graphs draw what the eager chunks draw); the captured ``Engine.start``
with an image and ``VisionPipeline``'s captured encode; a second request of
a key replays its graphs without capturing again; a capture in one thread
while another replays; a chunk that cannot be captured raises.  A tiny model (2 layers, 4 heads of 128) on
seeded random fp32 weights.  Needs an NVIDIA GPU and nvcc; skipped without.

On the machine with the card (which has no JAX, hence no conftest):
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_graphs.py

Tolerance: none; token for token (the same kernels in the same order); the
captured encode's fp32 embeddings within 1e-5 of the eager ones."""
import numpy as np
import pytest
import torch

from visualcla_tpu_torch.core.config import tiny_visualcla_config
from visualcla_tpu_torch.engine import beam as t_beam
from visualcla_tpu_torch.engine import graphs as t_graphs
from visualcla_tpu_torch.engine.generate import Engine
from visualcla_tpu_torch.engine.paged import PagedServingEngine
from visualcla_tpu_torch.engine.sampling import SamplingConfig
from visualcla_tpu_torch.engine.server import ServingEngine
from visualcla_tpu_torch.engine.speculative import SpeculativeDecoder
from visualcla_tpu_torch.models.visualcla import VisualCLAModel, encode_image, init_random_
from visualcla_tpu_torch.pipeline import VisionPipeline

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


def test_pool_admissions(model):
    """The paged pool's admissions replayed (encode, tower chunks, scatter,
    first token) against the same calls under ``graphs.eager()``: equal
    snapshots after every call.  In bucket 128: one-shot and chunked (32
    tokens a chunk), greedy and sampled, prompts of 100, 76 (with an image:
    its chunks stop at slot 96) and 90 tokens, a one-shot admission while a
    chunked one is part way, a row re-admitted with a 110-token prompt.  A
    second round of the same calls captures nothing and replays every
    stage."""
    m, cfg = model
    s = cfg.vision_config.image_size
    pix = np.random.default_rng(4).standard_normal((1, 3, s, s)).astype(np.float32)
    with_image = prompt(11, n=76)[0]
    sampled = {"do_sample": True, "top_k": 40, "temperature": 0.7}

    def pool():
        return PagedServingEngine(m, cfg, eos_token_id=EOS, pad_token_id=0, pool_size=3,
                                  block_size=16, num_blocks=64, max_seq_len=256,
                                  max_new_tokens_cap=24, prompt_buckets=(32, 64, 128, 256),
                                  sampling=GREEDY, seed=5)

    def run(eng):
        snaps, rounds = [], []

        def snap():
            snaps.append({k: v.tolist() for k, v in eng.snapshot().items()})
            snaps.append(eng.ctx_len.tolist())

        for _ in range(2):
            c0 = dict(eng.counts)
            eng.prefill_row(0, prompt(0, n=100)[0], None, None, 20)
            snap()
            pending = eng.begin_prefill(1, with_image, pix, 2, 13, overrides=sampled, chunk=32)
            stage = 0
            while not pending.step():
                if stage == 1:
                    eng.prefill_row(2, prompt(2, n=90)[0], None, None, 7, overrides=sampled)
                eng.step()
                snap()
                stage += 1
            for _ in range(3):
                eng.step_n(4)
                snap()
            eng.release_rows([2])
            pending = eng.begin_prefill(2, prompt(3, n=110)[0], None, None, 9, chunk=32)
            while not pending.step():
                eng.step()
                snap()
            for _ in range(6):
                eng.step_n(4)
                snap()
            eng.release_rows([0, 1, 2])
            rounds.append((eng.graphs.captures,
                           *(eng.counts[k] - c0[k] for k in ("admit_stages", "admit_replays"))))
        return snaps, rounds

    graphed = pool()
    got, rounds = run(graphed)
    with t_graphs.eager():
        want, eager_rounds = run(pool())
    assert got == want
    (captures1, _, _), (captures2, stages2, replays2) = rounds
    assert captures2 == captures1 and replays2 == stages2 == 4 + 6 + 4 + 7
    assert all(r[2] == 0 for r in eager_rounds)


def test_contiguous_pool(model):
    """The contiguous pool, captured (admissions and chunks) against eager:
    equal snapshots after every call; three rows admitted through one
    admission graph, greedy and sampled rows, a row re-admitted."""
    m, cfg = model

    def pool():
        return ServingEngine(m, cfg, eos_token_id=EOS, pad_token_id=0, pool_size=3,
                             max_seq_len=256, max_new_tokens_cap=24, prompt_buckets=(32, 64),
                             sampling=GREEDY, seed=5)

    def run(eng):
        snaps = []
        eng.prefill_row(0, prompt(0)[0], None, None, 20)
        eng.prefill_row(1, prompt(1)[0], None, None, 13,
                        overrides={"do_sample": True, "top_k": 40, "temperature": 0.7})
        eng.prefill_row(2, prompt(2)[0], None, None, 7)
        for i in range(12):
            eng.step_n(4)
            snap = eng.snapshot()
            snaps.append({k: v.tolist() for k, v in snap.items()})
            if i == 3:
                eng.release_rows([2])
                eng.prefill_row(2, prompt(3)[0], None, None, 9)
        return snaps

    graphed = pool()
    got = run(graphed)
    with t_graphs.eager():
        want = run(pool())
    assert got == want
    # one graph for the admissions of one bucket and flags, one a decode key
    assert graphed.graphs.captures <= 4 and graphed.decode_steps > 0


def test_start_and_encode_captured(model):
    """``Engine.start`` with an image (encode, splice, prefill, first sample
    in one graph) and ``VisionPipeline.embed_images`` replayed equal their
    eager runs; a second call of a key captures nothing."""
    m, cfg = model
    s = cfg.vision_config.image_size
    pix = np.random.default_rng(4).standard_normal((1, 3, s, s)).astype(np.float32)
    ids = prompt(11, n=cfg.num_image_tokens + 12)
    ids[0, 2] = 5  # a marker position: its image tokens follow
    eng = Engine(m, cfg, eos_token_id=EOS, max_seq_len=256)
    out = eng.generate(ids, pix, np.array([2]), SAMPLED, seed=1)
    captures = eng.graphs.captures
    with t_graphs.eager():
        assert eng.generate(ids, pix, np.array([2]), SAMPLED, seed=1).tolist() == out.tolist()
    assert eng.generate(ids, pix, np.array([2]), SAMPLED, seed=1).tolist() == out.tolist()
    assert eng.graphs.captures == captures
    pipe = VisionPipeline(m, cfg)
    px = np.random.default_rng(5).standard_normal((2, 3, s, s)).astype(np.float32)
    got = pipe.encode(px)
    want = encode_image(m, cfg, torch.as_tensor(px, device="cuda"))
    # (cuBLAS may pick another algorithm under capture: fp32 within 1e-5)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pipe.encode(px), got, atol=0, rtol=0)
    assert pipe.encode.graphs.captures == 1


def test_capture_overlaps_replay(model):
    """One thread replays an engine's graphs while another captures new keys
    on a second engine: every call's ids equal its sequential run's."""
    import threading

    m, cfg = model
    a, b = (Engine(m, cfg, eos_token_id=EOS, max_seq_len=256) for _ in range(2))
    ids = [prompt(20 + k, B=k + 1) for k in range(4)]  # each B: new workspaces, captures
    want_a = a.generate(ids[0], sampling=SAMPLED, seed=4).tolist()
    want_b = [Engine(m, cfg, eos_token_id=EOS, max_seq_len=256).generate(
        x, sampling=SAMPLED, seed=4).tolist() for x in ids]
    got_a, got_b, errors = [], [], []

    def replays():
        try:
            for _ in range(8):
                got_a.append(a.generate(ids[0], sampling=SAMPLED, seed=4).tolist())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def captures():
        try:
            for x in ids:
                got_b.append(b.generate(x, sampling=SAMPLED, seed=4).tolist())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=replays), threading.Thread(target=captures)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert got_a == [want_a] * 8 and got_b == want_b
    assert b.graphs.captures >= 8  # a start and a decode graph for each B


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
