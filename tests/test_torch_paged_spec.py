"""Speculative decoding inside the paged pool, and the paged kernels B5
(verify) and B6 (decode without an append), in the PyTorch port against the
JAX package on the CPU.

Tolerances: B5's and B6's plain versions against the Pallas kernels in
interpret mode within 1e-5 on f32 inputs (another summation order; an int8
pool rounds to bf16 at the same points in both), one bf16 step (1e-2) on
bf16 inputs whose output is bf16; pools bitwise outside the dummy block 0.
Engines token for token in fp32: against the JAX spec pool and against the
port's plain pool, since acceptance is checked against the model's own
argmax chain and a wrong draft never changes a greedy row's tokens."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu.engine import server as j_server
from visualcla_tpu.engine.paged import PagedServingEngine as JPaged
from visualcla_tpu.engine.paged_spec import draft_all_rows as j_draft_all_rows
from visualcla_tpu.ops.pallas.paged_attention import paged_decode_attention as j_b6
from visualcla_tpu.ops.pallas.paged_attention import paged_verify_attention as j_b5
from visualcla_tpu_torch.engine import paged_spec as t_spec
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.engine import server as t_server
from visualcla_tpu_torch.engine.paged import PagedServingEngine as TPaged
from visualcla_tpu_torch.fixtures import paged_case, paged_decode_args, paged_verify_case
from visualcla_tpu_torch.ops.cuda import paged_attention as pa

POOL_KEYS = ("k_pool", "v_pool", "k_scales", "v_scales")


def to_jax(v):
    if not isinstance(v, torch.Tensor):
        return v
    if v.dtype == torch.bfloat16:
        return jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(v.numpy())


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


# ---------------------------------------------------------------------------
# B5's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

B5_POOLS = {"f32": (torch.float32, False, 1e-5), "bf16": (torch.bfloat16, False, 1e-2),
            "int8": (torch.float32, True, 1e-5)}


@pytest.mark.parametrize("pool", list(B5_POOLS))
@pytest.mark.parametrize("N,Nkv", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("Sq", [3, 5])
def test_b5_plain_matches_pallas_interpret(pool, N, Nkv, Sq):
    dtype, kv_int8, tol = B5_POOLS[pool]
    BS = 16
    # rows: two blocks of context, a parked row, an append that straddles a
    # block edge, an empty context, a context ending at a block edge
    ctx = [2 * BS, -1, 3 * BS - 2, 0, BS]
    case = paged_verify_case(ctx, Sq, N, Nkv, hd=32, block_size=BS, L=3, layer=2,
                             dtype=dtype, kv_int8=kv_int8, seed=Sq * 10 + N + Nkv)
    j = {k: to_jax(v) for k, v in case.items()}
    jo, *jpools = j_b5(j["q"], j["k_new"], j["v_new"], j["k_pool"], j["v_pool"], j["tables"],
                       j["lens"], jnp.int32(case["layer"]), j.get("k_new_scales"),
                       j.get("v_new_scales"), j.get("k_scales"), j.get("v_scales"),
                       interpret=True)
    pa.reset_launch_counts()
    out = pa.paged_verify_attention(**case)  # CPU tensors: the plain version
    assert not any(pa.LAUNCHES.values())
    assert out.shape == case["q"].shape and out.dtype == dtype
    running = [b for b, c in enumerate(ctx) if c >= 0]  # parked rows' outputs are dropped
    np.testing.assert_allclose(as_f32(out)[running], as_f32(jo)[running], atol=tol, rtol=tol)
    for name, want in zip(POOL_KEYS, jpools):
        if want is not None:  # block 0 is the dummy every parked row writes
            np.testing.assert_array_equal(as_f32(case[name])[:, 1:], as_f32(want)[:, 1:],
                                          err_msg=name)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32_pool", "int8_pool"])
def test_b5_appends_only_its_slots(kv_int8):
    """Outside block 0, the call changes exactly the running rows' Sq append
    slots of the one layer, to the new tokens (a block-split append
    included), and the output equals Sq sequential B4 appends."""
    BS, Sq, N, Nkv = 8, 5, 4, 2
    ctx = [6, -1, 13]  # rows 0 and 2 split across two blocks; row 1 parked
    case = paged_verify_case(ctx, Sq, N, Nkv, hd=16, block_size=BS, L=2, layer=1,
                             dtype=torch.float32, kv_int8=kv_int8, seed=7)
    before = {k: case[k].clone() for k in POOL_KEYS if case.get(k) is not None}
    out = pa.paged_verify_attention(**case)
    expect = {k: v.clone() for k, v in before.items()}
    tables = case["tables"]
    for b, c in enumerate(ctx):
        for j in range(Sq if c >= 0 else 0):
            slot = c + j
            blk, off = int(tables[b, slot // BS]), slot % BS
            expect["k_pool"][1, blk, off] = case["k_new"][b, j].reshape(-1)
            expect["v_pool"][1, blk, off] = case["v_new"][b, j].reshape(-1)
            if kv_int8:
                expect["k_scales"][1, blk, off] = case["k_new_scales"][b, j]
                expect["v_scales"][1, blk, off] = case["v_new_scales"][b, j]
    for k in before:
        assert torch.equal(case[k][:, 1:], expect[k][:, 1:]), k
    # the same result token by token through B4's plain version
    pools = {k: v.clone() for k, v in before.items()}
    for j in range(Sq):
        rows = [b for b, c in enumerate(ctx) if c >= 0]
        slots = torch.tensor([ctx[b] + j for b in rows])
        step = {"q": case["q"][rows, j], "k_new": case["k_new"][rows, j],
                "v_new": case["v_new"][rows, j], "tables": tables[rows], "lens": slots + 1,
                "blk": tables[rows].gather(1, (slots // BS)[:, None])[:, 0],
                "off": slots % BS, "layer": 1, **pools}
        if kv_int8:
            step.update(k_new_scales=case["k_new_scales"][rows, j],
                        v_new_scales=case["v_new_scales"][rows, j])
        if not kv_int8:  # an int8 pool rounds B4's new token differently
            ref = pa.paged_append_attention_ref(**step)
            torch.testing.assert_close(out[rows, j], ref, atol=1e-5, rtol=1e-5)
        else:
            pa.paged_append_attention_ref(**step)
    for k in before:
        assert torch.equal(pools[k][:, 1:], case[k][:, 1:]), k


def test_b5_rejects_mismatched_inputs():
    case = paged_verify_case([3, 9], 3, 4, 2, hd=16, block_size=8, dtype=torch.float32)
    with pytest.raises(TypeError):
        pa.paged_verify_attention(**{**case, "k_new": case["k_new"].double()})
    with pytest.raises(ValueError, match="Sq"):
        pa.paged_verify_attention(**paged_verify_case([3], 9, 4, 2, hd=16, block_size=8))
    with pytest.raises(ValueError, match="layer"):
        pa.paged_verify_attention(**{**case, "layer": 5})
    kv8 = paged_verify_case([3, 9], 3, 4, 2, hd=16, block_size=8, kv_int8=True)
    with pytest.raises(TypeError, match="k_scales"):
        pa.paged_verify_attention(**{**kv8, "k_scales": None})


# ---------------------------------------------------------------------------
# B6's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32_pool", "int8_pool"])
@pytest.mark.parametrize("N,Nkv", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("BS", [8, 16])
def test_b6_plain_matches_pallas_interpret(kv_int8, N, Nkv, BS):
    # ragged lens: a parked row (lens 0: zeros), a block edge, one token, a few blocks
    case = paged_case([2 * BS, -1, 3 * BS, 1, 4 * BS + 3], N, Nkv, hd=32, block_size=BS, L=2,
                      dtype=torch.float32, kv_int8=kv_int8, seed=BS + 3 * N + Nkv)
    args = paged_decode_args(case)
    want = j_b6(*(to_jax(args[k]) for k in ("q", "k_pool", "v_pool", "tables", "lens")),
                to_jax(args.get("k_scales")), to_jax(args.get("v_scales")), interpret=True)
    pa.reset_launch_counts()
    out = pa.paged_decode_attention(**args)
    assert not any(pa.LAUNCHES.values())
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert bool((out[1] == 0).all())


def test_b6_is_f32_throughout():
    """bf16 inputs: q * scale and p stay f32 (the JAX kernel's arithmetic),
    so the output is the f32 computation on the same values, rounded once."""
    case = paged_case([40, 17], 4, 2, hd=32, block_size=8, dtype=torch.bfloat16, seed=1)
    args = paged_decode_args(case)
    out = pa.paged_decode_attention(**args)
    f32 = pa.paged_decode_attention(**{k: (v.float() if v.is_floating_point() else v)
                                       for k, v in args.items()})
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, f32.to(torch.bfloat16))
    with pytest.raises(TypeError):
        pa.paged_decode_attention(**{**args, "q": args["q"].float()})


# ---------------------------------------------------------------------------
# drafting over the pool's token history
# ---------------------------------------------------------------------------

def test_draft_all_rows_matches_jax():
    rng = np.random.default_rng(3)
    all_ids = rng.integers(0, 5, (6, 24))
    all_ids[0, :8] = [5, 6, 7, 5, 6, 0, 0, 0]  # ... 5 6 7 5 6 -> 7 5
    lens = np.array([5, 24, 1, 0, 13, 20])
    for k, max_ngram in ((2, 3), (4, 2)):
        got = t_spec.draft_all_rows(torch.as_tensor(all_ids), torch.as_tensor(lens), k,
                                    max_ngram)
        want = j_draft_all_rows(jnp.asarray(all_ids, jnp.int32), jnp.asarray(lens), k,
                                max_ngram)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert list(t_spec.draft_all_rows(torch.as_tensor(all_ids[:1]), torch.tensor([5]), 2,
                                      3)[0]) == [7, 5]


def test_spec_eligible_reads_the_knobs():
    base = t_server.sampling_knobs(t_samp.SamplingConfig.greedy(), None)
    rows = np.tile(base, (6, 1))
    rows[1, 3] = 1.0  # do_sample
    rows[2, 2] = 1.1  # repetition penalty
    rows[3, 10] = 3  # no-repeat-ngram
    rows[4, 6] = 2  # mirostat
    rows[5, 9] = 40  # top-k
    assert list(t_spec.spec_eligible(rows)) == [True] + [False] * 5
    assert t_spec.spec_eligible(torch.as_tensor(rows)).tolist() == [True] + [False] * 5


# ---------------------------------------------------------------------------
# the spec pool
# ---------------------------------------------------------------------------

ENGINE_KW = dict(pool_size=3, block_size=16, num_blocks=24, max_seq_len=128,
                 max_new_tokens_cap=24, prompt_buckets=(32, 64, 128))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path, _ = make_native_ckpt(str(tmp_path_factory.mktemp("paged_spec")))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=path, dtype=jnp.float32, max_seq_len=128)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=path, dtype=torch.float32, device="cpu", max_seq_len=128)
    return jm, tm


def port_engine(tm, spec_k=0, **kw):
    tok = tm.tokenizer
    return TPaged(tm.model, tm.config, eos_token_id=tok.eos_token_id,
                  pad_token_id=tok.pad_token_id, sampling=t_samp.SamplingConfig.greedy(24),
                  spec_k=spec_k, spec_max_active=3, **{**ENGINE_KW, **kw})


def prompts():
    """Three random prompts (one over the prefill chunk) and a looping one, so
    drafts are accepted as well as rejected."""
    rng = np.random.default_rng(11)
    return [rng.integers(4, 270, n) for n in (9, 45, 20)] + [np.array([45, 64, 268, 138] * 4)]


def serve(eng, reqs, max_new=12, overrides=None):
    """Every request at once through the port's Scheduler -> (outputs, stats)."""
    sched = t_server.Scheduler(eng, prefill_chunk=16)
    outs = [None] * len(reqs)
    try:
        def run(i):
            outs[i] = list(t_server.generate_sync(sched, reqs[i], max_new_tokens=max_new,
                                                  sampling_overrides=overrides, timeout=300))
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return outs, sched.stats()
    finally:
        sched.stop()


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spec_pool_matches_jax_and_plain(models, kv_quant):
    """Greedy requests under the Scheduler: the spec pool equals the JAX
    spec pool and the port's plain pool token for token; speculative
    dispatches ran, drafts were accepted, B5 ran once a layer an iteration
    (its plain version here), and every block came back."""
    jm, tm = models
    reqs = prompts()
    spec = port_engine(tm, spec_k=3, kv_quant=kv_quant)
    got, stats = serve(spec, reqs)
    plain, _ = serve(port_engine(tm, kv_quant=kv_quant), reqs)
    tok = tm.tokenizer
    je = JPaged(jm.params, jm.config, dtype=jnp.float32, eos_token_id=tok.eos_token_id,
                pad_token_id=tok.pad_token_id, sampling=j_samp.SamplingConfig.greedy(24),
                spec_k=3, spec_max_active=3, kv_quant=kv_quant, **ENGINE_KW)
    jsched = j_server.Scheduler(je)
    try:
        want = [list(j_server.generate_sync(jsched, p, max_new_tokens=12, timeout=300))
                for p in reqs]
    finally:
        jsched.stop()
    assert got == plain == want
    assert stats["spec_dispatches"] > 0 and spec.spec_steps > 0
    n_tokens = sum(len(g) for g in got)
    assert spec.spec_steps + spec.decode_steps < n_tokens - len(reqs)  # drafts accepted
    assert len(spec._free) == spec.NB - 1 and spec.num_active() == 0


def test_sampled_rows_commit_one_token_an_iteration(models):
    """A sampled row beside a greedy one: each speculative iteration commits
    exactly one token to the sampled row and 1..k+1 to the greedy row, and
    the history of both rows stays their prompt plus their tokens."""
    _, tm = models
    eng = port_engine(tm, spec_k=3)
    looping = np.array([4, 263, 199, 159, 51, 45, 64, 268, 138] * 2)  # the model's own loop
    eng.prefill_row(0, looping, None, None, 20)
    eng.prefill_row(1, looping, None, None, 20, overrides={"do_sample": True, "top_k": 5})
    assert eng.spec_ready()
    grown = []
    for _ in range(4):
        before = eng.snapshot()["gen_len"]
        eng.spec_step_n(1)
        grown.append(eng.snapshot()["gen_len"] - before)
    grown = np.array(grown)
    assert (grown[:, 1] == 1).all()
    assert (grown[:, 0] >= 1).all() and (grown[:, 0] <= 4).all() and grown[:, 0].sum() > 4
    s = eng._state
    for row in (0, 1):
        n = int(s.gen_len[row])
        hist = s.all_ids[row, :int(s.positions[row]) + 1].tolist()
        assert hist == looping.tolist() + s.gen_ids[row, :n].tolist()
        assert eng.ctx_len[row] == len(looping) + n - 1
    assert eng.spec_steps == 4


def test_max_new_tokens_never_overshot(models):
    _, tm = models
    for k in (0, 4):
        eng = port_engine(tm, spec_k=k)
        for max_new in (1, 2, 5):
            outs, _ = serve(eng, prompts()[2:], max_new=max_new)
            assert all(1 <= len(o) <= max_new for o in outs), (k, max_new, outs)


def test_no_spec_dispatch_without_an_eligible_row(models):
    """The gate: a spec pool serving only sampled requests never dispatches a
    speculative iteration (a greedy one does)."""
    _, tm = models
    eng = port_engine(tm, spec_k=3)
    outs, stats = serve(eng, prompts()[:2], max_new=6, overrides={"do_sample": True})
    assert all(1 <= len(o) <= 6 for o in outs)
    assert stats["spec_dispatches"] == 0 and stats["chunk_dispatches"] > 0
    assert eng.spec_steps == 0
    _, stats = serve(eng, prompts()[:1], max_new=6)
    assert stats["spec_dispatches"] > 0


def test_spec_finish_acceptance_unit(models):
    """_spec_finish on synthetic logits: leading-match acceptance, EOS
    truncation, the max_new_tokens cap and a sampled row's one token."""
    _, tm = models
    eng = port_engine(tm, spec_k=3, pool_size=4)
    eos, V, k = eng.eos, tm.config.text_config.vocab_size, 3
    s = eng._state
    chains = [[10, 11, 12, 13], [20, eos, 21, 22], [30, 31, 32, 33], [40, 41, 42, 43]]
    logits = torch.full((4, k + 1, V), -10.0)
    for b, chain in enumerate(chains):
        logits[b, torch.arange(k + 1), torch.tensor(chain)] = 10.0
    # draft j is accepted iff it equals the prediction at position j
    drafts = torch.tensor([[10, 11, 50], [20, eos, 21], [30, 31, 32], [40, 41, 42]])
    s.active[:] = True
    s.finished[:] = False
    s.gen_len[:] = 1
    s.max_len[:] = torch.tensor([10, 10, 3, 10])  # row 2 capped at 3 tokens
    s.positions[:] = 5
    s.last_token[:] = torch.tensor([9, 19, 29, 39])
    knobs = t_server.sampling_knobs(eng.sampling, None)
    sampled = t_server.sampling_knobs(eng.sampling, {"do_sample": True, "top_k": 1})
    eng._host_knobs[:] = np.stack([knobs, knobs, knobs, sampled])
    eng._host_active[:] = True
    s.knobs = torch.as_tensor(eng._host_knobs)
    lens = eng._spec_finish(s.active & ~s.finished, torch.full((4,), 6), logits, drafts, k)
    assert s.gen_len.tolist() == [4, 3, 3, 2]
    assert s.gen_ids[0, 1:4].tolist() == [10, 11, 12]  # 2 drafts accepted, then the model's
    assert s.gen_ids[1, 1:3].tolist() == [20, eos]  # cut after EOS
    assert s.gen_ids[2, 1:3].tolist() == [30, 31]  # cut at max_new_tokens
    assert s.gen_ids[3, 1:2].tolist() == [40]  # sampled (top-k 1): one token
    assert s.finished.tolist() == [False, True, True, False]
    assert lens.tolist() == [9, 8, 8, 7]
    assert s.positions.tolist() == [8, 7, 7, 6]
    assert s.last_token.tolist() == [12, eos, 31, 40]
    assert s.all_ids[0, 6:9].tolist() == [10, 11, 12]
