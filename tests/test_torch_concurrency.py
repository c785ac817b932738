"""Concurrent calls on one model in the PyTorch port, on the CPU in fp32: two
threads that enter the prefill together (a barrier at
``Engine.stage_prompt``, after each has claimed its workspace) each get the
ids of their own sequential run: ``Engine.stream``, ``Engine.generate``,
``SpeculativeDecoder``, the fused beam search and the server without a pool
(``ChatWorker``: its chats and streams run one at a time on its thread).

Tolerance: none; token for token."""
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu_torch.apps import serve as t_serve
from visualcla_tpu_torch.engine import beam as t_beam
from visualcla_tpu_torch.engine import generate as t_gen
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.engine import speculative as t_spec
from visualcla_tpu_torch.text import encoding_text

LOOPING = np.array([5, 6, 7, 8, 9, 10] * 3)
OTHER = np.array([11, 4, 17, 9, 3, 12] * 3)  # the same length: the same workspace key


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    ckpt, cfg = make_native_ckpt(str(tmp_path_factory.mktemp("concurrency")))
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    s = cfg.vision_config.image_size
    pix = np.random.default_rng(1).standard_normal((1, 3, s, s)).astype(np.float32)
    ids = encoding_text([], "ab你好", tm.num_patch, tm.tokenizer)["input_ids"]
    img = np.flatnonzero(ids[0] == tm.tokenizer.img_start_token_id)[:1]
    # two text prompts of one shape (one workspace key) and a chat
    return tm, [(LOOPING[None], None, None), (OTHER[None], None, None), (ids, pix, img)]


@pytest.fixture
def barrier(monkeypatch):
    """Two callers meet at the entry of ``Engine.stage_prompt`` (a caller
    that waits 5 s alone goes on: a serialized path never meets)."""
    meet = threading.Barrier(2)
    orig = t_gen.Engine.stage_prompt

    def staged(self, *a, **k):
        try:
            meet.wait(timeout=5)
        except threading.BrokenBarrierError:
            pass
        return orig(self, *a, **k)

    monkeypatch.setattr(t_gen.Engine, "stage_prompt", staged)
    return meet


def together(fns):
    out = [None] * len(fns)
    errors = []

    def run(k):
        try:
            out[k] = fns[k]()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    return out


def engine(tm):
    return t_gen.Engine(tm.model, tm.config, eos_token_id=10 ** 6,
                        pad_token_id=tm.tokenizer.pad_token_id, max_seq_len=256)


CFG = t_samp.SamplingConfig.greedy(16)


@pytest.mark.parametrize("how", ["stream", "generate"])
def test_engine_calls_overlap(setup, barrier, how):
    tm, prompts = setup
    prompts = prompts[:2]
    eng = engine(tm)
    want = [eng.generate(*p, CFG)[0].tolist() for p in prompts]
    assert want[0] != want[1]
    if how == "stream":
        fns = [lambda p=p: [int(t[0]) for t in eng.stream(*p, CFG, chunk_size=4)]
               for p in prompts]
    else:
        fns = [lambda p=p: eng.generate(*p, CFG)[0].tolist() for p in prompts]
    assert together(fns) == want
    # one workspace cached (the other call's was private), its claim released
    assert len(eng._workspaces) == 1 and not next(iter(eng._workspaces.values())).busy


def test_same_request_twice_overlaps(setup, barrier):
    """One request twice at once, through generate and stream: the second
    claims a private workspace."""
    tm, prompts = setup
    eng = engine(tm)
    p = prompts[2]
    want = eng.generate(*p, CFG)[0].tolist()
    seen = []
    orig = eng.workspace

    def workspace(*a):
        ws = orig(*a)
        seen.append(ws)
        return ws

    eng.workspace = workspace
    got = together([lambda: eng.generate(*p, CFG)[0].tolist(),
                    lambda: [int(t[0]) for t in eng.stream(*p, CFG)]])
    assert got == [want, want]
    assert len(seen) == 2 and seen[0] is not seen[1]
    assert len(eng._workspaces) == 1 and not next(iter(eng._workspaces.values())).busy


def test_speculative_calls_overlap(setup, barrier):
    tm, prompts = setup
    eng = engine(tm)
    dec = t_spec.SpeculativeDecoder(eng, 3, 3)
    prompts = [prompts[2], prompts[0]]
    want = [dec.generate(*p, CFG)[0].tolist() for p in prompts]
    got = together([lambda: dec.generate(*prompts[0], CFG)[0].tolist(),
                    lambda: [int(t[0]) for t in dec.stream(*prompts[1], CFG)]])
    assert got[0] == want[0]
    assert got[1] == want[1][:len(got[1])] and len(got[1]) == 16


def test_fused_beams_overlap(setup):
    """Two fused beam searches on one model share its workspace one after
    the other."""
    tm, prompts = setup
    kw = dict(num_beams=3, max_new_tokens=8, eos_token_id=tm.tokenizer.eos_token_id)

    def beam(p):
        return t_beam.beam_generate_fused(tm.model, tm.config, *p, **kw).tolist()

    text = (LOOPING[None], None, np.full((1,), -1, np.int32))
    want = [beam(prompts[2]), beam(text)]
    assert together([lambda: beam(prompts[2]), lambda: beam(text)]) == want


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        raw = r.read().decode()
    return json.loads(raw) if path == "/chat" else [json.loads(x) for x in raw.splitlines()]


def test_server_without_pool_overlapping_requests(setup, barrier):
    """Two /chat_stream requests and a /chat at once on the server without a
    pool: each reply equals its request's reply alone."""
    tm, _ = setup
    worker = t_serve.ChatWorker(tm)
    server = ThreadingHTTPServer(("127.0.0.1", 0), t_serve.make_handler(worker))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    gc = {"do_sample": False, "max_new_tokens": 12, "repetition_penalty": 1.0}
    bodies = [{"text": "ab你好", "generation_config": gc},
              {"text": "cd图片", "generation_config": gc}]
    try:
        want = [_post(port, "/chat", b) for b in bodies]
        got = together([lambda: _post(port, "/chat_stream", bodies[0]),
                        lambda: _post(port, "/chat_stream", bodies[1]),
                        lambda: _post(port, "/chat", bodies[0])])
    finally:
        server.shutdown()
        server.server_close()
    assert got[0][-1] == want[0] and got[1][-1] == want[1] and got[2] == want[0]
    assert all("partial" in x for x in got[0][:-1])


def test_workspace_claims_under_contention(setup):
    """32 threads claim and release workspaces of one shape 20 times each with
    a 1 µs switch interval: no workspace is ever held by two of them, and
    every claim is given back."""
    import sys

    tm, _ = setup
    eng = engine(tm)
    holders: dict = {}
    clashes, errors = [], []
    guard = threading.Lock()

    def worker(k):
        try:
            for _ in range(20):
                ws = eng.workspace(1, 256)
                with guard:
                    if id(ws) in holders:
                        clashes.append((holders[id(ws)], k))
                    holders[id(ws)] = k
                with guard:
                    del holders[id(ws)]
                eng.release(ws)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not clashes
    assert len(eng._workspaces) == 1 and not any(w.busy for w in eng._workspaces.values())
