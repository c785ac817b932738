"""Driver ``serve_open_loop``: independent users chatting with the served
model, an open loop of single-turn multimodal requests at a fixed rate.

Each request is what ``apps/serve.py --pool N --paged`` receives over HTTP
(the text, a ``.npy`` image in base64, a ``generation_config``) and goes the
handler's way without the HTTP layer: ``PoolWorker._prepare_request`` (image
decode, the port's processor on the host, the prompt), then
``engine.server.generate_stream`` into the ``Scheduler`` over the paged pool,
on a thread of its own, started when the request is due.  Set-up draws the
weights, builds the stack, makes the requests' payloads and warms every
graph key and admission form the traffic uses; then the window runs for
``seconds``, and the requests due in it are waited for until ``drain_s``
after it closes.
"""
from __future__ import annotations

import base64
import dataclasses
import io
import threading
import time
import types
from typing import List, Optional

import numpy as np
import torch

from benchmark.harness import program, trace, traffic, vocab, weights


NO_SAMPLE = 1e9  # the gap reported when no request finished to be judged
BANNED = 1e9  # the gap of a token that the n-gram ban forbids


@dataclasses.dataclass
class Served:
    plan: traffic.Planned
    payload: dict
    due: float = 0.0  # perf_counter
    t_start: float = 0.0
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    final: Optional[np.ndarray] = None
    prompt_ids: Optional[np.ndarray] = None
    error: Optional[str] = None
    thread: Optional[threading.Thread] = None


def _npy_b64(img: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, img)
    return base64.b64encode(buf.getvalue()).decode()


def payload(cell: dict, p: traffic.Planned) -> dict:
    h, w = cell["image"]
    return {"text": p.instruction,
            "image_b64": _npy_b64(traffic.image(p.image_seed, h, w)),
            "generation_config": traffic.generation_config(cell, p)}


def _serve(worker, r: Served, deadline: float) -> None:
    """One request, the handler's way: prepare, stream, keep every token."""
    from visualcla_tpu_torch.engine.server import generate_stream

    r.t_start = time.perf_counter()
    try:
        ids, pv, img, _, overrides, max_new = worker._prepare_request(r.payload)
        r.prompt_ids = np.asarray(ids)
        for kind, x in generate_stream(worker.scheduler, ids, pixel_values=pv,
                                       img_start_pos=img, max_new_tokens=max_new,
                                       sampling_overrides=overrides,
                                       timeout=max(1.0, deadline - time.perf_counter())):
            if kind == "token":
                r.times.append(time.perf_counter())
                r.tokens.append(x)
            else:
                r.final = np.asarray(x)
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        r.error = f"{type(e).__name__}: {e}"


def _start(worker, r: Served, deadline: float) -> None:
    r.thread = threading.Thread(target=_serve, args=(worker, r, deadline), daemon=True)
    r.thread.start()


def warm_up(worker, cell: dict, seed: int, vocab_size: int, log) -> None:
    """Every graph key and admission form the traffic meets, before the
    window: a greedy request alone (a one-shot admission; the greedy decode
    graph), a sampled one while it runs (a chunked admission, since the
    queue is shallow; the mixed decode graph), then four at once (one-shot
    admissions beside live rows, greedy and sampled)."""
    t0 = time.perf_counter()
    plans = traffic.schedule({**cell, "rate_per_s": 6.0}, seed ^ 0x5EED, 1.0, vocab_size)
    for i, p in enumerate(plans):
        p.sampled, p.max_new_tokens = bool(i % 2), 24
        p.instruction = p.instruction[:40]
    reqs = [Served(p, payload(cell, p)) for p in plans]
    deadline = time.perf_counter() + 300
    _start(worker, reqs[0], deadline)
    while not reqs[0].tokens and reqs[0].thread.is_alive():
        time.sleep(0.005)
    _start(worker, reqs[1], deadline)
    while not reqs[1].tokens and reqs[1].thread.is_alive():
        time.sleep(0.005)
    for r in reqs[2:6]:
        _start(worker, r, deadline)
    for r in reqs[:6]:
        r.thread.join()
        if r.error:
            raise RuntimeError(f"warm-up request failed: {r.error}")
    stats = worker.scheduler.stats()
    log(f"warm-up: {time.perf_counter() - t0:.3f} s, one-shot admissions {stats['prefills']}, "
        f"chunked {stats['chunked_admissions']}, graphs captured {worker.engine.graphs.captures} "
        f"in {worker.engine.graphs.capture_s:.3f} s")


def _quiet(worker, timeout_s: float = 5.0) -> None:
    """Wait until the Scheduler's loop has found nothing to do twice running
    (no call of it touches the card then)."""
    n0 = worker.scheduler.stats()["idle_sleeps"]
    end = time.perf_counter() + timeout_s
    while worker.scheduler.stats()["idle_sleeps"] < n0 + 2 and time.perf_counter() < end:
        time.sleep(0.005)


def _counters(worker) -> dict:
    eng = worker.engine
    return {"stats": worker.scheduler.stats(), "counts": dict(eng.counts),
            "captures": eng.graphs.captures,
            "t": time.perf_counter()}


def set_up(ctx):
    """Draw the weights, build the served stack and warm it: -> the stack
    (a namespace holding the worker and what keeps it alive)."""
    cfg, cell, seed, log, device = ctx.cfg, ctx.cell, ctx.seed, ctx.log, ctx.device
    V = cfg["text_config"]["vocab_size"]
    t = time.perf_counter()
    tokenizer = vocab.program_tokenizer(V)
    log(f"tokenizer: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    model, pcfg = program.build_model(cfg, weights.make(cfg, seed, device), device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"weights drawn and loaded ({cfg['weights']}): {time.perf_counter() - t:.3f} s")
    bundle, worker = program.build_worker(cfg, model, pcfg, tokenizer, seed)
    warm_up(worker, cell, seed, V, log)
    return types.SimpleNamespace(bundle=bundle, worker=worker, model=model)


def plan(ctx, seconds: float, rate: Optional[float] = None) -> List[Served]:
    t = time.perf_counter()
    plans = traffic.schedule(ctx.cell, ctx.seed, seconds, ctx.cfg["text_config"]["vocab_size"],
                             rate=rate)
    reqs = [Served(p, payload(ctx.cell, p)) for p in plans]
    ctx.log(f"traffic: {len(reqs)} requests, payloads made in {time.perf_counter() - t:.3f} s")
    return reqs


def window(ctx, stack, reqs: List[Served], seconds: float, trace_slice: bool) -> dict:
    """Serve ``reqs`` at their due times over a window of ``seconds``, wait
    for them until ``drain_s`` after it, and return the run's record (the
    stack is left running)."""
    cell, log, device, worker = ctx.cell, ctx.log, ctx.device, stack.worker
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    sl, prof = None, None
    t0 = time.perf_counter() + 0.02
    t1 = t0 + seconds
    deadline = t1 + cell["drain_s"]
    c0 = _counters(worker)

    def generator():
        for r in reqs:
            r.due = t0 + r.plan.due
            wait = r.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            _start(worker, r, deadline)

    gen = threading.Thread(target=generator, daemon=True)
    gen.start()
    if trace_slice:
        # the slice closes with the window; the profiler stops after the drain
        length = min(cell["trace_slice"]["seconds"], seconds)
        time.sleep(max(0.0, t1 - length - time.perf_counter()))
        prof = trace.start_profiler()  # None on the CPU
        cs0 = _counters(worker)
        s_begin, w_begin = cs0["t"], time.time_ns()
    time.sleep(max(0.0, t1 - time.perf_counter()))
    c1 = _counters(worker)
    w_end = time.time_ns()
    gen.join()
    for r in reqs:
        r.thread.join(timeout=max(0.0, deadline - time.perf_counter()))
    drained = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    late = np.asarray([r.t_start - r.due for r in reqs]) if reqs else np.zeros(1)
    if c1["captures"] != c0["captures"]:
        log(f"WARNING: {c1['captures'] - c0['captures']} graph captures inside the window")
    log(f"window {seconds} s; drained {drained - t1:.3f} s after it; generator late by "
        f"p50 {np.median(late) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms")
    if prof is not None:
        _quiet(worker)
        trace.stop_profiler(prof, log)
        sl = trace.reduce(prof, (w_begin, w_end))
        sl.update(t0=s_begin, t1=c1["t"], c0=cs0, c1=c1)
        log(f"profiled slice: the window's last {sl['window_s']:.3f} s, "
            f"{sl['n_device_events']} device events")
        del prof
    return {"requests": reqs, "t0": t0, "t1": t1, "c0": c0, "c1": c1, "slice": sl,
            "memory_peak_bytes": peak, "cfg": ctx.cfg, "cell": cell}


def run(ctx) -> dict:
    """Set up, serve one window, stop the stack and free it."""
    stack = set_up(ctx)
    reqs = plan(ctx, ctx.seconds)
    record = window(ctx, stack, reqs, ctx.seconds, ctx.trace)
    stack.worker.close()
    del stack
    return record


def _pick(done: List[Served], rng, n_max: int, min_tokens: int) -> List[Served]:
    """The longest of ``done``, then others in ``rng``'s order until
    ``min_tokens`` served tokens or ``n_max`` requests."""
    if not done or n_max <= 0:
        return []
    done = sorted(done, key=lambda r: -len(r.final))
    out, n = [done[0]], len(done[0].final)
    for i in 1 + rng.permutation(len(done) - 1):
        if len(out) >= n_max or n >= min_tokens:
            break
        out.append(done[i])
        n += len(done[i].final)
    return out


def sample_for_check(record: dict, seed: int, check: dict) -> List[Served]:
    """Finished requests due in the window, drawn from the seed: greedy ones
    (the longest, then others until ``min_tokens`` served tokens or
    ``requests`` requests), then sampled ones alike (``sampled_min_tokens``,
    ``sampled_requests``)."""
    done = [r for r in record["requests"] if r.final is not None and r.error is None]
    rng = np.random.default_rng(seed)
    return (_pick([r for r in done if not r.plan.sampled], rng, check["requests"],
                  check["min_tokens"])
            + _pick([r for r in done if r.plan.sampled], rng, check["sampled_requests"],
                    check["sampled_min_tokens"]))


def reference_seqs(record: dict, sample: List[Served]) -> list:
    """The reference's own prompt ids and pixels for each sampled request,
    followed by every served token but the last, and the request's
    generation config."""
    from benchmark.reference.preprocess import preprocess
    from benchmark.reference.tokenize import Tokenizer

    cfg, cell = record["cfg"], record["cell"]
    tok = Tokenizer(cfg["text_config"]["vocab_size"])
    q = cfg["visual_resampler_config"]["num_query_tokens"]
    h, w = cell["image"]
    seqs = []
    for r in sample:
        ids = tok.chat_prompt(r.plan.instruction, q)
        seqs.append({"ids": ids + r.final[:-1].tolist(), "prompt_len": len(ids),
                     "img_start": tok.img_start(ids), "served": r.final.tolist(),
                     "config": traffic.generation_config(cell, r.plan),
                     "pixels": preprocess(traffic.image(r.plan.image_seed, h, w),
                                          cfg["vision_config"]["image_size"])})
    return seqs


def choices(logits, seqs) -> list:
    """What each position's processed logits put first (a (n,) tensor a seq)."""
    from benchmark.reference.sampling import processed

    return [processed(lg, s["served"], s["config"]).argmax(-1) for lg, s in zip(logits, seqs)]


def gaps(logits, seqs, tokens=None) -> float:
    """The widest gap by which a token's processed reference logit lies below
    the least that the request's sampler keeps at its position (the best,
    for a greedy request): the served tokens', or ``tokens`` (a (n,) tensor
    a seq, e.g. what another computation puts first).  A token that the
    n-gram ban forbids reads ``BANNED``."""
    from benchmark.reference.sampling import kept, processed

    worst = 0.0
    for i, (lg, s) in enumerate(zip(logits, seqs)):
        tok = (torch.as_tensor(s["served"], device=lg.device) if tokens is None
               else tokens[i].to(lg.device))
        proc = processed(lg, s["served"], s["config"])
        least = torch.where(kept(proc, s["config"]), proc, float("inf")).min(-1).values
        g = least - proc.gather(1, tok[:, None])[:, 0]
        worst = max(worst, min(float(g.max()), BANNED))
    return worst


def check(record: dict, ctx) -> dict:
    """What the window served against the plain reference: every finished
    request's length and stream (exact), every sampled one's n-grams (none
    repeats, exact), and on a sample drawn from the seed (the longest greedy
    and the longest sampled answer among it) the prompt's ids (exact) and
    the widest gap of a served token below what the reference's sampler
    keeps."""
    from benchmark.reference.model import Reference
    from benchmark.reference.sampling import ngram_repeats

    cfg, cell = record["cfg"], record["cell"]
    eos = 2
    done = [r for r in record["requests"] if r.final is not None and r.error is None]
    length_faults = sum(1 for r in done if len(r.final) != r.plan.max_new_tokens
                        and int(r.final[-1]) != eos)
    stream_faults = sum(1 for r in done if r.tokens != r.final.tolist())
    ngram_faults = sum(1 for r in done if ngram_repeats(
        r.final.tolist(), traffic.generation_config(cell, r.plan).get("no_repeat_ngram_size", 0)))
    sample = sample_for_check(record, ctx.seed, cell["check"])
    seqs = reference_seqs(record, sample)
    prompt_faults = sum(1 for r, s in zip(sample, seqs)
                        if r.prompt_ids.tolist() != s["ids"][:s["prompt_len"]])
    t = time.perf_counter()
    ref = Reference(cfg, weights.make(cfg, ctx.seed, ctx.device))
    widest = gaps(ref.logits(seqs), seqs) if seqs else NO_SAMPLE
    del ref
    n_sampled = sum(1 for r in sample if r.plan.sampled)
    ctx.log(f"reference: {len(seqs)} requests ({n_sampled} sampled), "
            f"{sum(len(s['served']) for s in seqs)} served tokens judged in "
            f"{time.perf_counter() - t:.3f} s")
    lim = cell["limits"]
    return {"max_gap": {"value": widest, "limit": lim["max_gap"]},
            "prompt_faults": {"value": prompt_faults, "limit": 0},
            "length_faults": {"value": length_faults, "limit": 0},
            "stream_faults": {"value": stream_faults, "limit": 0},
            "ngram_faults": {"value": ngram_faults, "limit": 0}}
