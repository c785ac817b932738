"""``chat_closed_loop``: one person chatting on their own card, as the
REPL (``apps/inference.py``) and the Gradio demo do: each turn a new image
and a fresh single-turn history through ``api.chat_in_stream`` (the B=1
``Engine``, its captured start and decode graphs, a host read a token), the
next turn sent as soon as the answer ends.

The turns are ``traffic.schedule``'s requests in order (their instructions,
answer caps, sampling presets and images); the cell file's ``rate_per_s``
only sizes the list drawn, the loop sets the pace.  A turn sent inside the
window counts, and is waited for until ``drain_s`` after the window; turns
never sent are not in the record.  Each request's ``due`` is its send time,
so the time to first token is the turn's own.  Set-up draws the weights,
builds the bundle and warms a greedy and a sampled turn (the start and
decode graphs of both sampler branches).  The check is
``serve_open_loop.check``: the same comparison against the same reference.
"""
from __future__ import annotations

import threading
import time
import types

import numpy as np
import torch

from benchmark.drivers import serve_open_loop as base
from benchmark.harness import program, trace, traffic, vocab, weights

check = base.check


def _turn(bundle, r: base.Served, seed: int) -> None:
    """One chat turn, recording each token the stream yields (the end of
    sequence included) and the prompt's ids."""
    from visualcla_tpu_torch import api

    stream = bundle.stream_generate

    def recording(input_ids, *a, **k):
        r.prompt_ids = np.asarray(input_ids).reshape(-1)
        for step in stream(input_ids, *a, **k):
            r.times.append(time.perf_counter())
            r.tokens.append(int(step[0]))
            yield step

    bundle.stream_generate = recording
    r.t_start = time.perf_counter()
    try:
        for _ in api.chat_in_stream(bundle, r.payload["image"], r.plan.instruction, [],
                                    r.payload["generation_config"], verbose=False, seed=seed):
            pass
        r.final = np.asarray(r.tokens)
    except Exception as e:  # noqa: BLE001 — a failed turn is counted, not fatal
        r.error = f"{type(e).__name__}: {e}"
    finally:
        bundle.stream_generate = stream


def _served(cell: dict, p: traffic.Planned) -> base.Served:
    hgt, wid = cell["image"]
    return base.Served(p, {"image": traffic.image(p.image_seed, hgt, wid),
                           "generation_config": traffic.generation_config(cell, p)})


def set_up(ctx):
    cfg, cell, seed, log, device = ctx.cfg, ctx.cell, ctx.seed, ctx.log, ctx.device
    V = cfg["text_config"]["vocab_size"]
    tokenizer = vocab.program_tokenizer(V)
    t = time.perf_counter()
    model, pcfg = program.build_model(cfg, weights.make(cfg, seed, device), device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"weights drawn and loaded ({cfg['weights']}): {time.perf_counter() - t:.3f} s")
    from visualcla_tpu_torch.api import VisualCLA
    from visualcla_tpu_torch.processor import ImageProcessor

    bundle = VisualCLA(model, pcfg, tokenizer,
                       ImageProcessor(image_size=cfg["vision_config"]["image_size"]),
                       max_seq_len=cfg["pool"]["max_seq_len"])
    t = time.perf_counter()
    plans = traffic.schedule({**cell, "rate_per_s": 2.0}, seed ^ 0x5EED, 1.0, V)
    for i, p in enumerate(plans[:2]):
        p.sampled, p.max_new_tokens = bool(i % 2), 24
        r = _served(cell, p)
        _turn(bundle, r, seed + i)
        if r.error:
            raise RuntimeError(f"warm-up turn failed: {r.error}")
    g = bundle.engine.graphs
    log(f"warm-up: {time.perf_counter() - t:.3f} s, graphs captured {g.captures} in "
        f"{g.capture_s:.3f} s")
    return types.SimpleNamespace(bundle=bundle, model=model)


def window(ctx, stack, seconds: float, trace_slice: bool) -> dict:
    """Turns back to back from the window's start; none is sent after it
    closes; the last one is waited for until ``drain_s`` after it."""
    cell, log, device, bundle = ctx.cell, ctx.log, ctx.device, stack.bundle
    plans = traffic.schedule(cell, ctx.seed, seconds, ctx.cfg["text_config"]["vocab_size"])
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter() + 0.02
    t1 = t0 + seconds
    reqs, sl, prof = [], None, None
    eng = bundle.engine

    def counters():
        return {"counts": dict(eng.counts), "captures": eng.graphs.captures,
                "t": time.perf_counter()}

    c0 = counters()

    def user():
        time.sleep(max(0.0, t0 - time.perf_counter()))
        for i, p in enumerate(plans):
            if time.perf_counter() >= t1:
                break
            r = _served(cell, p)
            r.due = time.perf_counter()
            reqs.append(r)
            _turn(bundle, r, ctx.seed + i)

    th = threading.Thread(target=user, daemon=True)
    th.start()
    if trace_slice:
        length = min(cell["trace_slice"]["seconds"], seconds)
        time.sleep(max(0.0, t1 - length - time.perf_counter()))
        prof = trace.start_profiler()
        cs0 = counters()
        s_begin, w_begin = cs0["t"], time.time_ns()
    time.sleep(max(0.0, t1 - time.perf_counter()))
    c1 = counters()
    w_end = time.time_ns()
    th.join(timeout=max(0.0, t1 + cell["drain_s"] - time.perf_counter()))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if c1["captures"] != c0["captures"]:
        log(f"WARNING: {c1['captures'] - c0['captures']} graph captures inside the window")
    log(f"window {seconds} s: {len(reqs)} turns sent; drained "
        f"{time.perf_counter() - t1:.3f} s after it")
    if prof is not None:
        trace.stop_profiler(prof, log)
        sl = trace.reduce(prof, (w_begin, w_end))
        sl.update(t0=s_begin, t1=c1["t"], c0=cs0, c1=c1)
        log(f"profiled slice: the window's last {sl['window_s']:.3f} s, "
            f"{sl['n_device_events']} device events")
        del prof
    return {"requests": list(reqs), "t0": t0, "t1": t1, "c0": c0, "c1": c1, "slice": sl,
            "memory_peak_bytes": peak, "cfg": ctx.cfg, "cell": cell}


def run(ctx) -> dict:
    stack = set_up(ctx)
    record = window(ctx, stack, ctx.seconds, ctx.trace)
    del stack
    return record
