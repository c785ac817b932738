"""``serve_open_loop_jamba``: ``serve_open_loop``'s users and traffic
(an open loop of single-turn multimodal chats at a fixed rate, through
``PoolWorker(paged=True)``), served by VisualCLA over a Jamba text tower
and judged against the Jamba reference.

Set-up builds B7 and B8 besides the kernels ``run.py`` builds, draws the
text tower's tensors one at a time as the port's loader reads them (each
quantized on the card as it arrives: the whole tower in bf16 would not fit)
and warms the stack as ``serve_open_loop.warm_up`` does; ``plan`` and
``window`` are ``serve_open_loop``'s.  The check is ``serve_open_loop``'s
comparison (lengths, streams, n-grams, prompts, the widest gap of a served
token below what the reference's sampler keeps) against
``reference/jamba.JambaReference`` redrawn from the seed, and one more
number, ``mean_gap``: the mean over the judged tokens of that gap (0 for a
token the sampler keeps).  A bf16 program's widest gap on this tower is an
outlier's (a near-tie of the router's 2nd and 3rd expert, or of the best
logits, flipped by rounding, its effect carried on by the Mamba states), so
it reads as high as the reference's own in a lower precision; the mean
tells the bulk of the tokens apart.

A port without a Jamba tower cannot run the cell: ``set_up`` then ends the
process at once, before anything is drawn or built, with exit code 1 and a
message.
"""
from __future__ import annotations

import time
import types

import torch

from benchmark.drivers import serve_open_loop as base
from benchmark.harness import program_jamba, vocab, weights_jamba

plan, window, warm_up = base.plan, base.window, base.warm_up
NO_SAMPLE = base.NO_SAMPLE
EARLY = 16  # a request's first judged tokens, which ``early_gap`` reads


def set_up(ctx):
    """Build B7 and B8, draw the weights as the loader reads them, build the
    served stack and warm it: -> the stack."""
    cfg, cell, seed, log, device = ctx.cfg, ctx.cell, ctx.seed, ctx.log, ctx.device
    if not program_jamba.has_jamba():
        log("the port has no Jamba text tower (visualcla_tpu_torch.models.jamba is missing): "
            "this cell cannot run on it")
        raise SystemExit(1)
    V = cfg["vocab_size"]
    if device.type == "cuda":
        program_jamba.prebuild(log)
    t = time.perf_counter()
    tokenizer = vocab.program_tokenizer(V)
    log(f"tokenizer: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    model, pcfg = program_jamba.build_model(cfg, weights_jamba.make(cfg, seed, device), device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"weights drawn, loaded and quantized ({cfg['weights']}): "
        f"{time.perf_counter() - t:.3f} s")
    bundle, worker = program_jamba.build_worker(cfg, model, pcfg, tokenizer, seed)
    warm_up(worker, cell, seed, V, log)
    return types.SimpleNamespace(bundle=bundle, worker=worker, model=model)


def run(ctx) -> dict:
    """Set up, serve one window, stop the stack and free it."""
    stack = set_up(ctx)
    reqs = plan(ctx, ctx.seconds)
    record = window(ctx, stack, reqs, ctx.seconds, ctx.trace)
    stack.worker.close()
    del stack
    return record


def reference(cfg: dict, seed: int, device, precision=None):
    from benchmark.reference.jamba import JambaReference

    towers = weights_jamba.make(cfg, seed, device)
    towers.pop("text")  # redrawn layer by layer
    return JambaReference(cfg, seed, device, towers, precision)


def _served(record: dict, ctx):
    """(sample, seqs) the check judges, and the faults it counts exactly."""
    from benchmark.reference.sampling import ngram_repeats
    from benchmark.harness import traffic

    cell = record["cell"]
    eos = 2
    done = [r for r in record["requests"] if r.final is not None and r.error is None]
    faults = {
        "length_faults": sum(1 for r in done if len(r.final) != r.plan.max_new_tokens
                             and int(r.final[-1]) != eos),
        "stream_faults": sum(1 for r in done if r.tokens != r.final.tolist()),
        "ngram_faults": sum(1 for r in done if ngram_repeats(
            r.final.tolist(),
            traffic.generation_config(cell, r.plan).get("no_repeat_ngram_size", 0)))}
    sample = base.sample_for_check(record, ctx.seed, cell["check"])
    seqs = base.reference_seqs(record, sample)
    faults["prompt_faults"] = sum(1 for r, s in zip(sample, seqs)
                                  if r.prompt_ids.tolist() != s["ids"][:s["prompt_len"]])
    return sample, seqs, faults


def token_gaps(logits, seqs, tokens=None) -> list:
    """Each judged token's gap below the least that its sampler keeps (0 for
    a kept token; ``base.BANNED`` for one the n-gram ban forbids), as
    ``serve_open_loop.gaps`` reads their widest, a tensor a request;
    ``tokens`` as there."""
    from benchmark.reference.sampling import kept, processed

    out = []
    for i, (lg, s) in enumerate(zip(logits, seqs)):
        tok = (torch.as_tensor(s["served"], device=lg.device) if tokens is None
               else tokens[i].to(lg.device))
        proc = processed(lg, s["served"], s["config"])
        least = torch.where(kept(proc, s["config"]), proc, float("inf")).min(-1).values
        out.append((least - proc.gather(1, tok[:, None])[:, 0]).clamp(0.0, base.BANNED))
    return out


def gap_numbers(logits, seqs, tokens=None) -> dict:
    """The judged tokens' gaps, read four ways: ``max`` the widest, ``mean``
    their mean, ``early`` the mean over each request's first ``EARLY``
    tokens (those a Mamba state lost or spoiled at the admission moves
    most), ``req`` the largest of the requests' own means."""
    g = token_gaps(logits, seqs, tokens)
    if not g or not sum(len(x) for x in g):
        return dict.fromkeys(("max", "mean", "early", "req"), NO_SAMPLE)
    every = torch.cat(g)
    return {"max": float(every.max()), "mean": float(every.mean()),
            "early": float(torch.cat([x[:EARLY] for x in g]).mean()),
            "req": max(float(x.mean()) for x in g if len(x))}


def check(record: dict, ctx) -> dict:
    """``serve_open_loop.check``'s comparison against the Jamba reference,
    with the other readings of the gaps that the cell sets a limit on
    (``limits``: ``max_gap``, ``mean_gap``, ``early_gap``, ``req_gap``)."""
    cfg, cell = record["cfg"], record["cell"]
    sample, seqs, faults = _served(record, ctx)
    t = time.perf_counter()
    nums = (gap_numbers(reference(cfg, ctx.seed, ctx.device).logits(seqs), seqs) if seqs
            else gap_numbers([], []))
    ctx.log(f"reference: {len(seqs)} requests ({sum(1 for r in sample if r.plan.sampled)} "
            f"sampled), {sum(len(s['served']) for s in seqs)} served tokens judged in "
            f"{time.perf_counter() - t:.3f} s")
    limits = cell["limits"]
    return {**{f"{k}_gap": {"value": v, "limit": limits[f"{k}_gap"]} for k, v in nums.items()
               if f"{k}_gap" in limits},
            **{k: {"value": v, "limit": 0} for k, v in faults.items()}}


def readings(record: dict, ctx, faults: bool = True, weights_seed=None,
             controls=None, others=None) -> dict:
    """The readings the limits are set from (``tools/readings_jamba.py``),
    each ``gap_numbers``' four as ``<name>`` (the widest), ``<name>_mean``,
    ``<name>_early`` and ``<name>_req``: the program's; each control's (the
    reference at a lower precision put in the program's place: the tokens
    its processed logits put first; ``controls`` name -> precision, default
    the configuration's ``control``, ``{}`` none); with ``faults``, a token
    altered where it is produced (the reference's best + 1).
    ``weights_seed``: the seed the weights were drawn from, where the
    traffic took another (default ``ctx.seed``); ``others``: name -> a
    function of the seqs giving logits, read as the controls are."""
    cfg = record["cfg"]
    seed = ctx.seed if weights_seed is None else weights_seed
    _, seqs, _ = _served(record, ctx)
    logits = reference(cfg, seed, ctx.device).logits(seqs)
    out = {"tokens": sum(len(s["served"]) for s in seqs)}

    def put(name, tokens=None):
        for k, v in gap_numbers(logits, seqs, tokens).items():
            out[name if k == "max" else f"{name}_{k}"] = v

    put("program")
    for name, prec in (controls if controls is not None else {"control": cfg["control"]}).items():
        ctl = reference(cfg, seed, ctx.device, precision=prec).logits(seqs)
        put(name, base.choices(ctl, seqs))
        del ctl
    for name, fn in (others or {}).items():
        put(name, base.choices(fn(seqs), seqs))
    if faults:
        V = logits[0].shape[-1]
        put("fault_token_altered", [(b + 1) % V for b in base.choices(logits, seqs)])
    return out
