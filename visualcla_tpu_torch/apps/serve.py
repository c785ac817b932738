"""HTTP chat endpoint (port of visualcla_tpu/apps/serve.py), stdlib only:

  POST /chat   {"text": str, "image_b64": str|null, "history": [...],
                "generation_config": {...}, "seed": int}
            -> {"response": str, "history": [...]}
  POST /chat_stream  (same body) -> newline-delimited JSON partials
            {"partial": str} ... {"response": str, "history": [...]}
  GET  /health -> {"status": "ok"}

``image_b64`` holds an encoded image (PNG, JPEG, ...: needs Pillow) or a
``.npy`` file of a uint8 (H, W, 3) array (needs numpy only).  With ``--pool
N`` requests share a pool of N cache rows under ``engine.server.Scheduler``:
the contiguous ``engine.server.ServingEngine`` (a fixed (L, N, Nkv,
max_seq_len, hd) cache), or with ``--paged`` the block-paged
``engine.paged.PagedServingEngine`` (``--kv_int8``: its int8 pool).
Concurrent chats share every decode step and stream per token.  Without
``--pool`` one worker thread serves the chats and the streams in turn.

    python -m visualcla_tpu_torch.apps.serve --visualcla_model CKPT --pool 4 \\
        [--paged [--kv_int8]] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..processor.image import NPY_MAGIC
from ..utils.profiling import span

logger = logging.getLogger(__name__)


def decode_image(b64: str):
    """An ``image_b64`` payload -> a uint8 (H, W, 3) array or a PIL image."""
    raw = base64.b64decode(b64)
    if raw.startswith(NPY_MAGIC):
        img = np.load(io.BytesIO(raw), allow_pickle=False)
        if img.dtype != np.uint8 or img.ndim != 3:
            raise ValueError(f"a .npy image must be uint8 (H, W, 3), got {img.dtype} "
                             f"{img.shape}")
        return img
    from PIL import Image

    return Image.open(io.BytesIO(raw))


class PoolWorker:
    """Continuous-batching backend: requests prefill into a fixed pool of
    rows and decode together, token-interleaved; the contiguous pool
    (``ServingEngine``) by default, the paged one with ``paged=True``.

    A model loaded with ``mesh=`` is served over its mesh (both pools take
    ``mesh=model.mesh``).  At world size > 1 every rank builds its
    ``PoolWorker`` with the same arguments; rank 0's ``Scheduler`` leads
    (``parallel.serving.Leader``) and every other rank calls ``follow()``,
    which returns when rank 0's worker closes and raises when rank 0's loop
    dies or sends nothing for ``deadline_s``."""

    def __init__(self, model, pool_size: int = 4, paged: bool = False,
                 block_size: int = 64, num_blocks: int = 0, kv_quant: str = "none",
                 deadline_s: float = 600.0, **engine_kw):
        from ..engine.server import Scheduler, ServingEngine
        from ..parallel import distributed, serving

        self.model = model
        mesh = getattr(model, "mesh", None)
        common = dict(eos_token_id=model.tokenizer.eos_token_id,
                      pad_token_id=model.tokenizer.pad_token_id, pool_size=pool_size,
                      max_seq_len=model.engine.max_seq_len, mesh=mesh, **engine_kw)
        if paged:
            from ..engine.paged import PagedServingEngine

            self.engine = PagedServingEngine(
                model.model, model.config, block_size=block_size,
                num_blocks=num_blocks or pool_size * 16, kv_quant=kv_quant, **common)
        else:
            if kv_quant != "none":
                # the JAX CLI ignores --kv_int8 without --paged; the port refuses it
                raise ValueError(f"kv_quant={kv_quant!r} needs the paged pool (--paged): "
                                 "the contiguous pool keeps its cache in the model's dtype")
            self.engine = ServingEngine(model.model, model.config, **common)
        # over a mesh of more than one rank: rank 0 leads, the others follow
        self._group = None
        self._deadline_s = deadline_s
        if mesh is not None and distributed.world() > 1:
            self._group = serving.control_group(deadline_s)
        self.scheduler = None  # a follower has none
        if self._group is None:
            self.scheduler = Scheduler(self.engine)
        elif distributed.rank() == serving.LEADER:
            self.scheduler = Scheduler(serving.Leader(self.engine, self._group, deadline_s))

    def follow(self) -> dict:
        """On a rank > 0: make rank 0's engine calls until its worker closes
        (``parallel.serving.follow``)."""
        from ..parallel import serving

        if self._group is None:
            raise RuntimeError("follow() serves a meshed model at world size > 1")
        return serving.follow(self.engine, self._group, self._deadline_s)

    def close(self) -> None:
        if self.scheduler is not None:
            self.scheduler.stop()

    def _prepare_request(self, req: dict):
        """Shared /chat and /chat_stream prep: decode the image(s), build the
        prompt, locate the markers, record the instruction in the (mutated)
        history, pick the sampling overrides (span ``serve.prepare``)."""
        with span("serve.prepare"):
            return self._prepare(req)

    def _prepare(self, req: dict):
        from ..engine.server import KNOB_NAMES
        from ..text import encoding_text
        from ..text.prompt import all_img_marker_positions, img_marker_positions

        model = self.model
        history = req.get("history") or []
        text = req["text"]

        def pixels(b64: str):
            return model.image_processor(decode_image(b64))["pixel_values"]

        # several images: "images_b64" attaches K images to THIS turn, and
        # history entries echo their own images back
        multi = "images_b64" in req or any(h.get("images_b64") for h in history)
        if multi:
            turn_b64 = list(req.get("images_b64") or [])
            if req.get("image_b64"):
                turn_b64.append(req["image_b64"])
            all_pv = [pixels(b) for h in history for b in (h.get("images_b64") or [])]
            all_pv += [pixels(b) for b in turn_b64]
            ids = encoding_text(history, text, model.num_patch, model.tokenizer,
                                num_images=len(turn_b64))["input_ids"]
            pixel_values = np.stack(all_pv, axis=1) if all_pv else None
            img_pos = [int(p) for p in all_img_marker_positions(
                ids, model.tokenizer.img_start_token_id)[0] if p >= 0]
            K = 0 if pixel_values is None else pixel_values.shape[1]
            if len(img_pos) != K:
                raise ValueError(f"prompt has {len(img_pos)} <img> markers but {K} "
                                 "images were provided")
            entry = {"type": "instruction", "value": text, "images": len(turn_b64),
                     "images_b64": turn_b64}
            img_start = img_pos or None
        else:
            pixel_values = pixels(req["image_b64"]) if req.get("image_b64") else None
            ids = encoding_text(history, text, model.num_patch, model.tokenizer)["input_ids"]
            img_start = int(img_marker_positions(ids, model.tokenizer.img_start_token_id)[0])
            entry = {"type": "instruction", "value": text}
        if not history:
            entry["first_instruction"] = True
        history.append(entry)
        gc = req.get("generation_config") or {}
        overrides = {k: gc[k] for k in KNOB_NAMES if k in gc}
        return (ids[0], pixel_values, img_start, history, overrides or None,
                int(gc.get("max_new_tokens", 512)))

    def submit(self, req: dict, timeout: float = 600.0) -> dict:
        from ..engine.server import generate_sync

        ids, pixel_values, img_start, history, overrides, max_new = self._prepare_request(req)
        out = generate_sync(self.scheduler, ids, pixel_values=pixel_values,
                            img_start_pos=img_start, max_new_tokens=max_new,
                            sampling_overrides=overrides, timeout=timeout)
        response = self.model.tokenizer.decode(out, skip_special_tokens=True)
        history.append({"type": "response", "value": response})
        return {"response": response, "history": history}

    def submit_stream(self, req: dict, timeout: float = 600.0):
        """Per-token streaming from the pool: concurrent streams share every
        decode step."""
        from ..engine.server import generate_stream

        tok = self.model.tokenizer
        ids, pixel_values, img_start, history, overrides, max_new = self._prepare_request(req)
        tokens: list = []
        response = ""
        for kind, payload in generate_stream(
                self.scheduler, ids, pixel_values=pixel_values, img_start_pos=img_start,
                max_new_tokens=max_new, sampling_overrides=overrides, timeout=timeout):
            if kind == "token":
                tokens.append(payload)
                response = tok.decode(tokens, skip_special_tokens=True)
                yield {"partial": response}
            else:  # done: the authoritative full sequence
                response = tok.decode(payload, skip_special_tokens=True)
        history.append({"type": "response", "value": response})
        yield {"response": response, "history": history}


class ChatWorker:
    """One consumer thread owning the model: chats and streams queue and run
    on it one at a time (a stream's items reach its caller through a
    queue)."""

    def __init__(self, model):
        self.model = model
        self.q: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def close(self) -> None:
        pass

    def _chat_args(self, req: dict) -> dict:
        from ..api import as_sampling_config

        return dict(image=decode_image(req["image_b64"]) if req.get("image_b64") else None,
                    text=req["text"], history=req.get("history") or [],
                    generation_config=as_sampling_config(req.get("generation_config")),
                    verbose=False, seed=int(req.get("seed", 0)))

    def _run(self):
        from ..api import chat

        while True:
            req, done, stream = self.q.get()
            if stream:
                self._stream(req, done)
                continue
            try:
                response, history = chat(self.model, **self._chat_args(req))
                done.put({"response": response, "history": history})
            except Exception as e:  # noqa: BLE001 — report to the client
                logger.exception("chat request failed")
                done.put({"error": str(e)})

    def _stream(self, req: dict, out: "queue.Queue") -> None:
        """Run one stream on the worker thread: ('item', dict) ... then
        ('end', None), or ('error', message)."""
        from ..api import chat_in_stream

        try:
            response, history = "", None
            for response, history in chat_in_stream(self.model, **self._chat_args(req)):
                out.put(("item", {"partial": response}))
            out.put(("item", {"response": response,
                              "history": history or req.get("history") or []}))
            out.put(("end", None))
        except Exception as e:  # noqa: BLE001 — report to the client
            logger.exception("stream request failed")
            out.put(("error", str(e)))

    def submit(self, req: dict, timeout: float = 600.0) -> dict:
        done: queue.Queue = queue.Queue()
        self.q.put((req, done, False))
        return done.get(timeout=timeout)

    def submit_stream(self, req: dict, timeout: float = 600.0):
        """Yield {'partial': str} items, then the final response dict, as the
        worker thread produces them (one stream or chat at a time)."""
        out: queue.Queue = queue.Queue()
        self.q.put((req, out, True))
        while True:
            kind, payload = out.get(timeout=timeout)
            if kind == "end":
                return
            if kind == "error":
                raise RuntimeError(payload)
            yield payload


def make_handler(worker):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/health":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/chat", "/chat_stream"):
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._send(400, {"error": "invalid json"})
                return
            if "text" not in req:
                self._send(400, {"error": "missing 'text'"})
                return
            if self.path == "/chat_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson; charset=utf-8")
                self.end_headers()
                try:
                    for item in worker.submit_stream(req):
                        self.wfile.write((json.dumps(item, ensure_ascii=False) + "\n").encode())
                        self.wfile.flush()
                except Exception as e:  # noqa: BLE001 — the status line is sent
                    logger.exception("stream request failed")
                    self.wfile.write((json.dumps({"error": str(e)}) + "\n").encode())
                return
            try:
                result = worker.submit(req)
            except Exception as e:  # noqa: BLE001 — report to the client
                logger.exception("chat request failed")
                result = {"error": str(e)}
            self._send(200 if "error" not in result else 500, result)

        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s - %s", self.address_string(), fmt % args)

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--visualcla_model", required=True)
    ap.add_argument("--load_in_8bit", action="store_true")
    ap.add_argument("--load_in_4bit", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the server never falls back to the CPU")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8091)
    ap.add_argument("--pool", type=int, default=0,
                    help="pool rows (0 = one worker serving requests in turn)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV pool (memory = tokens, not rows x max_seq_len)")
    ap.add_argument("--block_size", type=int, default=64)
    ap.add_argument("--num_blocks", type=int, default=0,
                    help="KV pool size in blocks (default pool*16)")
    ap.add_argument("--kv_int8", action="store_true",
                    help="int8 paged KV pool (half the bytes; needs --paged)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .. import api

    model, _, _ = api.get_model_and_tokenizer_and_processor(
        visualcla_model=args.visualcla_model, load_in_8bit=args.load_in_8bit,
        load_in_4bit=args.load_in_4bit, device=args.device)
    worker = (PoolWorker(model, args.pool, paged=args.paged, block_size=args.block_size,
                         num_blocks=args.num_blocks,
                         kv_quant="int8" if args.kv_int8 else "none")
              if args.pool > 0 else ChatWorker(model))
    server = ThreadingHTTPServer((args.host, args.port), make_handler(worker))
    logger.info("serving on %s:%d", args.host, args.port)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        worker.close()


if __name__ == "__main__":
    main()
