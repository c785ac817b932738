"""Batch evaluator over the reference's golden question sets (port of
visualcla_tpu/apps/evaluate.py).

Replays a question set (one single-turn chat per question, greedy by
default) and writes predictions in the reference's format: the input records
plus an ``output`` field.  Each chunk of ``batch_size`` questions is one
left-padded ``generate`` call, so its images go through one image encode.

Usage:
  python -m visualcla_tpu_torch.apps.evaluate --visualcla_model DIR \\
      --questions llava --image_dir IMGS --output predictions.json \\
      [--sample] [--device cuda|cpu]

An image file may be any format Pillow reads, or a ``.npy`` uint8 (H, W, 3)
array under the question's file name (numpy alone reads it).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np

logger = logging.getLogger(__name__)


def evaluate(model, questions: list, image_dir: str, *, sampling=None, batch_size: int = 8,
             seed: int = 0) -> list:
    """The question records, each with its generated ``output``."""
    from ..engine.sampling import SamplingConfig
    from ..text import encoding_text

    sampling = sampling or SamplingConfig.greedy()
    tok = model.tokenizer
    results = []
    t0 = time.time()
    for start in range(0, len(questions), batch_size):
        chunk = questions[start:start + batch_size]
        encs, pixels = [], []
        for q in chunk:
            enc = encoding_text([], q["instruction"], model.num_patch, tok)
            encs.append(enc["input_ids"][0])
            img_path = os.path.join(image_dir, q["image"]) if image_dir else q["image"]
            pixels.append(model.image_processor.preprocess_one(img_path))
        # left-pad the chunk to one prompt length (the engine re-pads to a bucket)
        L = max(len(e) for e in encs)
        ids = np.full((len(encs), L), tok.pad_token_id, np.int64)
        for i, e in enumerate(encs):
            ids[i, L - len(e):] = e
        out = model.generate(ids, pixel_values=np.stack(pixels), generation_config=sampling,
                             seed=seed)
        for q, row in zip(chunk, out):
            rec = dict(q)
            rec["output"] = tok.decode(row, skip_special_tokens=True)
            results.append(rec)
        logger.info("evaluated %d/%d (%.1fs)", start + len(chunk), len(questions),
                    time.time() - t0)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--visualcla_model", required=True)
    ap.add_argument("--questions", default="llava",
                    help="question set json (reference examples/ format), or a "
                         "shorthand for the vendored sets: 'llava' / 'owl'")
    ap.add_argument("--image_dir", default="", help="directory holding the referenced images")
    ap.add_argument("--output", required=True)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--load_in_8bit", action="store_true")
    ap.add_argument("--load_in_4bit", action="store_true")
    ap.add_argument("--sample", action="store_true",
                    help="use the reference default sampling instead of greedy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back to the CPU")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .. import api
    from ..assets import golden_path
    from ..engine.sampling import SamplingConfig

    model, _, _ = api.get_model_and_tokenizer_and_processor(
        visualcla_model=args.visualcla_model, load_in_8bit=args.load_in_8bit,
        load_in_4bit=args.load_in_4bit, device=args.device)
    questions_path = (args.questions if os.path.isfile(args.questions)
                      else golden_path(args.questions))
    with open(questions_path) as f:
        questions = json.load(f)
    sampling = SamplingConfig() if args.sample else SamplingConfig.greedy()
    results = evaluate(model, questions, args.image_dir, sampling=sampling,
                       batch_size=args.batch_size, seed=args.seed)
    with open(args.output, "w") as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    logger.info("wrote %d predictions -> %s", len(results), args.output)


if __name__ == "__main__":
    main()
