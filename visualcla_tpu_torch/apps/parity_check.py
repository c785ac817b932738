"""Token-identity harness: the port's greedy outputs against a live HF
reference (port of visualcla_tpu/apps/parity_check.py).

It takes a reference-layout merged checkpoint (``text_encoder/`` +
``vision_encoder/`` + ``pytorch_model.bin``) and a question set, runs both
stacks greedily, and reports per-question token agreement:

  python -m visualcla_tpu_torch.apps.parity_check \
      --merged_model MERGED --reference_dir VISUAL_CHINESE_LLAMA_ALPACA \
      --native_model NATIVE(optional; else converts) --questions llava \
      --image_dir coco_val2014 --limit 10 --max_new_tokens 64 [--device cpu]

The HF side rebuilds the reference pipeline from its checkpoint pieces on
the CPU in fp32 (CLIP-ViT -> full-sequence post_layernorm -> resampler ->
projection -> LLaMA ``generate(inputs_embeds=...)``), as the reference's
modeling_visualcla.py generates; its resampler class comes from the
reference checkout's ``models/visualcla/modeling_visual_resampler.py``
(``--reference_dir``).  It needs ``transformers``.  The port's side loads
the native checkpoint in fp32 on the card (``--device cpu``: on the CPU).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
import sys

import numpy as np

logger = logging.getLogger(__name__)


def load_reference_resampler_module(reference_dir: str):
    """Import the reference's resampler module file directly (its package
    ``__init__`` needs an older transformers); None without the file."""
    path = os.path.join(reference_dir, "models", "visualcla", "modeling_visual_resampler.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("ref_visual_resampler", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ref_visual_resampler"] = mod
    spec.loader.exec_module(mod)
    return mod


class HFReference:
    """The reference pipeline reassembled from a merged checkpoint (torch
    CPU, fp32).  ``resampler_module`` provides ``VisualResamplerConfig`` and
    ``VisualResamplerModel`` (the reference's module)."""

    def __init__(self, merged_dir: str, resampler_module):
        import torch
        from transformers import CLIPVisionModel, LlamaForCausalLM

        from ..checkpoint.torch_io import load_state_dict

        self.torch = torch
        self.text = LlamaForCausalLM.from_pretrained(
            os.path.join(merged_dir, "text_encoder"),
            attn_implementation="eager", torch_dtype=torch.float32,
        ).eval()
        self.vision = CLIPVisionModel.from_pretrained(
            os.path.join(merged_dir, "vision_encoder"),
            attn_implementation="eager", torch_dtype=torch.float32,
        ).eval()
        with open(os.path.join(merged_dir, "config.json")) as f:
            cfg = json.load(f)
        res_cfg = resampler_module.VisualResamplerConfig(
            **cfg["visual_resampler_config"]
        )
        self.resampler = resampler_module.VisualResamplerModel(
            res_cfg, add_pooling_layer=False
        ).eval()
        root_sd = load_state_dict(merged_dir)
        res_sd = {k[len("visual_resampler."):]: v.float()
                  for k, v in root_sd.items() if k.startswith("visual_resampler.")}
        self.resampler.load_state_dict(res_sd, strict=False)
        self.proj_w = root_sd["image_projection_layer.weight"].float()
        self.proj_b = root_sd["image_projection_layer.bias"].float()

    @property
    def device(self):
        return "cpu"

    def generate_greedy(self, input_ids, pixel_values, img_start_pos,
                        max_new_tokens: int, img_token_span: int):
        """The reference's VisualCLAModel.generate: splice the projected
        image embeddings over the placeholder span and generate from
        ``inputs_embeds`` (the returned ids are the generated ones only)."""
        torch = self.torch
        with torch.no_grad():
            ids = torch.from_numpy(np.asarray(input_ids, np.int64))
            embeds = self.text.get_input_embeddings()(ids)  # (1, S, H)
            if pixel_values is not None:
                pix = torch.from_numpy(np.asarray(pixel_values, np.float32))
                vout = self.vision(pix, output_hidden_states=False)
                hidden = self.vision.vision_model.post_layernorm(
                    vout.last_hidden_state
                )
                res = self.resampler(encoder_hidden_states=hidden)[0]
                img_embeds = res @ self.proj_w.T + self.proj_b  # (1, T, H)
                p = int(img_start_pos)
                T = img_embeds.shape[1]
                embeds = torch.cat(
                    [embeds[:, : p + 1], img_embeds, embeds[:, p + 1 + T:]], dim=1
                )
            out = self.text.generate(
                inputs_embeds=embeds,
                attention_mask=torch.ones(embeds.shape[:2], dtype=torch.long),
                max_new_tokens=max_new_tokens, do_sample=False,
                num_beams=1, temperature=None, top_p=None, top_k=None,
            )
            return np.asarray(out[0])


def run_parity(native_model: str, merged_model: str, questions, image_dir: str,
               max_new_tokens: int = 64, limit: int = 0, *, resampler_module=None,
               reference_dir: str = None, device=None):
    """Both stacks greedily on each question -> one record a question:
    ``exact``, ``match`` (equal tokens over the shorter output), both
    lengths and the port's text.  ``resampler_module`` defaults to the
    reference's, loaded from ``reference_dir``."""
    import torch

    from .. import api
    from ..engine.sampling import SamplingConfig
    from ..text import encoding_text
    from ..text.prompt import img_marker_positions

    if resampler_module is None:
        resampler_module = load_reference_resampler_module(reference_dir or "")
        if resampler_module is None:
            raise FileNotFoundError(
                f"no models/visualcla/modeling_visual_resampler.py under {reference_dir!r}: "
                "pass --reference_dir, the reference's checkout")
    model, tokenizer, _ = api.get_model_and_tokenizer_and_processor(
        visualcla_model=native_model, dtype=torch.float32, device=device)
    ref = HFReference(merged_model, resampler_module)

    if limit:
        questions = questions[:limit]
    sampling = SamplingConfig.greedy(max_new_tokens=max_new_tokens)
    results = []
    for q in questions:
        # the llava set uses "instruction", owl "question" (the vendored
        # examples/*.json keep the reference's field names)
        text = q.get("instruction") or q["question"]
        enc = encoding_text([], text, model.num_patch, tokenizer)
        ids = enc["input_ids"]
        img_pos = img_marker_positions(ids, tokenizer.img_start_token_id)
        pix = None
        if q.get("image"):
            pix = model.image_processor(
                os.path.join(image_dir, q["image"]))["pixel_values"]
        ours = model.generate(ids, pixel_values=pix, generation_config=sampling)[0]
        theirs = ref.generate_greedy(ids, pix, int(img_pos[0]),
                                     max_new_tokens, model.num_patch)
        n = min(len(ours), len(theirs))
        match = int(np.sum(np.asarray(ours[:n]) == np.asarray(theirs[:n])))
        exact = (len(ours) == len(theirs)) and match == n
        results.append({
            "question_id": q.get("question_id"),
            "exact": bool(exact),
            "match": match, "ours_len": int(len(ours)),
            "theirs_len": int(len(theirs)),
            "ours": tokenizer.decode(ours),
        })
        logger.info("q%s exact=%s (%d/%d tokens)",
                    q.get("question_id"), exact, match, n)
    n_exact = sum(r["exact"] for r in results)
    logger.info("token-identical: %d/%d questions", n_exact, len(results))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--merged_model", required=True,
                    help="reference-layout merged checkpoint")
    ap.add_argument("--reference_dir", default=None,
                    help="the reference's checkout (for its resampler module)")
    ap.add_argument("--native_model", default=None,
                    help="converted native checkpoint (defaults to converting "
                         "the merged one into a temp dir)")
    ap.add_argument("--questions", default="llava",
                    help="question set json, or a shorthand for the vendored "
                         "sets: 'llava' / 'owl'")
    ap.add_argument("--image_dir", default="")
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default=None, help="the port's device (default: cuda)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..assets import golden_path

    questions_path = (args.questions if os.path.isfile(args.questions)
                      else golden_path(args.questions))
    with open(questions_path) as f:
        questions = json.load(f)

    native = args.native_model
    tmp = None
    if native is None:
        import tempfile

        from ..checkpoint import convert_merged

        tmp = tempfile.TemporaryDirectory()
        native = tmp.name
        convert_merged(args.merged_model, native, dtype="float32")
    try:
        results = run_parity(native, args.merged_model, questions, args.image_dir,
                             args.max_new_tokens, args.limit,
                             reference_dir=args.reference_dir, device=args.device)
    finally:
        if tmp is not None:
            tmp.cleanup()
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
    n_exact = sum(r["exact"] for r in results)
    print(f"token-identical greedy: {n_exact}/{len(results)}")
    return results


if __name__ == "__main__":
    main()
