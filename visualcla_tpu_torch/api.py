"""Public API (port of visualcla_tpu/api.py): ``VisualCLA``, ``chat``,
``chat_in_stream`` and ``get_model_and_tokenizer_and_processor`` on PyTorch.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item
that brings them: int8/int4 weights and the int8 KV cache (open item 1),
beam search (7), speculative decoding (5), multi-device meshes (11), and
loading from reference-layout or unmerged/LoRA directories (9).
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from visualcla_tpu.core.config import VisualCLAConfig
from visualcla_tpu.processor import ImageProcessor, VisualCLAProcessor
from visualcla_tpu.text import VisualCLATokenizer, encoding_text
from visualcla_tpu.text.prompt import all_img_marker_positions, img_marker_positions

from .checkpoint.from_jax import params_from_jax
from .engine.generate import Engine
from .engine.sampling import SamplingConfig
from .models.visualcla import VisualCLAModel

DEFAULT_GENERATION_CONFIG = SamplingConfig()  # the reference's default sampled config


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP, open item {item})")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


class VisualCLA:
    """The loaded model bundle: modules on the device, the engine, and the
    host tooling (tokenizer, image processor).

    ``params_or_modules`` is a ``VisualCLAModel`` (used as it is) or the JAX
    package's parameter tree, nested or flat, as numpy arrays (converted and
    placed on ``device`` in ``dtype``)."""

    def __init__(self, params_or_modules, config: VisualCLAConfig,
                 tokenizer: VisualCLATokenizer, image_processor: ImageProcessor, *,
                 dtype=torch.bfloat16, device=None, max_seq_len: int = 2048,
                 kv_quant: str = "none", mesh=None):
        if mesh is not None:
            raise _not_ported("a multi-device mesh", "11: multi-device")
        if kv_quant != "none":
            raise _not_ported(f"kv_quant={kv_quant!r}", "1: quantized tiers")
        if isinstance(params_or_modules, VisualCLAModel):
            model = params_or_modules
        else:
            model = VisualCLAModel(config, device=device or _default_device(), dtype=dtype)
            model.load_state_dict(params_from_jax(_flatten(params_or_modules), config))
        self.model = model
        self.config = config
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.image_at_head = False
        self.num_patch = config.num_image_tokens
        self.engine = Engine(model, config, eos_token_id=tokenizer.eos_token_id,
                             pad_token_id=tokenizer.pad_token_id,
                             max_seq_len=max_seq_len)

    def _img_positions(self, input_ids, pixel_values) -> np.ndarray:
        """Marker positions: (B,) for one image per row, (B, K) for K images
        (-1 = unused); more markers than images raises."""
        if pixel_values is None or np.asarray(pixel_values).ndim != 5:
            return img_marker_positions(input_ids, self.tokenizer.img_start_token_id)
        img_pos = all_img_marker_positions(input_ids, self.tokenizer.img_start_token_id)
        K = np.asarray(pixel_values).shape[1]
        n_markers = int((img_pos >= 0).sum(axis=1).max())
        if n_markers > K:
            raise ValueError(f"prompt carries {n_markers} <img> markers but only "
                             f"{K} images were provided")
        if img_pos.shape[1] < K:
            img_pos = np.concatenate(
                [img_pos, np.full((img_pos.shape[0], K - img_pos.shape[1]), -1,
                                  np.int32)], axis=1)
        return img_pos[:, :K]

    def _check(self, sampling: SamplingConfig, speculative: bool) -> None:
        if sampling.num_beams > 1:
            raise _not_ported("beam search", "7: beams")
        if speculative:
            raise _not_ported("speculative decoding", "5: speculative decoding")

    def generate(self, input_ids, attention_mask=None, pixel_values=None,
                 generation_config=None, seed: int = 0,
                 speculative: bool = False) -> np.ndarray:
        """Generated-only ids (B, <= max_new_tokens), the reference's
        VisualCLAModel.generate contract."""
        sampling = as_sampling_config(generation_config)
        self._check(sampling, speculative)
        nrs = sampling.num_return_sequences
        if nrs > 1:
            if not sampling.do_sample:
                raise ValueError(
                    "Greedy methods without beam search do not support "
                    f"num_return_sequences different than 1 (got {nrs}); set "
                    "do_sample=True or num_beams>1")
            input_ids = np.repeat(np.asarray(input_ids), nrs, axis=0)
            if pixel_values is not None:
                pixel_values = np.repeat(np.asarray(pixel_values), nrs, axis=0)
        img_pos = self._img_positions(input_ids, pixel_values)
        return self.engine.generate(input_ids, pixel_values, img_pos, sampling, seed=seed)

    def stream_generate(self, input_ids, pixel_values=None, generation_config=None,
                        seed: int = 0, speculative: bool = False):
        sampling = as_sampling_config(generation_config)
        self._check(sampling, speculative)
        img_pos = self._img_positions(input_ids, pixel_values)
        return self.engine.stream(input_ids, pixel_values, img_pos, sampling, seed=seed)


def as_sampling_config(gc) -> SamplingConfig:
    """Accept SamplingConfig / dict / HF-style object / None."""
    if gc is None:
        return DEFAULT_GENERATION_CONFIG
    if isinstance(gc, SamplingConfig):
        return gc
    fields = {f.name for f in dataclasses.fields(SamplingConfig)}
    if isinstance(gc, dict):
        return SamplingConfig(**{k: v for k, v in gc.items() if k in fields})
    return SamplingConfig(**{f: getattr(gc, f) for f in fields
                             if getattr(gc, f, None) is not None})


def get_model_and_tokenizer_and_processor(
    visualcla_model: Optional[str] = None,
    text_model: Optional[str] = None,
    vision_model: Optional[str] = None,
    lora_model: Optional[str] = None,
    torch_dtype=None,  # accepted for API compatibility; ``dtype`` rules
    default_device=None,  # accepted for API compatibility; ``device`` rules
    device_map=None,  # accepted for API compatibility
    load_in_8bit: bool = False,
    *,
    load_in_4bit: bool = False,
    dtype=torch.bfloat16,
    device=None,
    max_seq_len: int = 2048,
    mesh=None,
    kv_quant: str = "none",
):
    """Load (model, tokenizer, processor) from a native checkpoint directory
    (``params.safetensors`` + ``config.json`` + tokenizer files)."""
    from .checkpoint.serialize import load_checkpoint

    if load_in_8bit or load_in_4bit:
        raise _not_ported("load_in_8bit / load_in_4bit", "1: quantized tiers")
    if kv_quant != "none":
        raise _not_ported(f"kv_quant={kv_quant!r}", "1: quantized tiers")
    if mesh is not None:
        raise _not_ported("a multi-device mesh", "11: multi-device")
    if visualcla_model is None or lora_model is not None:
        raise _not_ported("loading base text/vision models with LoRA adapters",
                          "9: checkpoint conversion")
    if not os.path.exists(os.path.join(visualcla_model, "params.safetensors")):
        raise _not_ported("loading a reference-layout merged directory",
                          "9: checkpoint conversion")
    tokenizer = VisualCLATokenizer.from_pretrained(visualcla_model)
    model, cfg = load_checkpoint(visualcla_model, device=device or _default_device(),
                                 dtype=dtype)
    if os.path.exists(os.path.join(visualcla_model, "preprocessor_config.json")):
        image_processor = ImageProcessor.from_pretrained(visualcla_model)
    else:  # size to the vision tower so the patch count matches its table
        image_processor = ImageProcessor(image_size=cfg.vision_config.image_size)
    image_processor.patch_size = cfg.vision_config.patch_size
    bundle = VisualCLA(model, cfg, tokenizer, image_processor,
                       max_seq_len=max_seq_len, kv_quant=kv_quant)
    return bundle, tokenizer, VisualCLAProcessor(image_processor, tokenizer)


# ---------------------------------------------------------------------------
# chat (reference modeling_utils.py:143-247)
# ---------------------------------------------------------------------------

def _one_pixel_values(model: VisualCLA, image) -> np.ndarray:
    """str path / PIL / uint8 (H, W, 3) / premade pixels -> (1, 3, H, W)."""
    if isinstance(image, str) or hasattr(image, "convert"):
        return np.asarray(model.image_processor(image)["pixel_values"])
    pv = np.asarray(image)
    if pv.dtype == np.uint8 and pv.ndim == 3:
        return np.asarray(model.image_processor(pv)["pixel_values"])
    return pv if pv.ndim == 4 else pv[None]


def _prepare_inputs(model: VisualCLA, image, text, history):
    """(encoded prompt, pixel_values) for a chat turn; records the
    instruction in ``history``.  One image: the placeholder lives in the
    first instruction and the caller re-passes the image each turn.  A LIST
    of images: this turn gets one placeholder per image, the history keeps
    the pixels, and pixel_values stack to (1, K, 3, H, W)."""
    multi = isinstance(image, (list, tuple)) or any(h.get("images_pv") for h in history)
    if not multi:
        pixel_values = None if image is None else _one_pixel_values(model, image)
        test_input = encoding_text(history, text, model.num_patch, model.tokenizer)
        entry = {"type": "instruction", "value": text}
        if not history:
            entry["first_instruction"] = True
        history.append(entry)
        return test_input, pixel_values
    imgs = [] if image is None else (
        list(image) if isinstance(image, (list, tuple)) else [image])
    turn_pv = [_one_pixel_values(model, im) for im in imgs]
    test_input = encoding_text(history, text, model.num_patch, model.tokenizer,
                               num_images=len(turn_pv))
    all_pv = [pv for h in history for pv in (h.get("images_pv") or [])] + turn_pv
    entry = {"type": "instruction", "value": text, "images": len(turn_pv),
             "images_pv": turn_pv}
    if not history:
        entry["first_instruction"] = True
    history.append(entry)
    if not all_pv:
        return test_input, None
    return test_input, np.stack(all_pv, axis=1)


def chat(model: VisualCLA, image: Union[str, object, None], text: str,
         history: Optional[list] = None, generation_config=None, *,
         verbose: bool = True, seed: int = 0,
         speculative: bool = False) -> Tuple[str, list]:
    """Blocking chat turn; mutates and returns ``history``."""
    if history is None:
        history = []
    test_input, pixel_values = _prepare_inputs(model, image, text, history)
    outputs = model.generate(test_input["input_ids"], pixel_values=pixel_values,
                             generation_config=generation_config, seed=seed,
                             speculative=speculative)
    response = model.tokenizer.decode(outputs[0], skip_special_tokens=True)
    history.append({"type": "response", "value": response})
    if verbose:
        print("Response:", response)
        print("History:", history)
    return response, history


def chat_in_stream(model: VisualCLA, image: Union[str, object, None], text: str,
                   history: Optional[list] = None, generation_config=None, *,
                   verbose: bool = True, seed: int = 0,
                   speculative: bool = False) -> Iterator[Tuple[str, list]]:
    """Streaming chat turn: yields (partial response, history) per token,
    with the reference's '▁'-prefix space fixup."""
    if history is None:
        history = []
    sampling = as_sampling_config(generation_config)
    test_input, pixel_values = _prepare_inputs(model, image, text, history)
    old_history = copy.deepcopy(history)
    eos = model.tokenizer.eos_token_id
    gen_ids: list = []
    response = ""
    for step_tokens in model.stream_generate(test_input["input_ids"], pixel_values,
                                             sampling, seed=seed,
                                             speculative=speculative):
        tok = int(step_tokens[0])
        if tok == eos:
            break
        gen_ids.append(tok)
        response = model.tokenizer.decode(gen_ids, skip_special_tokens=True)
        if model.tokenizer.convert_ids_to_tokens([gen_ids[0]])[0].startswith("▁"):
            response = " " + response
        history = copy.deepcopy(old_history)
        history.append({"type": "response", "value": response})
        yield response, history
    if verbose:
        print("Response:", response)
        print("History:", history)
