"""Public API (port of visualcla_tpu/api.py): ``VisualCLA``, ``chat``,
``chat_in_stream``, ``get_model_and_tokenizer_and_processor``,
``load_generation_preset`` and ``hijack_samplers`` on PyTorch.

The weight tiers load as in the JAX package: ``load_in_8bit`` (int8 text
tower), ``load_in_4bit`` (grouped int4 text tower, kernel B3; it wins when
both are set), and ``kv_quant="int8"`` (int8 KV cache) with either.
``speculative=True`` decodes with prompt-lookup speculative decoding
(``engine/speculative.py``; greedy: token-identical in exact arithmetic;
mirostat-2 configs take the plain engine).  ``num_beams > 1`` runs beam
search (``engine/beam.py``; sampled with ``do_sample``), each batch row its
own search, with ``num_return_sequences`` hypotheses a row: greedy beams with
one hypothesis take the device-resident ``beam_generate_fused`` unless
``VISUALCLA_BEAM=host`` (the JAX package's switch) asks for the host scorer.
``VisualCLA.extend_to_resolution`` and ``prune_resampler_heads`` change the
vision side in place.  The factory loads a native checkpoint, a reference
merged directory, or base ``text_model`` + ``vision_model`` directories with
``lora_model`` adapters folded in (``checkpoint/convert.py``), straight onto
the device.  ``mesh=`` serves over a ``torch.distributed`` device mesh
(``parallel/``): tensor, data and context parallelism, one process per
device, every rank making the same calls.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .core.config import VisualCLAConfig
from .processor import ImageProcessor, VisualCLAProcessor
from .text import VisualCLATokenizer, encoding_text
from .text.prompt import all_img_marker_positions, img_marker_positions

from .checkpoint.from_jax import build_model
from .checkpoint.serialize import flatten_tree
from .engine.beam import beam_generate, beam_generate_fused, beam_sample_generate
from .engine.generate import Engine
from .engine.sampling import SamplingConfig
from .engine.speculative import SpeculativeDecoder
from .models.visualcla import VisualCLAModel
from .ops.attention import attention_mesh_scope
from .parallel.sharding import check_mesh

logger = logging.getLogger(__name__)

DEFAULT_GENERATION_CONFIG = SamplingConfig()  # the reference's default sampled config


def _default_device() -> torch.device:
    """The card: the port's entry points run on a CUDA device unless the
    caller passes ``device="cpu"``; without a GPU they raise."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by default. "
            'Pass device="cpu" to run on the CPU.')
    return torch.device("cuda")


class VisualCLA:
    """The loaded model bundle: modules on the device, the engine, and the
    host tooling (tokenizer, image processor).

    ``mesh`` (a ``DeviceMesh``, ``parallel.sharding.make_mesh``): the model
    is sharded over it (``shard_params``, unless the load sharded it
    already) and every call runs over it.  One process per device: every
    rank calls every method with the same arguments and gets the same
    result.

    ``params_or_modules`` is a ``VisualCLAModel`` (used as it is) or the JAX
    package's parameter tree, nested or flat, as numpy arrays (converted and
    placed on ``device`` in ``dtype``; quantized leaves keep their tier).
    ``kv_quant``: "none" or "int8"."""

    def __init__(self, params_or_modules, config: VisualCLAConfig,
                 tokenizer: VisualCLATokenizer, image_processor: ImageProcessor, *,
                 dtype=torch.bfloat16, device=None, max_seq_len: int = 2048,
                 kv_quant: str = "none", mesh=None):
        check_mesh(mesh)
        if isinstance(params_or_modules, VisualCLAModel):
            model = params_or_modules
        else:  # quantized and LoRA leaves keep their form
            model = build_model(flatten_tree(params_or_modules), config,
                                device=device or _default_device(), dtype=dtype, mesh=mesh)
        self.mesh = mesh
        self.model = model
        self.config = config
        self.tokenizer = tokenizer
        self.image_processor = image_processor
        self.image_at_head = False
        self.num_patch = config.num_image_tokens
        self.engine = Engine(model, config, eos_token_id=tokenizer.eos_token_id,
                             pad_token_id=tokenizer.pad_token_id,
                             max_seq_len=max_seq_len, kv_quant=kv_quant, mesh=mesh)
        self._spec_decoders: dict = {}  # (spec_k, max_ngram) -> SpeculativeDecoder

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

    def prune_resampler_heads(self, heads_to_prune: dict) -> None:
        """Prune resampler attention heads, ``{layer: [head, ...]}``, in place
        (``models.resampler.prune_heads``)."""
        from .models.resampler import prune_heads

        prune_heads(self.model.resampler, heads_to_prune)

    def extend_to_resolution(self, after: int) -> None:
        """Bicubic-resize the ViT position table for ``after``-pixel inputs and
        update the configs, the image processor's size and crop, and
        ``num_patch`` (which grows only when the resampler is off)."""
        from .models.clip_vit import extend_position_embedding

        extend_position_embedding(self.model.vision, after)
        vcfg = self.config.vision_config
        self.config = dataclasses.replace(
            self.config, vision_config=dataclasses.replace(vcfg, image_size=after))
        self.model.cfg = self.engine.cfg = self.config
        self.image_processor.image_size = after
        self.image_processor.crop_size = after
        self.num_patch = self.config.num_image_tokens

    @classmethod
    def from_merged_pretrained(cls, visualcla_model: str, **kwargs) -> "VisualCLA":
        """Load from a merged checkpoint directory, native or reference
        layout (the factory's options as keywords)."""
        model, _, _ = get_model_and_tokenizer_and_processor(
            visualcla_model=visualcla_model, **kwargs)
        return model

    @classmethod
    def from_vision_text_pretrained(cls, vision_model: str, text_model: str,
                                    lora_model: Optional[str] = None, **kwargs) -> "VisualCLA":
        """Compose from separate vision / text checkpoints (+ optional LoRA,
        folded at load)."""
        model, _, _ = get_model_and_tokenizer_and_processor(
            text_model=text_model, vision_model=vision_model, lora_model=lora_model, **kwargs)
        return model

    def speculative_decoder(self, spec_k: int = 8, max_ngram: int = 3):
        """The cached prompt-lookup speculative decoder over this model's
        engine (see ``engine/speculative.py``)."""
        key = (spec_k, max_ngram)
        if key not in self._spec_decoders:
            self._spec_decoders[key] = SpeculativeDecoder(self.engine, spec_k, max_ngram)
        return self._spec_decoders[key]

    def _decoder(self, sampling: SamplingConfig, speculative: bool, spec_k: int):
        """The engine or the speculative decoder (mirostat-2 configs take
        the plain engine)."""
        if speculative and sampling.mirostat_mode != 2:
            return self.speculative_decoder(spec_k)
        return self.engine

    def generate(self, input_ids, attention_mask=None, pixel_values=None,
                 generation_config=None, seed: int = 0, speculative: bool = False,
                 spec_k: int = 8) -> np.ndarray:
        """Generated-only ids (B, <= max_new_tokens), the reference's
        VisualCLAModel.generate contract."""
        sampling = as_sampling_config(generation_config)
        # HF num_return_sequences: sampled -> each row repeated n times
        # (independent draws); beams -> the top n hypotheses a row; greedy
        # -> HF raises, and so does this
        nrs = sampling.num_return_sequences
        beams = sampling.num_beams > 1
        if nrs > 1:
            if beams:
                if nrs > sampling.num_beams:
                    raise ValueError("num_return_sequences has to be smaller or equal to "
                                     f"num_beams ({nrs} > {sampling.num_beams})")
            elif not sampling.do_sample:
                raise ValueError(
                    "Greedy methods without beam search do not support "
                    f"num_return_sequences different than 1 (got {nrs}); set "
                    "do_sample=True or num_beams>1")
            else:
                input_ids = np.repeat(np.asarray(input_ids), nrs, axis=0)
                if pixel_values is not None:
                    pixel_values = np.repeat(np.asarray(pixel_values), nrs, axis=0)
        img_pos = self._img_positions(input_ids, pixel_values)
        if beams:
            if pixel_values is not None and np.asarray(pixel_values).ndim == 5:
                raise NotImplementedError("beam search over multi-image prompts is not "
                                          "supported; use greedy/sampling")
            return self._batched_beam(sampling, input_ids, pixel_values, img_pos, seed)
        decoder = self._decoder(sampling, speculative, spec_k)
        return decoder.generate(input_ids, pixel_values, img_pos, sampling, seed=seed)

    def _beam_row(self, sampling: SamplingConfig, ids, pix, pos, seed: int):
        """One prompt row's beam search (sampled with ``do_sample``) on the
        engine's cache width and KV format, under the engine's mesh scope
        (over a mesh every row runs on every data rank)."""
        with attention_mesh_scope(self.mesh):
            return self._beam_row_scoped(sampling, ids, pix, pos, seed)

    def _beam_row_scoped(self, sampling: SamplingConfig, ids, pix, pos, seed: int):
        kw = dict(eos_token_id=self.tokenizer.eos_token_id,
                  pad_token_id=self.tokenizer.pad_token_id,
                  cache_slots=self.engine.max_seq_len, kv_quant=self.engine.kv_quant)
        if sampling.do_sample:
            gen = torch.Generator(device=self.engine.device).manual_seed(seed)
            return beam_sample_generate(self.model, self.config, ids, pix, pos, sampling,
                                        generator=gen, **kw)
        kw.update(num_beams=sampling.num_beams, max_new_tokens=sampling.max_new_tokens,
                  length_penalty=sampling.length_penalty,
                  early_stopping=sampling.early_stopping)
        # the device-resident scorer by default, as in the JAX package;
        # VISUALCLA_BEAM=host keeps the host scorer, and the top-n
        # hypotheses need its BeamHypotheses (the fused loop keeps the best)
        nrs = sampling.num_return_sequences
        if os.environ.get("VISUALCLA_BEAM") == "host" or nrs > 1:
            return beam_generate(self.model, self.config, ids, pix, pos,
                                 num_return_sequences=nrs, **kw)
        return beam_generate_fused(self.model, self.config, ids, pix, pos, **kw)

    def _batched_beam(self, sampling: SamplingConfig, input_ids, pixel_values, img_pos,
                      seed: int) -> np.ndarray:
        """HF semantics for batched beam search: every batch row runs its own
        search (row b sampled with seed ``seed + b``), one after another,
        right-padded to the longest hypothesis.  With num_return_sequences
        n > 1 each row gives n consecutive output rows, best first."""
        input_ids = np.asarray(input_ids)
        outs = []
        for b in range(input_ids.shape[0]):
            pix = None if pixel_values is None else np.asarray(pixel_values)[b:b + 1]
            out = self._beam_row(sampling, input_ids[b:b + 1], pix, img_pos[b:b + 1], seed + b)
            outs.extend(out if isinstance(out, list) else [out])
        T = max(len(o) for o in outs)
        pad = self.tokenizer.pad_token_id
        return np.stack([np.concatenate([o, np.full((T - len(o),), pad, np.int64)])
                         for o in outs])

    def stream_generate(self, input_ids, pixel_values=None, generation_config=None,
                        seed: int = 0, chunk_size: int = 1, speculative: bool = False,
                        spec_k: int = 8):
        """Yield each step's (B,) tokens; ``chunk_size`` decode steps run
        between host reads (the speculative decoder reads once a verify chunk
        whatever ``chunk_size`` is)."""
        sampling = as_sampling_config(generation_config)
        if sampling.num_beams > 1:
            raise ValueError("streaming does not run beam search (num_beams > 1): call "
                             "generate / chat, as HF's streamers refuse beams")
        decoder = self._decoder(sampling, speculative, spec_k)
        img_pos = self._img_positions(input_ids, pixel_values)
        if decoder is self.engine:
            return decoder.stream(input_ids, pixel_values, img_pos, sampling, seed=seed,
                                  chunk_size=chunk_size)
        return decoder.stream(input_ids, pixel_values, img_pos, sampling, seed=seed)


def load_generation_preset(name: str) -> SamplingConfig:
    """Named preset from configs/generation_presets.json (mirrors the
    reference's webui preset YAMLs, settings/VisualCLA-Inference.yaml)."""
    path = os.path.join(os.path.dirname(__file__), "configs", "generation_presets.json")
    with open(path) as f:
        presets = json.load(f)
    if name not in presets or name.startswith("_"):
        raise KeyError(f"unknown preset {name!r}; available: "
                       f"{[k for k in presets if not k.startswith('_')]}")
    return as_sampling_config({k: v for k, v in presets[name].items()
                               if not k.startswith("_")})


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
    """Load (model, tokenizer, processor): ``visualcla_model`` may be a native
    checkpoint dir (``params.safetensors``) or a reference merged dir
    (``text_encoder/`` + ``vision_encoder/`` + ``pytorch_model*.bin``, mapped
    straight onto the modules); or base ``text_model`` + ``vision_model``
    HF dirs with ``lora_model`` (one dir or a comma-separated list) folded in
    at load.  The text tower loads at the int4 tier if ``load_in_4bit``, else
    int8 if ``load_in_8bit``, quantized on the host while it streams.
    ``mesh``: the model is sharded over it; a native checkpoint is read a
    rank's slices at a time (``load_checkpoint(mesh=)``), the other layouts
    load whole and are sliced.  Every rank calls the factory alike."""
    from .checkpoint.convert import load_merged, load_unmerged
    from .checkpoint.serialize import load_checkpoint

    quantize = "int4" if load_in_4bit else ("int8" if load_in_8bit else "none")
    check_mesh(mesh)
    loras = (lora_model.split(",") if isinstance(lora_model, str)
             else list(lora_model or []))
    if visualcla_model is None and (text_model is None or vision_model is None):
        raise ValueError("pass visualcla_model, or text_model and vision_model "
                         "(with lora_model)")
    tokenizer = VisualCLATokenizer.from_pretrained(
        visualcla_model or (loras[0] if loras else None) or text_model)
    dev = device or _default_device()
    kw = dict(device=dev, dtype=dtype, quantize=quantize)
    if visualcla_model is None:
        model, cfg = load_unmerged(text_model, vision_model, loras, vocab_size=len(tokenizer),
                                   **kw)
    elif os.path.exists(os.path.join(visualcla_model, "params.safetensors")):
        model, cfg = load_checkpoint(visualcla_model, mesh=mesh, **kw)
    else:
        logger.info("loading reference merged checkpoint %s", visualcla_model)
        model, cfg = load_merged(visualcla_model, **kw)
    proc_src = visualcla_model or vision_model or (loras[0] if loras else None)
    if proc_src and os.path.exists(os.path.join(proc_src, "preprocessor_config.json")):
        image_processor = ImageProcessor.from_pretrained(proc_src)
    else:  # size to the vision tower so the patch count matches its table
        image_processor = ImageProcessor(image_size=cfg.vision_config.image_size)
    image_processor.patch_size = cfg.vision_config.patch_size
    bundle = VisualCLA(model, cfg, tokenizer, image_processor,
                       max_seq_len=max_seq_len, kv_quant=kv_quant, mesh=mesh)
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
                   verbose: bool = True, seed: int = 0, chunk_size: int = 1,
                   speculative: bool = False) -> Iterator[Tuple[str, list]]:
    """Streaming chat turn: yields (partial response, history) per token,
    with the reference's '▁'-prefix space fixup.  ``chunk_size > 1`` decodes
    several tokens between host reads and still yields token by token."""
    if history is None:
        history = []
    sampling = as_sampling_config(generation_config)
    test_input, pixel_values = _prepare_inputs(model, image, text, history)
    old_history = copy.deepcopy(history)
    eos = model.tokenizer.eos_token_id
    gen_ids: list = []
    response = ""
    for step_tokens in model.stream_generate(test_input["input_ids"], pixel_values,
                                             sampling, seed=seed, chunk_size=chunk_size,
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


def hijack_samplers() -> None:
    """Reference compat (modeling_utils.py:395-400): there the extra samplers
    (TFS / top-a / mirostat) must be monkey-patched into HF's generate; here
    they are first-class fields of SamplingConfig, always available.  No-op."""
    logger.info("hijack_samplers(): TFS/top-a/mirostat are built into SamplingConfig "
                "(tfs=, top_a=, mirostat_mode=) — nothing to patch.")
