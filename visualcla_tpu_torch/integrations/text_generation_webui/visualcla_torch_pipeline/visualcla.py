"""VisualCLA multimodal pipeline for text-generation-webui, image tower on
the card (port of integrations/text_generation_webui/visualcla_tpu_pipeline/
visualcla.py).

The reference plugin's protocol constants (``<img>`` / ``</img>`` markers,
64 image embeds, placeholder token id 49957, the 1024 -> 4096 projection)
and settings keys (``visualcla_merged_model`` / ``visualcla_vision_lora_model``),
with CLIP-ViT + resampler + projector replayed as one captured encode
(``visualcla_tpu_torch.pipeline.VisionPipeline``).  ``embed_images`` hands the
embeddings to the webui model's device and dtype without a host copy when
that device is the card.

The module imports without text-generation-webui installed (webui modules
are imported lazily or stubbed), so it can be tested on its own.
"""
from typing import List, Tuple

try:  # inside a webui checkout
    from extensions.multimodal.abstract_pipeline import AbstractMultimodalPipeline
except ImportError:  # standalone import (tests): a minimal structural stand-in
    from abc import ABC

    class AbstractMultimodalPipeline(ABC):  # type: ignore[no-redef]
        pass


def _shared():
    """webui's global state module (lazy so standalone import works)."""
    from modules import shared

    return shared


class VisualCLA_Torch_Pipeline(AbstractMultimodalPipeline):
    CLIP_REPO = "openai/clip-vit-large-patch14"

    def __init__(self, params: dict) -> None:
        super().__init__()
        self.pipeline = self._load_models()

    def _load_models(self):
        import time

        from visualcla_tpu_torch.pipeline import VisionPipeline

        start_ts = time.time()
        settings = _shared().settings
        if "visualcla_merged_model" in settings:
            pipe = VisionPipeline.from_any(settings["visualcla_merged_model"])
        elif "visualcla_vision_lora_model" in settings:
            pipe = VisionPipeline.from_webui_split(
                settings["visualcla_vision_lora_model"],
                settings.get("visualcla_clip_model", self.CLIP_REPO),
            )
        else:
            raise KeyError(
                "Expect one of 'visualcla_merged_model' and "
                "'visualcla_vision_lora_model' in settings-visualcla.yaml, "
                "but neither was set."
            )
        print(f"VisualCLA PyTorch vision pipeline loaded in "
              f"{time.time() - start_ts:.2f}s")
        return pipe

    @staticmethod
    def image_start() -> str:
        return "<img>"

    @staticmethod
    def image_end() -> str:
        return "</img>"

    @staticmethod
    def image_placeholder() -> str:
        return "<img_token>"

    @staticmethod
    def num_image_embeds() -> int:
        return 64

    @staticmethod
    def embed_tokens(input_ids):
        """Text embeds come from the webui host's own LLM."""
        shared = _shared()
        if hasattr(shared.model.model, "embed_tokens"):
            func = shared.model.model.embed_tokens
        else:
            func = shared.model.model.model.embed_tokens  # AutoGPTQ case
        return func(input_ids).to(shared.model.device, dtype=shared.model.dtype)

    @staticmethod
    def placeholder_embeddings():
        from modules.text_generation import encode

        return VisualCLA_Torch_Pipeline.embed_tokens(
            encode(
                VisualCLA_Torch_Pipeline.image_placeholder()
                * VisualCLA_Torch_Pipeline.num_image_embeds(),
                add_bos_token=False,
            )[0]
        )

    def embed_images(self, images: List["object"]):
        """Images (PIL, uint8 (H, W, 3) arrays or paths) -> (N*64, 4096)
        tensor on the webui model's device, in its dtype.

        Preprocessing runs on the host; one replay of the captured encode
        runs the ViT, the resampler and the projector for all N images, and
        the embeddings go from the pipeline's device to the model's without
        passing through the host (no copy at all when device and dtype
        agree)."""
        pixel_values = self.pipeline.image_processor(images)["pixel_values"]
        feats = self.pipeline.encode(pixel_values)  # (N, 64, 4096) on the pipeline's device
        shared = _shared()
        return feats.reshape(-1, feats.shape[-1]).to(shared.model.device,
                                                     dtype=shared.model.dtype)

    @staticmethod
    def visualcla_projector_shape() -> Tuple[int, int]:
        return (1024, 4096)


class VisualCLA_7B_Torch_Pipeline(VisualCLA_Torch_Pipeline):
    def __init__(self, params: dict) -> None:
        super().__init__(params)

    @staticmethod
    def name() -> str:
        return "visualcla-7b-torch"

    @staticmethod
    def placeholder_token_id() -> int:
        return 49957
