"""text-generation-webui multimodal pipeline entry points (PyTorch backend;
port of integrations/text_generation_webui/visualcla_tpu_pipeline/).

Drop this directory into ``extensions/multimodal/pipelines/`` of a
text-generation-webui checkout and select ``--multimodal-pipeline
visualcla-7b-torch``.  The image tower runs on the card through
``visualcla_tpu_torch.pipeline.VisionPipeline`` while the webui host drives
its own LLM.  The name differs from the JAX plugin's (``visualcla-7b-tpu``),
so both can sit in one webui checkout.
"""
from typing import Optional

available_pipelines = ["visualcla-7b-torch"]


def get_pipeline(name: str, params: dict) -> Optional[object]:
    if name == "visualcla-7b-torch":
        from .visualcla import VisualCLA_7B_Torch_Pipeline

        return VisualCLA_7B_Torch_Pipeline(params)
    return None


def get_pipeline_from_model_name(model_name: str, params: dict) -> Optional[object]:
    if "visualcla" not in model_name.lower():
        return None
    if "7b" in model_name.lower():
        from .visualcla import VisualCLA_7B_Torch_Pipeline

        return VisualCLA_7B_Torch_Pipeline(params)
    return None
