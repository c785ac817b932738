from .prompt import (  # noqa: F401
    PROMPT_TEMPLATE_MULTIMODAL,
    build_prompt,
    encoding_text,
    img_marker_positions,
)
from .sp_model import SPModel, build_test_model  # noqa: F401
from .tokenizer import DEFAULT_SPECIALS, VisualCLATokenizer  # noqa: F401
