"""Image-before-text chat splice for the webui multimodal extension.

The reference patches webui's multimodal ``script.py`` so an uploaded picture
is inlined BEFORE the instruction text (the order VisualCLA was trained on —
reference script.py:68-95).  This module provides the same behavior as an
importable function so a user can wire it without keeping a vendored copy of
webui's script:

    from visualcla_torch_pipeline.chat_picture import add_chat_picture_visualcla
    # in extensions/multimodal/script.py, replace add_chat_picture with it

The implementation is original (not copied): resize the short edge into
[224, 300] preserving aspect, embed as a base64 ``<img>`` data URI, and place
it ahead of the text unless the user positioned an explicit ``<image>``
placeholder.
"""
from __future__ import annotations

import base64
from io import BytesIO


def _resize_for_history(picture):
    """Short edge >= 224 (CLIP input) but <= 300 (keep chat history light)."""
    long_side, short_side = max(picture.size), min(picture.size)
    aspect = long_side / short_side
    short_new = int(max(300 / aspect, 224))
    long_new = int(short_new * aspect)
    if picture.width < picture.height:
        return picture.resize((short_new, long_new))
    return picture.resize((long_new, short_new))


def _data_uri(picture) -> str:
    buf = BytesIO()
    picture.save(buf, format="JPEG")
    b64 = base64.b64encode(buf.getvalue()).decode("utf-8")
    return f'<img src="data:image/jpeg;base64,{b64}">'


def _splice(text: str | None, image_tag: str) -> str:
    if not text:
        return image_tag
    if "<image>" in text:
        return text.replace("<image>", image_tag)
    return image_tag + "\n" + text


def add_chat_picture_visualcla(picture, text, visible_text):
    """Return (prompt_text, visible_text) with the picture spliced in FRONT
    of the instruction — VisualCLA's trained image-then-text order."""
    image_tag = _data_uri(_resize_for_history(picture))
    text = _splice(text, image_tag)
    visible_text = _splice(visible_text, image_tag) if visible_text else text
    return text, visible_text
