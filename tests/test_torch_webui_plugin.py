"""The port's text-generation-webui plugin
(``visualcla_tpu_torch/integrations/text_generation_webui/visualcla_torch_pipeline``)
against the JAX package's (``integrations/text_generation_webui/
visualcla_tpu_pipeline``): each case of ``tests/test_webui_shim.py`` under the
port's pipeline name ``visualcla-7b-torch``, ``embed_images`` on the tiny
checkpoint on the CPU against the JAX plugin's (fp32: atol = rtol = 1e-5,
another summation order), and the chat-picture splice string for string."""
import base64
import io
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_api import make_native_ckpt
from visualcla_tpu_torch.integrations.text_generation_webui.visualcla_torch_pipeline import (
    chat_picture as t_chat_picture,
    pipelines as t_pipelines,
    visualcla as t_vmod,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PLUGIN = os.path.join(ROOT, "integrations", "text_generation_webui")
TOL = 1e-5


def _jax_plugin():
    if JAX_PLUGIN not in sys.path:
        sys.path.insert(0, JAX_PLUGIN)
    import visualcla_tpu_pipeline.chat_picture as chat_picture  # noqa: PLC0415
    import visualcla_tpu_pipeline.visualcla as vmod  # noqa: PLC0415

    return vmod, chat_picture


def test_plugin_imports_without_webui():
    assert t_pipelines.available_pipelines == ["visualcla-7b-torch"]
    assert t_vmod.AbstractMultimodalPipeline.__module__ == t_vmod.__name__  # the stub


def test_plugin_protocol_constants():
    P = t_vmod.VisualCLA_7B_Torch_Pipeline
    J = _jax_plugin()[0].VisualCLA_7B_TPU_Pipeline
    assert P.image_start() == "<img>"
    assert P.image_end() == "</img>"
    assert P.image_placeholder() == "<img_token>"
    assert P.num_image_embeds() == 64
    assert P.placeholder_token_id() == 49957
    assert P.visualcla_projector_shape() == (1024, 4096)
    assert P.name() == "visualcla-7b-torch"
    for name in ("image_start", "image_end", "image_placeholder", "num_image_embeds",
                 "placeholder_token_id", "visualcla_projector_shape"):
        assert getattr(P, name)() == getattr(J, name)()
    assert P.CLIP_REPO == J.CLIP_REPO


def test_plugin_registry_dispatch(monkeypatch):
    made = []

    class Fake(t_vmod.VisualCLA_7B_Torch_Pipeline):
        def __init__(self, params):  # skip model loading
            made.append(params)

    monkeypatch.setattr(t_vmod, "VisualCLA_7B_Torch_Pipeline", Fake)
    assert t_pipelines.get_pipeline("visualcla-7b-torch", {"a": 1}) is not None
    assert t_pipelines.get_pipeline("visualcla-7b-tpu", {}) is None
    assert t_pipelines.get_pipeline("other", {}) is None
    assert t_pipelines.get_pipeline_from_model_name("visualcla-7b-merged", {}) is not None
    assert t_pipelines.get_pipeline_from_model_name("VisualCLA-13B", {}) is None
    assert t_pipelines.get_pipeline_from_model_name("llama-7b", {}) is None
    assert made == [{"a": 1}, {}]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path, _ = make_native_ckpt(str(tmp_path_factory.mktemp("webui")))
    return path


def _shared(dtype, settings=None):
    class Shared:  # a minimal stand-in for webui's modules.shared
        class model:
            device = "cpu"

        settings = {}

    Shared.model.dtype = dtype
    Shared.settings = settings or {}
    return Shared


def _images():
    rng = np.random.default_rng(0)
    return [Image.fromarray(rng.integers(0, 255, (32, 32, 3), np.uint8)),
            Image.fromarray(rng.integers(0, 255, (30, 45, 3), np.uint8))]


def test_plugin_loads_from_settings(ckpt, monkeypatch):
    """The settings keys pick the loader, as in the JAX plugin; without
    either key the plugin raises the same KeyError."""
    from visualcla_tpu_torch.pipeline import VisionPipeline

    calls = []
    monkeypatch.setattr(VisionPipeline, "from_any",
                        classmethod(lambda cls, path: calls.append(("any", path)) or "p"))
    monkeypatch.setattr(VisionPipeline, "from_webui_split",
                        classmethod(lambda cls, v, c: calls.append(("split", v, c)) or "p"))
    monkeypatch.setattr(t_vmod, "_shared",
                        lambda: _shared(torch.float32, {"visualcla_merged_model": ckpt}))
    assert t_vmod.VisualCLA_7B_Torch_Pipeline({}).pipeline == "p"
    monkeypatch.setattr(t_vmod, "_shared",
                        lambda: _shared(torch.float32, {"visualcla_vision_lora_model": "v"}))
    t_vmod.VisualCLA_7B_Torch_Pipeline({})
    assert calls == [("any", ckpt), ("split", "v", "openai/clip-vit-large-patch14")]
    monkeypatch.setattr(t_vmod, "_shared", lambda: _shared(torch.float32))
    with pytest.raises(KeyError, match="visualcla_merged_model"):
        t_vmod.VisualCLA_7B_Torch_Pipeline({})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_images_equals_the_jax_plugin(ckpt, monkeypatch, dtype):
    """The port's plugin over the tiny checkpoint (fp32 towers on the CPU)
    against the JAX plugin's on the same images: the same (N*64, H) shape
    and the host model's dtype, values within TOL (cast to bf16: within one
    bf16 ulp); bitwise equal to the port's own pipeline's f32 host round
    trip cast to that dtype and to ``encode_image`` of the same pixels."""
    import jax.numpy as jnp

    from visualcla_tpu.pipeline import VisionPipeline as JPipe
    from visualcla_tpu_torch.pipeline import VisionPipeline as TPipe

    jvmod, _ = _jax_plugin()
    shared = _shared(dtype)
    monkeypatch.setattr(t_vmod, "_shared", lambda: shared)
    monkeypatch.setattr(jvmod, "_shared", lambda: shared)
    tp = t_vmod.VisualCLA_7B_Torch_Pipeline.__new__(t_vmod.VisualCLA_7B_Torch_Pipeline)
    tp.pipeline = TPipe.from_any(ckpt, dtype=torch.float32, device="cpu")
    jp = jvmod.VisualCLA_7B_TPU_Pipeline.__new__(jvmod.VisualCLA_7B_TPU_Pipeline)
    jp.pipeline = JPipe.from_any(ckpt, dtype=jnp.float32)

    images = _images()
    got, want = tp.embed_images(images), jp.embed_images(images)
    n, hidden = tp.pipeline.num_image_embeds, tp.pipeline.cfg.text_config.hidden_size
    assert got.shape == want.shape == (2 * n, hidden)
    assert got.dtype == want.dtype == dtype
    # bf16: both round f32 values that differ within TOL, so one bf16 ulp
    tol = TOL if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    round_trip = torch.from_numpy(tp.pipeline.embed_images(images)).reshape(-1, hidden)
    assert torch.equal(got, round_trip.to(dtype))
    # the rows are the model's own encode of the same pixels, and the first
    # image's rows its encode alone (B=1: GEMMs of another shape, within TOL)
    from visualcla_tpu_torch.models.visualcla import encode_image

    px = torch.from_numpy(tp.pipeline.image_processor(images)["pixel_values"])
    with torch.no_grad():
        own = encode_image(tp.pipeline.towers, tp.pipeline.cfg, px)
        alone = encode_image(tp.pipeline.towers, tp.pipeline.cfg, px[:1])[0]
    assert torch.equal(got, own.reshape(-1, hidden).to(dtype))
    torch.testing.assert_close(got[:n].float(), alone.to(dtype).float(), atol=tol, rtol=tol)


def test_embed_images_in_bf16_towers_is_a_bitwise_round_trip(ckpt, monkeypatch):
    """bf16 towers: the plugin's output (no host copy) equals the JAX
    contract's f32 numpy round trip cast back, bit for bit."""
    from visualcla_tpu_torch.pipeline import VisionPipeline as TPipe

    monkeypatch.setattr(t_vmod, "_shared", lambda: _shared(torch.bfloat16))
    tp = t_vmod.VisualCLA_7B_Torch_Pipeline.__new__(t_vmod.VisualCLA_7B_Torch_Pipeline)
    tp.pipeline = TPipe.from_any(ckpt, dtype=torch.bfloat16, device="cpu")
    images = _images()
    got = tp.embed_images(images)
    want = torch.from_numpy(tp.pipeline.embed_images(images))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.reshape(-1, want.shape[-1]).to(torch.bfloat16))


def test_chat_picture_splice():
    """Image goes BEFORE the text (VisualCLA's trained order), or replaces an
    explicit <image> placeholder; short edge resized into [224, 300]."""
    img = Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (100, 400, 3), np.uint8)
    )
    text, visible = t_chat_picture.add_chat_picture_visualcla(img, "describe it", "")
    assert text.startswith('<img src="data:image/jpeg;base64,')
    assert text.endswith("\ndescribe it")
    assert visible == text

    text2, _ = t_chat_picture.add_chat_picture_visualcla(img, "look: <image> here", "x")
    assert "<image>" not in text2 and "look: <img" in text2

    m = re.search(r'base64,([^"]+)', text)
    resized = Image.open(io.BytesIO(base64.b64decode(m.group(1))))
    assert min(resized.size) == 224  # aspect 4:1: max(300 / 4, 224)
    assert max(resized.size) == 224 * 4


@pytest.mark.parametrize("size,text,visible", [
    ((100, 400), "describe it", ""),
    ((300, 200), "look: <image> here", "x"),
    ((640, 480), None, None),
    ((250, 250), "", "shown"),
], ids=["wide", "placeholder", "no_text", "square"])
def test_chat_picture_equals_jax(size, text, visible):
    _, j_chat_picture = _jax_plugin()
    img = Image.fromarray(np.random.default_rng(sum(size)).integers(0, 255, size + (3,),
                                                                    np.uint8))
    assert (t_chat_picture.add_chat_picture_visualcla(img, text, visible)
            == j_chat_picture.add_chat_picture_visualcla(img, text, visible))
