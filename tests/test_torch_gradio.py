"""The port's Gradio demo (``visualcla_tpu_torch/apps/gradio_demo.py``)
against the JAX package's: the renderers string for string, the flags, the
exit without gradio, and the submit callback (``make_predict``) on the tiny
fp32 checkpoint on the CPU against what the JAX package's ``chat`` /
``chat_in_stream`` give for the same config, rendered the same way.  The UI
itself needs gradio, which is not installed: only its callback is driven."""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.api import DEFAULT_GENERATION_CONFIG as J_DEFAULT
from visualcla_tpu.api import chat as j_chat
from visualcla_tpu.api import chat_in_stream as j_chat_in_stream
from visualcla_tpu.apps import gradio_demo as j_demo
from visualcla_tpu_torch.apps import gradio_demo as t_demo

CORPUS = [
    "plain answer",
    "```python\nprint('a_b')\nx = 1 < 2\n```\nafter the code",
    "| a | b |\n|---|---|\n| 1 | 2 |\n",
    "inline $a_b + c_d$ math and $$\\sum_{i=1}^n x_i$$ display",
    "$$\na_1\n$$\nthen text",
    "图片里有一只猫。\n\n它在沙发上睡觉。",
    "a < b && c > d & e",
    "first line\n\n\nsecond line\n",
    "**bold** and _em_ and `code`",
    "```\nno language\n```",
    "",
]


@pytest.mark.parametrize("text", CORPUS)
def test_parse_text_equals_jax(text):
    assert t_demo.parse_text(text) == j_demo.parse_text(text)


@pytest.mark.parametrize("text", CORPUS)
def test_convert_markdown_equals_jax(text):
    assert t_demo.convert_markdown(text) == j_demo.convert_markdown(text)


def test_latex_spans_survive_markdown():
    out = t_demo.convert_markdown("x $a_b$ y")
    assert "$a_b$" in out and "<em>" not in out
    assert t_demo.LATEX_DELIMITERS == j_demo.LATEX_DELIMITERS


def test_parser_equals_jax():
    def flags(p):
        return sorted((a.option_strings[0], a.default, a.required, type(a).__name__)
                      for a in p._actions if a.option_strings and a.dest != "help")

    assert flags(t_demo.build_parser()) == flags(j_demo.build_parser())
    args = vars(t_demo.build_parser().parse_args(["--visualcla_model", "m"]))
    assert args == vars(j_demo.build_parser().parse_args(["--visualcla_model", "m"]))
    assert args["port"] == 8090


def test_main_without_gradio_names_the_port_s_apps(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio -> ImportError
    with pytest.raises(SystemExit) as e:
        t_demo.main(["--visualcla_model", "unused", "--only_cpu"])
    msg = str(e.value)
    assert "python -m visualcla_tpu_torch.apps.inference" in msg
    assert "python -m visualcla_tpu_torch.apps.serve" in msg


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from PIL import Image

    ckpt, cfg = make_native_ckpt(str(tmp_path_factory.mktemp("gradio")))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    image = Image.fromarray(np.random.default_rng(3).integers(0, 256, (40, 52, 3), np.uint8))
    return jm, tm, image


SLIDERS = dict(max_new_tokens=10, top_p=0.9, top_k=1, temperature=0.5)  # top_k 1: deterministic


def _jax_expected(jm, image, text, stream):
    gc = dataclasses.replace(J_DEFAULT, **SLIDERS)
    if stream:
        response, history = "", []
        for response, history in j_chat_in_stream(jm, image=image, text=text, history=[],
                                                  generation_config=gc, verbose=False):
            pass
    else:
        response, history = j_chat(jm, image=image, text=text, history=[],
                                   generation_config=gc, verbose=False)
    return response, history


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "no_stream"])
@pytest.mark.parametrize("selected", ["Upload", "Webcam"])
def test_make_predict_equals_jax_chat(both, stream, selected):
    jm, tm, image = both
    text = "ab你好"
    predict = t_demo.make_predict(tm, no_stream=not stream)
    upload, webcam = (image, None) if selected == "Upload" else (None, image)
    earlier = [("q", "a")]
    yields = list(predict(text, upload, webcam, earlier, SLIDERS["max_new_tokens"],
                          SLIDERS["top_p"], SLIDERS["top_k"], SLIDERS["temperature"], [],
                          selected))
    assert len(yields) >= 1 if stream else len(yields) == 1
    chatbot, history = yields[-1]
    response, j_history = _jax_expected(jm, image, text, stream)
    assert chatbot == earlier + [(j_demo.parse_text(text), j_demo.convert_markdown(response))]
    assert history == j_history
    assert earlier == [("q", "a")]  # the callback extends a copy


def test_make_predict_stream_and_blocking_agree(both):
    _, tm, image = both
    def args():  # a fresh history each call: chat records the turn in it
        return ("ab", image, None, [], 8, 0.9, 1, 0.5, [], "Upload")

    s_bot, s_hist = list(t_demo.make_predict(tm)(*args()))[-1]
    b_bot, b_hist = list(t_demo.make_predict(tm, no_stream=True)(*args()))[-1]
    assert [q for q, _ in s_bot] == [q for q, _ in b_bot]
    assert s_hist[:-1] == b_hist[:-1]  # the stream's text may lead with a space
    assert s_hist[-1]["value"].lstrip(" ") == b_hist[-1]["value"].lstrip(" ")


def test_make_predict_without_an_image(both):
    _, tm, _ = both
    passes0 = dict(tm.engine.counts)
    out = list(t_demo.make_predict(tm)("hi", None, None, [("q", "a")], 8, 0.9, 40, 0.5,
                                       [{"type": "instruction"}], "Upload"))
    assert out == [([("hi", t_demo.EMPTY_IMAGE)], [])]
    assert t_demo.EMPTY_IMAGE == "图片不能为空。请重新上传图片。"
    assert tm.engine.counts == passes0  # nothing ran
