"""The port's own copies of the host modules (config, tokenizer, prompt,
image preprocessing) give the JAX package's results on the same inputs:
configs round-trip through their JSON form, token ids and decodes are equal,
and preprocessing is bitwise equal on both the native and the numpy path."""
import dataclasses
import os

import numpy as np
import pytest

from visualcla_tpu.checkpoint.serialize import _config_to_dict
from visualcla_tpu.core import config as j_config
from visualcla_tpu.processor import ImageProcessor as JImageProcessor
from visualcla_tpu.text import prompt as j_prompt
from visualcla_tpu.text import sp_model as j_sp
from visualcla_tpu.text import tokenizer as j_tok
from visualcla_tpu_torch.core import config as t_config
from visualcla_tpu_torch.processor import ImageProcessor as TImageProcessor
from visualcla_tpu_torch.processor import native_img as t_native_img
from visualcla_tpu_torch.text import native_tok as t_native_tok
from visualcla_tpu_torch.text import prompt as t_prompt
from visualcla_tpu_torch.text import sp_model as t_sp
from visualcla_tpu_torch.text import tokenizer as t_tok


def port_config(jcfg) -> t_config.VisualCLAConfig:
    """A JAX package config as the port's own config, through its dict form
    (the port never takes the JAX package's config objects)."""
    return t_config.VisualCLAConfig.from_hf_dict(dataclasses.asdict(jcfg))


CONFIGS = {"tiny": lambda m: m.tiny_visualcla_config(vocab_size=77),
           "7B": lambda m: m.visualcla_config_for_size("7B"),
           "13B": lambda m: m.visualcla_config_for_size("13B", vocab_size=50000)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_json_round_trip(tmp_path, name):
    jcfg, tcfg = CONFIGS[name](j_config), CONFIGS[name](t_config)
    assert tcfg.to_hf_dict() == _config_to_dict(jcfg)
    assert port_config(jcfg) == tcfg
    tcfg.save_pretrained(str(tmp_path))
    assert t_config.VisualCLAConfig.from_pretrained(str(tmp_path)) == tcfg
    assert j_config.VisualCLAConfig.from_pretrained(str(tmp_path)) == jcfg
    assert tcfg.num_image_tokens == jcfg.num_image_tokens
    assert tcfg.text_config.head_dim == jcfg.text_config.head_dim


VOCAB = sorted(set("abcdefgh 你好图片,.")) + ["ab", "cd", "你好", "图片"]
SCORES = [-100.0] * (len(VOCAB) - 4) + [-1.0, -2.0, -3.0, -4.0]
TEXTS = ["ab你好", "cd  图片 ab.", "hello 你好图片,abc", "", "  ", "<img>ab</img>cd"]


def _tokenizers(native: bool):
    jt = j_tok.VisualCLATokenizer(j_sp.build_test_model(VOCAB, SCORES), use_native=native)
    tt = t_tok.VisualCLATokenizer(t_sp.build_test_model(VOCAB, SCORES), use_native=native)
    jt.add_special_tokens(j_tok.DEFAULT_SPECIALS)
    tt.add_special_tokens(t_tok.DEFAULT_SPECIALS)
    assert (tt._native is not None) == (jt._native is not None) == native
    return jt, tt


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_tokenizer_ids_and_decode(native):
    jt, tt = _tokenizers(native)
    assert len(tt) == len(jt)
    for text in TEXTS:
        ids = tt.encode(text)
        assert ids == jt.encode(text), text
        assert tt.decode(ids) == jt.decode(ids)
        assert tt.decode(ids, skip_special_tokens=True) == jt.decode(
            ids, skip_special_tokens=True)
    assert tt.convert_ids_to_tokens(list(range(len(tt)))) == jt.convert_ids_to_tokens(
        list(range(len(jt))))
    for attr in ("eos_token_id", "pad_token_id", "img_start_token_id"):
        assert getattr(tt, attr) == getattr(jt, attr)


def test_native_tokenizer_builds_inside_the_port():
    """The port's native core is built from its own source into its own
    ``_build/``, never next to the JAX package's ``csrc/``."""
    lib = t_native_tok._build_and_load()
    path = os.path.realpath(lib._name)
    assert os.sep.join(("visualcla_tpu_torch", "_build")) in path
    assert os.path.basename(path).startswith("libsptok-")
    assert t_native_img.available()


@pytest.mark.parametrize("num_images", [None, 2])
def test_encoding_text_ids(num_images):
    jt, tt = _tokenizers(True)
    history = [{"type": "instruction", "value": "ab", "first_instruction": True},
               {"type": "response", "value": "cd你好"}]
    for hist in ([], history):
        kw = {} if num_images is None else {"num_images": num_images}
        want = j_prompt.encoding_text(list(hist), "图片ab", 4, jt, **kw)
        got = t_prompt.encoding_text(list(hist), "图片ab", 4, tt, **kw)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        assert t_prompt.build_prompt(list(hist), "图片ab", num_images) == \
            j_prompt.build_prompt(list(hist), "图片ab", num_images)
        ids = got["input_ids"]
        np.testing.assert_array_equal(
            t_prompt.img_marker_positions(ids, tt.img_start_token_id),
            j_prompt.img_marker_positions(ids, jt.img_start_token_id))
        np.testing.assert_array_equal(
            t_prompt.all_img_marker_positions(ids, tt.img_start_token_id),
            j_prompt.all_img_marker_positions(ids, jt.img_start_token_id))


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("shape", [(37, 53, 3), (224, 224, 3), (120, 90, 3), (31, 40)])
def test_preprocess_one_bitwise(native, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    for size, resample in ((28, "bicubic"), (224, "bicubic"), (56, "bilinear")):
        jp = JImageProcessor(image_size=size, resample=resample, use_native=native)
        tp = TImageProcessor(image_size=size, resample=resample, use_native=native)
        assert tp._native == jp._native == native
        got, want = tp.preprocess_one(img), jp.preprocess_one(img)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tp(img)["pixel_values"], jp(img)["pixel_values"])


def test_image_processor_config_round_trip(tmp_path):
    jp = JImageProcessor(image_size=56, crop_size=48, resample="bilinear")
    jp.save_pretrained(str(tmp_path))
    tp = TImageProcessor.from_pretrained(str(tmp_path))
    for attr in ("image_size", "crop_size", "image_mean", "image_std", "rescale_factor"):
        assert getattr(tp, attr) == getattr(jp, attr)
