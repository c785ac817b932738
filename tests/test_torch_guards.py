"""Guards of the PyTorch port: it never imports jax, chip_smoke.py refuses to
run without a GPU, and what is not ported yet raises NotImplementedError."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import visualcla_tpu_torch as vt
from visualcla_tpu_torch.engine import sampling as t_samp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(extra)
    return env


def test_port_never_imports_jax():
    code = ("import sys, visualcla_tpu_torch, visualcla_tpu_torch.api, chip_smoke\n"
            "from visualcla_tpu_torch.checkpoint import serialize, from_jax\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_gpu():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from tests.test_api import make_native_ckpt

    path, _ = make_native_ckpt(str(tmp_path_factory.mktemp("guards")))
    return path


@pytest.mark.parametrize("kw", [{"load_in_8bit": True}, {"load_in_4bit": True},
                                {"kv_quant": "int8"}, {"mesh": object()}],
                         ids=["int8", "int4", "kv_int8", "mesh"])
def test_unported_load_options_raise(ckpt, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vt.get_model_and_tokenizer_and_processor(visualcla_model=ckpt, device="cpu", **kw)


def test_unported_generation_options_raise(ckpt):
    model, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    ids = np.array([[1, 5, 6]])
    for gc, kw in ((t_samp.SamplingConfig(num_beams=2), {}),
                   (t_samp.SamplingConfig.greedy(4), {"speculative": True}),
                   (t_samp.SamplingConfig(mirostat_mode=2), {}),
                   (t_samp.SamplingConfig(tfs=0.9), {})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model.generate(ids, generation_config=gc, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        vt.get_model_and_tokenizer_and_processor(text_model=ckpt, vision_model=ckpt,
                                                 device="cpu")


def test_full_width_tokenizer_has_the_model_vocab():
    from visualcla_tpu.core.config import visualcla_config_for_size
    from visualcla_tpu_torch import fixtures

    vocab = visualcla_config_for_size("7B").text_config.vocab_size
    tok = fixtures.make_tokenizer(vocab)
    assert len(tok) == vocab
    ids = tok.encode(fixtures.PROMPT)
    assert ids and max(ids) < vocab
    assert tok.decode(ids).strip() == fixtures.PROMPT
    assert fixtures.random_image(0).shape == (480, 640, 3)
    assert np.array_equal(fixtures.random_image(0), fixtures.random_image(0))


@pytest.mark.parametrize("Sq", [1, 5], ids=["decode", "prefill"])
def test_plain_attention_switch(Sq):
    from visualcla_tpu_torch import fixtures
    from visualcla_tpu_torch.models import llama as llama_mod
    from visualcla_tpu_torch.ops import attention as t_attn

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, Sq, 4, 8, generator=g)
    kc, vc = torch.randn(2, 3, 2, 2, 16, 8, generator=g).unbind(0)
    valid = torch.ones(2, 16, dtype=torch.bool)
    valid[1, :3] = False
    slot = torch.tensor([6, 9])
    orig = llama_mod.cached_attention
    with fixtures.plain_attention():
        assert llama_mod.cached_attention is t_attn.cached_attention_ref
        ref = llama_mod.cached_attention(q, kc, vc, valid, slot, layer_index=1)
    assert llama_mod.cached_attention is orig
    # on CPU tensors the dispatch runs the same plain versions
    got = t_attn.cached_attention(q, kc, vc, valid, slot, layer_index=1)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)
