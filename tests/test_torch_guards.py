"""Guards of the PyTorch port: it never imports jax nor the JAX package, its
entry points and chip_smoke.py refuse to run without a GPU unless asked for
the CPU, the quantized load options load, beams and the reference layouts
run, a mesh that is not a torch DeviceMesh is refused, and the port's mesh
package imports neither jax nor the JAX package."""
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
    """Neither jax nor any module of the JAX package ``visualcla_tpu`` is
    loaded by importing every module of the port, chip_smoke.py and the
    profiler."""
    code = ("import sys, visualcla_tpu_torch, visualcla_tpu_torch.api, chip_smoke\n"
            "sys.path.insert(0, 'tools'); import profile_torch_slice\n"
            "from visualcla_tpu_torch.checkpoint import (serialize, from_jax, convert, export,\n"
            "                                            lora, mapping, split_adapter, torch_io)\n"
            "from visualcla_tpu_torch.ops import quantization, linear\n"
            "from visualcla_tpu_torch.ops.cuda import (int4_matmul, flash_attention, build,\n"
            "                                          paged_attention, bench_flash)\n"
            "from visualcla_tpu_torch.models import visualcla, llama\n"
            "from visualcla_tpu_torch.engine import (generate, sampling, paged, server,\n"
            "                                     speculative, paged_spec, beam)\n"
            "from visualcla_tpu_torch.apps import serve, evaluate, inference\n"
            "from visualcla_tpu_torch import fixtures, text, processor, host_build, pipeline, assets\n"
            "from visualcla_tpu_torch.core import config\n"
            "from visualcla_tpu_torch.text import native_tok, sp_bpe\n"
            "from visualcla_tpu_torch.processor import native_img, pil_resample\n"
            "from visualcla_tpu_torch.train import (trainer, lora, data, checkpointing,\n"
            "                                        run_training)\n"
            "from visualcla_tpu_torch.parallel import pipeline as pp, fsdp\n"
            "from visualcla_tpu_torch.apps import gradio_demo, parity_check\n"
            "from visualcla_tpu_torch.utils import profiling\n"
            "from visualcla_tpu_torch.integrations.text_generation_webui.visualcla_torch_pipeline \\\n"
            "    import pipelines, visualcla as webui_visualcla, chat_picture\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'visualcla_tpu')\n"
            "             or m.startswith(('jax.', 'visualcla_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_parallel_imports_neither_jax_nor_the_jax_package():
    """``visualcla_tpu_torch.parallel`` (sharding, distributed, tp, ring,
    fsdp, pipeline)
    loads neither jax nor any module of ``visualcla_tpu``."""
    code = ("import sys\n"
            "from visualcla_tpu_torch.parallel import (sharding, distributed, tp, ring, fsdp,\n"
            "                                       pipeline)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'visualcla_tpu')\n"
            "             or m.startswith(('jax.', 'visualcla_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_new_front_ends_import_lazily():
    """The Gradio demo, the parity harness, the profiling utilities and the
    webui plugin import without gradio, transformers, markdown or a webui
    checkout (``extensions`` / ``modules``), and pull none of them in; the
    plugin's base class is then its own stand-in."""
    code = ("import sys\n"
            "for name in ('gradio', 'extensions', 'modules'):\n"
            "    sys.modules[name] = None  # importing it raises ImportError\n"
            "from visualcla_tpu_torch.apps import gradio_demo, parity_check\n"
            "from visualcla_tpu_torch.utils import profiling\n"
            "from visualcla_tpu_torch.integrations.text_generation_webui.visualcla_torch_pipeline \\\n"
            "    import pipelines, visualcla, chat_picture\n"
            "assert pipelines.available_pipelines == ['visualcla-7b-torch']\n"
            "assert visualcla.AbstractMultimodalPipeline.__module__ == visualcla.__name__\n"
            "bad = sorted(m for m in sys.modules if sys.modules[m] is not None and\n"
            "             m.split('.')[0] in ('jax', 'visualcla_tpu', 'transformers',\n"
            "                                 'markdown', 'gradio'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_a_gpu(tmp_path):
    """Called without ``device`` and without a GPU, the factory,
    ``VisualCLA`` and ``pipeline_kv_cache`` raise instead of running on the
    CPU."""
    from tests.test_api import make_native_ckpt

    path, _ = make_native_ckpt(str(tmp_path))
    code = ("import sys, torch, numpy as np, visualcla_tpu_torch as vt\n"
            "from visualcla_tpu_torch.checkpoint.serialize import read_safetensors\n"
            "from visualcla_tpu_torch.core.config import VisualCLAConfig\n"
            "assert not torch.cuda.is_available()\n"
            "ckpt = sys.argv[1]\n"
            "try:\n"
            "    vt.get_model_and_tokenizer_and_processor(visualcla_model=ckpt)\n"
            "    raise SystemExit('factory ran without a GPU')\n"
            "except RuntimeError as e:\n"
            "    assert 'device=\"cpu\"' in str(e), e\n"
            "m, tok, proc = vt.get_model_and_tokenizer_and_processor(visualcla_model=ckpt,\n"
            "                                                       device='cpu')\n"
            "flat = {k: v.numpy() for k, v in read_safetensors(ckpt + '/params.safetensors').items()}\n"
            "try:\n"
            "    vt.VisualCLA(flat, VisualCLAConfig.from_pretrained(ckpt), tok,\n"
            "                 m.image_processor)\n"
            "    raise SystemExit('VisualCLA ran without a GPU')\n"
            "except RuntimeError as e:\n"
            "    assert 'no CUDA device' in str(e), e\n"
            "from visualcla_tpu_torch.parallel.pipeline import pipeline_kv_cache\n"
            "tc = VisualCLAConfig.from_pretrained(ckpt).text_config\n"
            "try:\n"
            "    pipeline_kv_cache(tc, 2, 8, torch.float32, {'pipe': 1, 'data': 1})\n"
            "    raise SystemExit('pipeline_kv_cache ran without a GPU')\n"
            "except RuntimeError as e:\n"
            "    assert 'no CUDA device' in str(e), e\n"
            "c = pipeline_kv_cache(tc, 2, 8, torch.float32, {'pipe': 1, 'data': 1}, device='cpu')\n"
            "assert c['k'].device.type == 'cpu'\n"
            "print('raised')\n")
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT,
                          env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "raised" in proc.stdout


def test_vision_pipeline_and_repl_raise_without_a_gpu(tmp_path):
    """Without a GPU, ``VisionPipeline`` and the REPL raise unless asked for
    the CPU (``device="cpu"``, ``--only_cpu``), and then run."""
    from tests.test_api import make_native_ckpt

    path, _ = make_native_ckpt(str(tmp_path))
    code = ("import sys, io, numpy as np, torch\n"
            "from visualcla_tpu_torch.pipeline import VisionPipeline\n"
            "from visualcla_tpu_torch.apps import inference\n"
            "assert not torch.cuda.is_available()\n"
            "ckpt = sys.argv[1]\n"
            "for run in (lambda: VisionPipeline.from_pretrained(ckpt),\n"
            "            lambda: inference.main(['--visualcla_model', ckpt])):\n"
            "    try:\n"
            "        run()\n"
            "        raise SystemExit('ran without a GPU')\n"
            "    except RuntimeError as e:\n"
            "        assert 'device=\"cpu\"' in str(e), e\n"
            "pipe = VisionPipeline.from_pretrained(ckpt, device='cpu')\n"
            "img = np.zeros((30, 40, 3), np.uint8)\n"
            "assert pipe.embed_images([img]).shape[:2] == (1, pipe.num_image_embeds)\n"
            "sys.stdin = io.StringIO('exit\\n')\n"
            "inference.main(['--visualcla_model', ckpt, '--only_cpu'])\n"
            "print('raised')\n")
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT,
                          env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "raised" in proc.stdout and "Usage" in proc.stdout


def test_plugin_and_parity_harness_raise_without_a_gpu(tmp_path):
    """Without a GPU the webui plugin (it loads its pipeline on the card)
    and the parity harness (unless given ``device="cpu"``) raise."""
    from tests.test_api import make_native_ckpt

    path, _ = make_native_ckpt(str(tmp_path))
    code = ("import sys, types, torch\n"
            "assert not torch.cuda.is_available()\n"
            "ckpt = sys.argv[1]\n"
            "shared = types.SimpleNamespace(settings={'visualcla_merged_model': ckpt})\n"
            "sys.modules['modules'] = types.SimpleNamespace(shared=shared)\n"
            "from visualcla_tpu_torch.apps import parity_check\n"
            "from visualcla_tpu_torch.integrations.text_generation_webui.visualcla_torch_pipeline \\\n"
            "    import visualcla\n"
            "for run in (lambda: visualcla.VisualCLA_7B_Torch_Pipeline({}),\n"
            "            lambda: parity_check.run_parity(ckpt, None, [], '',\n"
            "                                            resampler_module=object())):\n"
            "    try:\n"
            "        run()\n"
            "        raise SystemExit('ran without a GPU')\n"
            "    except RuntimeError as e:\n"
            "        assert 'device=\"cpu\"' in str(e), e\n"
            "print('raised')\n")
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT,
                          env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "raised" in proc.stdout


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


@pytest.mark.parametrize("kw", [{"mesh": object()}], ids=["mesh"])
def test_unported_load_options_raise(ckpt, kw):
    """A mesh is served now (tests/test_torch_mesh*.py); one that is not a
    torch ``DeviceMesh`` is refused before anything loads."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        vt.get_model_and_tokenizer_and_processor(visualcla_model=ckpt, device="cpu", **kw)


@pytest.mark.parametrize("kw,linear,table,cache", [
    ({"load_in_8bit": True}, "Int8Linear", "Int8Table", torch.bfloat16),
    ({"load_in_4bit": True}, "Int4Linear", "Int8Table", torch.bfloat16),
    ({"load_in_8bit": True, "load_in_4bit": True}, "Int4Linear", "Int8Table", torch.bfloat16),
    ({"kv_quant": "int8"}, "Linear", None, torch.int8),
], ids=["int8", "int4", "int4_wins", "kv_int8"])
def test_quantized_load_options_load(ckpt, kw, linear, table, cache):
    from visualcla_tpu_torch.ops import linear as t_linear

    model, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, device="cpu", max_seq_len=256, **kw)
    text = model.model.text
    assert type(text.layers[0].q_proj) is getattr(t_linear, linear)
    assert type(text.lm_head) is getattr(t_linear, linear)
    if table:
        assert type(text.embed_tokens) is getattr(t_linear, table)
    else:
        assert text.embed_tokens.dtype == torch.bfloat16
    assert model.engine.dtype == torch.bfloat16  # from a float leaf at every tier
    assert model.engine.kv_quant == kw.get("kv_quant", "none")
    state = model.engine.start(np.array([[1, 5, 6]]), None, None,
                               t_samp.SamplingConfig.greedy(2))
    assert state.cache["k"].dtype == cache


def test_unknown_kv_quant_raises(ckpt):
    """As the JAX package's Engine: only "none" and "int8"."""
    with pytest.raises(ValueError, match="kv_quant"):
        vt.get_model_and_tokenizer_and_processor(visualcla_model=ckpt, device="cpu",
                                                 kv_quant="int4")


def _reference_dirs(ckpt, out):
    """The checkpoint exported to the reference merged layout (its
    ``text_encoder/`` and ``vision_encoder/`` are base dirs too), with the
    tokenizer beside the text tower."""
    import shutil

    from visualcla_tpu_torch.checkpoint.export import export_reference_merged
    from visualcla_tpu_torch.checkpoint.serialize import load_checkpoint

    model, cfg = load_checkpoint(ckpt, device="cpu", dtype=torch.float32)
    export_reference_merged(model, cfg, out, dtype="float32", side_files_from=ckpt)
    for name in ("tokenizer.model", "added_tokens.json"):
        shutil.copy(os.path.join(ckpt, name), os.path.join(out, "text_encoder", name))
    return os.path.join(out, "text_encoder"), os.path.join(out, "vision_encoder")


def test_unported_generation_options_raise(ckpt, tmp_path):
    """Beams and base text / vision loading, once unported, now run."""
    model, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    ids = np.array([[1, 5, 6]])
    out = model.generate(ids, generation_config=t_samp.SamplingConfig(num_beams=2,
                                                                      max_new_tokens=4))
    assert out.shape[0] == 1 and 1 <= out.shape[1] <= 4
    text, vision = _reference_dirs(ckpt, str(tmp_path / "ref"))
    base, _, _ = vt.get_model_and_tokenizer_and_processor(
        text_model=text, vision_model=vision, dtype=torch.float32, device="cpu",
        max_seq_len=256)
    want = model.model.text.lm_head.weight
    assert torch.equal(base.model.text.lm_head.weight, want)


def test_full_width_tokenizer_has_the_model_vocab():
    from visualcla_tpu_torch.core.config import visualcla_config_for_size
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
    from visualcla_tpu_torch.ops import linear as linear_mod
    from visualcla_tpu_torch.ops.cuda import int4_matmul as i4

    orig = llama_mod.cached_attention
    with fixtures.plain_kernels():
        assert llama_mod.cached_attention is t_attn.cached_attention_ref
        assert linear_mod.int4_matmul is i4.int4_matmul_ref
        ref = llama_mod.cached_attention(q, kc, vc, valid, slot, layer_index=1)
    assert llama_mod.cached_attention is orig
    assert linear_mod.int4_matmul is i4.int4_matmul
    # on CPU tensors the dispatch runs the same plain versions
    got = t_attn.cached_attention(q, kc, vc, valid, slot, layer_index=1)
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_plain_kernels_switch_covers_vision_attention():
    """Inside ``plain_kernels()`` the vision towers' flash attention runs
    B2u's plain version; outside it the wrapper is back."""
    from visualcla_tpu_torch import fixtures
    from visualcla_tpu_torch.ops import attention as t_attn
    from visualcla_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v = torch.randn(3, 2, 9, 2, 8, generator=torch.Generator().manual_seed(1)).unbind(0)
    with fixtures.plain_kernels():
        assert t_attn.flash_attention is fa.flash_attention_ref
        ref = t_attn.full_attention(q, k, v, impl="flash")
    assert t_attn.flash_attention is fa.flash_attention
    torch.testing.assert_close(t_attn.full_attention(q, k, v, impl="flash"), ref, atol=0, rtol=0)


def test_tokenizer_model_reader_needs_no_protobuf(tmp_path):
    """Importing the port's ``sp_model``, saving a model, loading it, and
    loading a tokenizer from the directory pulls in neither transformers nor
    protobuf (the card's machine has neither)."""
    code = ("import sys\n"
            "from visualcla_tpu_torch.text import VisualCLATokenizer\n"
            "from visualcla_tpu_torch.text.sp_model import SPModel, build_test_model\n"
            f"path = {str(tmp_path / 'tokenizer.model')!r}\n"
            "m = build_test_model(['▁a', 'b', '你好'], [-1.0, -2.0, -3.0])\n"
            "m.save(path)\n"
            "assert SPModel.load(path) == m\n"
            f"tok = VisualCLATokenizer.from_pretrained({str(tmp_path)!r})\n"
            "assert tok.decode(tok.encode('a b 你好')) == 'a b 你好'\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('transformers',\n"
            "             'sentencepiece') or m.startswith('google.protobuf'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _jax_public_names():
    """Every name the JAX package's ``__init__`` exports: its imports and the
    names its lazy ``__getattr__`` resolves."""
    import re

    with open(os.path.join(ROOT, "visualcla_tpu", "__init__.py")) as f:
        src = f.read()
    imported = re.search(r"from \.core\.config import \((.*?)\)", src, re.S).group(1)
    names = re.findall(r"\b([A-Za-z_]+)\b", imported.replace("noqa", "").replace("F401", ""))
    lazy = src[src.index("def __getattr__"):]
    return sorted(set(names) | set(re.findall(r'"([A-Za-z_]+)"', lazy)))


@pytest.mark.parametrize("name", _jax_public_names())
def test_port_exports_every_public_name_of_the_jax_package(name):
    import visualcla_tpu as vj

    assert getattr(vj, name) is not None  # the list is right
    assert getattr(vt, name) is not None


def _preset_names():
    import json

    with open(os.path.join(ROOT, "visualcla_tpu", "configs", "generation_presets.json")) as f:
        return sorted(k for k in json.load(f) if not k.startswith("_"))


@pytest.mark.parametrize("name", _preset_names())
def test_generation_presets_equal_the_jax_package_s(name):
    import dataclasses

    import visualcla_tpu as vj

    assert dataclasses.asdict(vt.load_generation_preset(name)) == dataclasses.asdict(
        vj.load_generation_preset(name))


def test_unknown_preset_and_hijack_samplers():
    with pytest.raises(KeyError, match="unknown preset"):
        vt.load_generation_preset("_comment")
    with pytest.raises(KeyError, match="available"):
        vt.load_generation_preset("no-such-preset")
    assert vt.hijack_samplers() is None  # a no-op: the samplers are built in


def test_from_vision_text_pretrained_names_item_9(ckpt, tmp_path):
    """Item 9 (checkpoint conversion) is ported: the constructor composes a
    model from base dirs, and no message of the port names the item."""
    import re

    text, vision = _reference_dirs(ckpt, str(tmp_path / "ref"))
    m = vt.VisualCLA.from_vision_text_pretrained(vision, text, dtype=torch.float32,
                                                 device="cpu", max_seq_len=256)
    assert m.model.text.embed_tokens.shape[0] == len(m.tokenizer)
    for d, _, files in os.walk(os.path.join(ROOT, "visualcla_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(d, name)) as f:
                    assert not re.search(r"item 9|item 7\b|7: beams", f.read()), name
