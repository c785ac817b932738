"""The port's token-identity harness (``visualcla_tpu_torch/apps/
parity_check.py``) end to end on the CPU, on in-repo pieces only.

A tiny native checkpoint (built in-process, as ``tools/make_tiny_checkpoint.py``
does) is exported by the port's ``checkpoint/export.py`` to the reference's
merged layout; the harness then runs the port's fp32 model against HF's
real ``LlamaForCausalLM`` and ``CLIPVisionModel`` (transformers) read from
that directory, with the reference's splice.  The reference's resampler
module lives in the reference checkout, which is not in the repository, so
the harness is handed a stand-in module built from the port's resampler and
its HF-key loader.  What this holds is the harness, HF's towers and the
splice, not the reference's resampler."""
import json
import os
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu_torch.apps import parity_check
from visualcla_tpu_torch.engine.sampling import SamplingConfig
from visualcla_tpu_torch.text import encoding_text

STAND_IN = textwrap.dedent('''
    """A stand-in for the reference's modeling_visual_resampler.py: the
    port's resampler behind the reference's class names and call."""
    import dataclasses

    import torch

    from visualcla_tpu_torch.checkpoint.from_jax import leaf_to_state
    from visualcla_tpu_torch.checkpoint.mapping import iter_leaves
    from visualcla_tpu_torch.core.config import ResamplerConfig
    from visualcla_tpu_torch.models.resampler import Resampler


    class VisualResamplerConfig:
        def __init__(self, **kw):
            self.cfg = ResamplerConfig.from_hf_dict(kw)


    class VisualResamplerModel(torch.nn.Module):
        def __init__(self, config, add_pooling_layer=True):
            super().__init__()
            cfg = dataclasses.replace(config.cfg, add_pooling_layer=add_pooling_layer)
            self.resampler = Resampler(cfg, dtype=torch.float32)

        def load_state_dict(self, sd, strict=True):
            state = dict(self.named_parameters())
            full = {"visual_resampler." + k: v for k, v in sd.items()}
            for key, layer, t in iter_leaves(full, "resampler"):
                for name, value in leaf_to_state(key, t, layer):
                    if name in state or strict:  # strict=False skips the pooler
                        with torch.no_grad():
                            state[name].copy_(value)

        def forward(self, encoder_hidden_states):
            return (self.resampler(encoder_hidden_states),)
''')


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    from visualcla_tpu_torch.checkpoint.export import export_reference_merged
    from visualcla_tpu_torch.checkpoint.serialize import load_checkpoint

    tmp = tmp_path_factory.mktemp("parity")
    native, _ = make_native_ckpt(str(tmp))
    model, cfg = load_checkpoint(native, device="cpu", dtype=torch.float32)
    merged = str(tmp / "merged")
    export_reference_merged(model, cfg, merged, dtype="float32", side_files_from=native)
    ref = tmp / "reference" / "models" / "visualcla"
    ref.mkdir(parents=True)
    (ref / "modeling_visual_resampler.py").write_text(STAND_IN)
    images = tmp / "imgs"
    images.mkdir()
    Image.fromarray(np.random.default_rng(7).integers(0, 256, (40, 36, 3), np.uint8)).save(
        images / "q.png")
    questions = [
        {"question_id": 0, "image": "q.png", "instruction": "图片 ab?"},
        {"question_id": 1, "instruction": "ab gh 你好"},
        {"question_id": 2, "question": "cd"},  # the owl set's field name
    ]
    return native, merged, str(tmp / "reference"), str(images), questions


def _stand_in(reference_dir):
    mod = parity_check.load_reference_resampler_module(reference_dir)
    assert mod is not None
    return mod


def test_run_parity_exact_on_every_question(dirs):
    native, merged, reference, images, questions = dirs
    results = parity_check.run_parity(native, merged, questions, images, max_new_tokens=8,
                                      resampler_module=_stand_in(reference), device="cpu")
    assert [r["question_id"] for r in results] == [0, 1, 2]
    assert all(r["exact"] for r in results), results
    for r in results:
        assert r["match"] == r["ours_len"] == r["theirs_len"] >= 1
        assert isinstance(r["ours"], str)


def test_jax_reference_gives_the_port_harness_s_tokens(dirs):
    """The JAX package's ``HFReference`` on the same merged dir, stand-in and
    inputs generates token for token what the port's ``HFReference`` does,
    and the port's harness reports those tokens as its reference side (and,
    being exact, as its own output)."""
    from visualcla_tpu.apps.parity_check import HFReference as JHFReference
    from visualcla_tpu_torch.text.prompt import img_marker_positions

    native, merged, reference, images, questions = dirs
    stand_in = _stand_in(reference)
    results = parity_check.run_parity(native, merged, questions, images, max_new_tokens=8,
                                      resampler_module=stand_in, device="cpu")
    model, tok, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=native, dtype=torch.float32, device="cpu")
    j_ref = JHFReference(merged, stand_in)
    t_ref = parity_check.HFReference(merged, stand_in)
    for q, r in zip(questions, results):
        ids = encoding_text([], q.get("instruction") or q["question"], model.num_patch,
                            tok)["input_ids"]
        pos = int(img_marker_positions(ids, tok.img_start_token_id)[0])
        pix = (model.image_processor(os.path.join(images, q["image"]))["pixel_values"]
               if q.get("image") else None)
        want = j_ref.generate_greedy(ids, pix, pos, 8, model.num_patch)
        got = t_ref.generate_greedy(ids, pix, pos, 8, model.num_patch)
        np.testing.assert_array_equal(got, want)
        assert r["theirs_len"] == len(want) and r["exact"]
        assert r["ours"] == tok.decode(want)


def test_main_converts_the_merged_dir_and_writes_results(dirs, tmp_path):
    """The CLI: ``--reference_dir`` names the checkout holding the resampler
    module, the merged dir is converted to a native one in fp32, ``--limit``
    cuts the set, and the results land in ``--output``."""
    _, merged, reference, images, questions = dirs
    qfile = tmp_path / "q.json"
    qfile.write_text(json.dumps(questions, ensure_ascii=False))
    out = tmp_path / "parity.json"
    results = parity_check.main([
        "--merged_model", merged, "--reference_dir", reference, "--questions", str(qfile),
        "--image_dir", images, "--max_new_tokens", "6", "--limit", "2",
        "--output", str(out), "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == results
    assert len(results) == 2 and all(r["exact"] for r in results), results


def test_perturbed_port_is_caught(dirs, monkeypatch):
    """One weight of the port changed (the LM head row of another token made
    50 times the row of the first greedy token): the harness reports
    ``exact: False`` with the match counts."""
    native, merged, reference, images, questions = dirs
    base = parity_check.run_parity(native, merged, questions[:1], images, max_new_tokens=8,
                                   resampler_module=_stand_in(reference), device="cpu")[0]
    orig = vt.api.get_model_and_tokenizer_and_processor
    first = {}

    def perturbed(**kw):
        model, tok, proc = orig(**kw)
        head = model.model.text.lm_head.weight
        ids = encoding_text([], questions[0]["instruction"], model.num_patch, tok)["input_ids"]
        pix = model.image_processor(os.path.join(images, "q.png"))["pixel_values"]
        a = int(model.generate(ids, pixel_values=pix,
                               generation_config=SamplingConfig.greedy(1))[0][0])
        victim = a + 1 if a + 1 < head.shape[0] else a - 1
        with torch.no_grad():  # the victim's logit: 50 x the argmax's
            head[victim] = 50.0 * head[a]
        first.update(a=a, victim=victim)
        return model, tok, proc

    monkeypatch.setattr(vt.api, "get_model_and_tokenizer_and_processor", perturbed)
    r = parity_check.run_parity(native, merged, questions[:1], images, max_new_tokens=8,
                                resampler_module=_stand_in(reference), device="cpu")[0]
    assert r["exact"] is False
    assert r["match"] < min(r["ours_len"], r["theirs_len"]) or r["ours_len"] != r["theirs_len"]
    assert r["theirs_len"] == base["theirs_len"]  # the reference side is untouched
    assert base["exact"] and r["match"] < base["match"]


def test_missing_reference_module_raises(dirs, tmp_path):
    native, merged, _, images, questions = dirs
    assert parity_check.load_reference_resampler_module(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="--reference_dir"):
        parity_check.run_parity(native, merged, questions, images,
                                reference_dir=str(tmp_path), device="cpu")
