"""The vision path of the port against the JAX package, in fp32 on the CPU:
ViT and resampler forwards with the flash attention (B2u's plain version
here, the Pallas kernel in interpret mode there), the position-table resize,
head pruning and the pooler, on-device preprocessing, ``VisionPipeline``,
the batch evaluator, the CLI REPL, and the chat after ``extend_to_resolution``
with flash vision attention, token for token.

``VISUALCLA_VIT_ATTN`` is read by the JAX package while it traces, so the
``flash`` fixture clears JAX's caches and counts calls into the Pallas entry,
which shows that the kernel path really ran on both sides."""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from tests.test_torch_host import port_config
from tests.test_torch_models import build_pair, pixels
from visualcla_tpu.checkpoint.serialize import flatten_tree
from visualcla_tpu.core.config import tiny_visualcla_config
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu.models import clip_vit as j_vit
from visualcla_tpu.models import resampler as j_res
from visualcla_tpu_torch.checkpoint.from_jax import params_from_jax
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.models import clip_vit as t_vit
from visualcla_tpu_torch.models import resampler as t_res
from visualcla_tpu_torch.models import visualcla as t_vcla
from visualcla_tpu_torch.ops import attention as t_attn
from visualcla_tpu_torch.ops.cuda import flash_attention as fa

ATOL = 1e-5
# the module: the package's __init__ re-exports its function under the same name
j_fa_mod = importlib.import_module("visualcla_tpu.ops.pallas.flash_attention")


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                                          np.float32),
                               np.asarray(j, np.float32), atol=atol, rtol=atol)


@pytest.fixture
def flash(monkeypatch):
    """Flash vision attention in both packages: the JAX Pallas entry and the
    port's B2u wrapper swapped for counting wrappers, JAX's caches cleared
    before (nothing traced on the dense path is reused) and after (nothing
    traced here leaks into later tests).  -> the call counts."""
    monkeypatch.setenv("VISUALCLA_VIT_ATTN", "flash")
    calls = {"jax": 0, "port": 0}
    j_orig, t_orig = j_fa_mod.flash_attention, t_attn.flash_attention

    def j_counting(*a, **kw):
        calls["jax"] += 1
        return j_orig(*a, **kw)

    def t_counting(*a, **kw):
        calls["port"] += 1
        assert kw.get("causal") is False
        return t_orig(*a, **kw)

    monkeypatch.setattr(j_fa_mod, "flash_attention", j_counting)
    monkeypatch.setattr(t_attn, "flash_attention", t_counting)
    jax.clear_caches()
    yield calls
    jax.clear_caches()


def tiny_pair(seed):
    return build_pair(tiny_visualcla_config(vocab_size=64), seed=seed)


def test_vit_and_resampler_with_flash_match_jax(flash):
    jp, model = tiny_pair(11)
    cfg = model.cfg
    pv = pixels(cfg, 2)
    close(model.vision(torch.from_numpy(pv)),
          j_vit.forward(jp["vision"], cfg.vision_config, jnp.asarray(pv)))
    x = np.random.default_rng(2).standard_normal(
        (2, 9, cfg.visual_resampler_config.hidden_size)).astype(np.float32)
    close(model.resampler(torch.from_numpy(x)),
          j_res.forward(jp["resampler"], cfg.visual_resampler_config, jnp.asarray(x)))
    assert flash["jax"] >= 2  # traced once per tower's layer scan
    assert flash["port"] == (cfg.vision_config.num_hidden_layers
                             + cfg.visual_resampler_config.num_hidden_layers)


def test_flash_and_dense_vision_agree():
    """impl="flash" against the dense path at the ViT's own head shape."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 257, 4, 64)).astype(np.float32))
               for _ in range(3))
    dense = t_attn.full_attention(q, k, v, impl="xla")
    torch.testing.assert_close(t_attn.full_attention(q, k, v, impl="flash"), dense,
                               atol=2e-6, rtol=2e-6)


def test_extend_position_embedding_matches_jax():
    jp, model = tiny_pair(12)
    want = j_vit.extend_position_embedding(jp["vision"], 14, 42)["position_embedding"]
    t_vit.extend_position_embedding(model.vision, 42)
    close(model.vision.position_embedding, want, atol=1e-6)
    assert model.vision.position_embedding.shape == (10, model.cfg.vision_config.hidden_size)
    assert model.vision.cfg.image_size == 42
    assert model.vision(torch.zeros(1, 3, 42, 42)).shape[1] == 10


def test_bicubic_matrix_is_torch_interpolate():
    """224 -> 448 px: a 16 -> 32 patch grid, against F.interpolate on the identity."""
    M = t_vit._torch_bicubic_1d(16, 32)
    eye = torch.eye(16, dtype=torch.float64)[None, :, :, None]  # channel c: one-hot at row c
    want = F.interpolate(eye, size=(32, 1), mode="bicubic", align_corners=False)[0, :, :, 0].T
    np.testing.assert_allclose(M.numpy(), want.numpy(), atol=1e-6)


def test_prune_heads_and_pool_match_jax():
    jp, model = tiny_pair(13)
    rcfg = model.cfg.visual_resampler_config
    heads = {0: [1], 1: [0, 1]}
    pruned = j_res.prune_heads(jp["resampler"], rcfg, heads)
    t_res.prune_heads(model.resampler, heads)
    close(model.resampler.head_mask, pruned["head_mask"], atol=0)
    x = np.random.default_rng(3).standard_normal((2, 9, rcfg.hidden_size)).astype(np.float32)
    hidden = model.resampler(torch.from_numpy(x))
    close(hidden, j_res.forward(pruned, rcfg, jnp.asarray(x)))
    close(t_res.pool(model.resampler, hidden),
          j_res.pool(jp["resampler"], jnp.asarray(hidden.numpy())), atol=1e-6)
    mask = model.resampler.head_mask.clone()
    for bad, msg in (({2: [0]}, "layer 2 out of range"), ({0: [0, 2]}, "head 2 out of range")):
        with pytest.raises(ValueError, match=msg):
            j_res.prune_heads(jp["resampler"], rcfg, bad)
        with pytest.raises(ValueError, match=msg):
            t_res.prune_heads(model.resampler, bad)
    assert torch.equal(model.resampler.head_mask, mask)  # a refused call prunes nothing


def test_pruned_and_extended_jax_tree_converts_to_the_same_port_model():
    jp, model = tiny_pair(14)
    jcfg = tiny_visualcla_config(vocab_size=64)
    jcfg = dataclasses.replace(jcfg, vision_config=dataclasses.replace(
        jcfg.vision_config, image_size=42))
    jp = dict(jp, vision=j_vit.extend_position_embedding(jp["vision"], 14, 42),
              resampler=j_res.prune_heads(jp["resampler"], jcfg.visual_resampler_config,
                                          {1: [1]}))
    tcfg = port_config(jcfg)
    converted = t_vcla.VisualCLAModel(tcfg, device="cpu", dtype=torch.float32)
    converted.load_state_dict(params_from_jax(
        {k: np.asarray(v, np.float32) for k, v in flatten_tree(jp).items()}, tcfg))
    t_vit.extend_position_embedding(model.vision, 42)
    t_res.prune_heads(model.resampler, {1: [1]})
    got, want = model.state_dict(), converted.state_dict()
    assert set(got) == set(want)
    for name in got:
        close(got[name], want[name].numpy(), atol=1e-6)


def test_device_preprocess_matches_jax():
    from visualcla_tpu.processor import device_preprocess as j_device_preprocess
    from visualcla_tpu_torch.processor.image import ImageProcessor, device_preprocess

    img = np.random.default_rng(3).integers(0, 256, (336, 448, 3), dtype=np.uint8)
    want = np.asarray(j_device_preprocess(jnp.asarray(img[None])))
    got = device_preprocess(torch.from_numpy(img[None]))
    assert got.shape == (1, 3, 224, 224) and got.dtype == torch.float32
    close(got, want, atol=1e-4)
    # close to the host-exact path, as the JAX package's own test requires
    d = np.abs(got.numpy() - ImageProcessor()([img])["pixel_values"])
    assert np.percentile(d, 99.9) < 0.05 and d.max() < 0.3
    assert device_preprocess(torch.from_numpy(img[None]), dtype=torch.bfloat16).dtype == \
        torch.bfloat16


def test_npy_image_path_reads_without_pillow(tmp_path):
    from visualcla_tpu_torch.processor.image import ImageProcessor

    img = np.random.default_rng(5).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    path = str(tmp_path / "COCO_0001.jpg")  # a .npy array under an image's name
    with open(path, "wb") as f:
        np.save(f, img)
    ip = ImageProcessor(image_size=28)
    np.testing.assert_array_equal(ip.preprocess_one(path), ip.preprocess_one(img))


# ---------------------------------------------------------------------------
# the entry points, on one tiny native checkpoint through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("vision"))
    ckpt, cfg = make_native_ckpt(tmp)
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    return jm, tm, cfg, ckpt, tmp


def write_pngs(directory, names, seed=0):
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(names):
        arr = rng.integers(0, 256, (40 + 10 * i, 50, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(directory, n))
    return directory


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_vision_pipeline_matches_jax(both, impl, request):
    from visualcla_tpu.pipeline import VisionPipeline as JPipe
    from visualcla_tpu_torch.pipeline import VisionPipeline as TPipe

    _, tm, cfg, ckpt, _ = both
    if impl == "flash":
        calls = request.getfixturevalue("flash")
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (50, 60, 3), dtype=np.uint8),
              rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)]
    jpipe = JPipe.from_pretrained(ckpt, dtype=jnp.float32)
    tpipe = TPipe.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    got = tpipe.embed_images(images)
    assert got.shape == (2, tpipe.num_image_embeds, cfg.text_config.hidden_size)
    assert tpipe.num_image_embeds == jpipe.num_image_embeds
    close(got, jpipe.embed_images(images))
    # modules already loaded are used as they are
    np.testing.assert_array_equal(TPipe(tm.model, tm.config).embed_images(images), got)
    if impl == "flash":
        assert calls["jax"] > 0 and calls["port"] > 0


def test_vision_pipeline_loaders_and_registry(both, tmp_path):
    from visualcla_tpu_torch import pipeline as t_pipe

    _, _, _, ckpt, _ = both
    assert isinstance(t_pipe.VisionPipeline.from_any(ckpt, dtype=torch.float32, device="cpu"),
                      t_pipe.VisionPipeline)
    (tmp_path / "ref" / "vision_encoder").mkdir(parents=True)
    (tmp_path / "split").mkdir()
    (tmp_path / "split" / "visual_resampler_model.bin").write_bytes(b"")
    # the reference layouts dispatch to their loaders (ported), which find
    # these directories empty
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_pipe.VisionPipeline.from_any(str(tmp_path / "ref"), device="cpu")
    with pytest.raises(ValueError, match="clip_model"):
        t_pipe.VisionPipeline.from_any(str(tmp_path / "split"))
    with pytest.raises(FileNotFoundError, match="no checkpoint container"):
        t_pipe.VisionPipeline.from_any(str(tmp_path / "split"), clip_model=str(tmp_path),
                                       device="cpu")
    with pytest.raises(FileNotFoundError):
        t_pipe.VisionPipeline.from_any(str(tmp_path))
    assert t_pipe.get_pipeline("visualcla-7b") == (t_pipe.VisionPipeline, "visualcla-7b")
    assert t_pipe.get_pipeline("other") == (None, None)
    assert t_pipe.get_pipeline_from_model_name("VisualCLA-7B-v0.1")[1] == "visualcla-7b"
    assert t_pipe.get_pipeline_from_model_name("llama-7b") == (None, None)


def align_processors(cfg, *models):
    for m in models:
        m.image_processor.image_size = cfg.vision_config.image_size
        m.image_processor.crop_size = cfg.vision_config.image_size


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_evaluate_matches_jax(both, impl, request):
    from visualcla_tpu.apps.evaluate import evaluate as j_evaluate
    from visualcla_tpu_torch.apps.evaluate import evaluate as t_evaluate

    jm, tm, cfg, _, tmp = both
    if impl == "flash":
        request.getfixturevalue("flash")
    align_processors(cfg, jm, tm)
    names = ["a.png", "b.png", "c.png"]
    img_dir = write_pngs(os.path.join(tmp, "eval"), names)
    questions = [{"id": str(i), "image": n, "instruction": ["ab", "你好", "cd ab"][i],
                  "question_id": i} for i, n in enumerate(names)]
    want = j_evaluate(jm, questions, img_dir,
                      sampling=j_samp.SamplingConfig.greedy(max_new_tokens=6), batch_size=2)
    got = t_evaluate(tm, questions, img_dir,
                     sampling=t_samp.SamplingConfig.greedy(max_new_tokens=6), batch_size=2)
    assert got == want
    assert [r["question_id"] for r in got] == [0, 1, 2]


def test_evaluate_main_writes_predictions(both, tmp_path):
    from visualcla_tpu_torch.apps import evaluate as t_eval

    _, _, cfg, ckpt, tmp = both
    img_dir = write_pngs(str(tmp_path / "imgs"), ["x.png"])
    qpath = tmp_path / "q.json"
    qpath.write_text('[{"id": "0", "image": "x.png", "instruction": "ab", "question_id": 0}]')
    out = tmp_path / "pred.json"
    t_eval.main(["--visualcla_model", ckpt, "--questions", str(qpath), "--image_dir", img_dir,
                 "--output", str(out), "--device", "cpu"])
    import json

    preds = json.loads(out.read_text())
    assert len(preds) == 1 and isinstance(preds[0]["output"], str)


def run_repl(monkeypatch, capsys, module, model, inputs, argv, api_module, greedy):
    monkeypatch.setattr(module.__name__.split(".")[0] + ".get_model_and_tokenizer_and_processor",
                        lambda **kw: (model, model.tokenizer, None))
    it = iter(inputs)
    monkeypatch.setattr("builtins.input", lambda *a: next(it))
    monkeypatch.setattr(api_module, "DEFAULT_GENERATION_CONFIG", greedy)
    capsys.readouterr()
    module.main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("stream", [False, True], ids=["blocking", "stream"])
def test_cli_repl_matches_jax(both, monkeypatch, capsys, tmp_path, stream):
    """The same commands through both REPLs print the same text: the usage,
    every response (and, blocking, every history)."""
    import visualcla_tpu.api as j_api
    import visualcla_tpu_torch.api as t_api
    from visualcla_tpu.apps import inference as j_cli
    from visualcla_tpu_torch.apps import inference as t_cli

    jm, tm, cfg, _, _ = both
    align_processors(cfg, jm, tm)
    img_dir = write_pngs(str(tmp_path), ["x.png", "y.png"], seed=1)
    x, y = (os.path.join(img_dir, n) for n in ("x.png", "y.png"))
    inputs = [f"change image:{x}", "ab", "cd", "clear", "你好", f"add image:{y}", "ab", "exit"]
    argv = ["--visualcla_model", "ignored"] + (["--stream"] if stream else [])
    want = run_repl(monkeypatch, capsys, j_cli, jm, inputs, argv, j_api,
                    j_samp.SamplingConfig.greedy(max_new_tokens=5))
    got = run_repl(monkeypatch, capsys, t_cli, tm, inputs, argv, t_api,
                   t_samp.SamplingConfig.greedy(max_new_tokens=5))
    assert "Conversation history cleared." in got
    assert "1 image(s) attached to your next message." in got
    if not stream:
        assert got.count("Response:") == 4
    assert got == want


def test_chat_after_extend_and_prune_with_flash_matches_jax(tmp_path, flash):
    """The slice: a larger input resolution (28 -> 42 px, 5 -> 10 ViT tokens),
    pruned resampler heads and flash vision attention; greedy chat on an
    image file, token-identical to the JAX package in fp32."""
    ckpt, cfg = make_native_ckpt(str(tmp_path))
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=jnp.float32, max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=ckpt, dtype=torch.float32, device="cpu", max_seq_len=256)
    for m in (jm, tm):
        m.extend_to_resolution(42)
        m.prune_resampler_heads({0: [1]})
    assert tm.config.vision_config.image_size == 42 == tm.engine.cfg.vision_config.image_size
    assert (tm.image_processor.image_size, tm.image_processor.crop_size) == (42, 42)
    assert tm.num_patch == jm.num_patch == cfg.visual_resampler_config.num_query_tokens
    assert tm.model.vision.position_embedding.shape[0] == 10
    img = os.path.join(write_pngs(str(tmp_path / "img"), ["p.png"], seed=2), "p.png")
    assert tm.image_processor(img)["pixel_values"].shape == (1, 3, 42, 42)
    j_gc = j_samp.SamplingConfig.greedy(max_new_tokens=10)
    t_gc = t_samp.SamplingConfig.greedy(max_new_tokens=10)
    j_resp, j_hist = vj.chat(jm, img, "ab你好", [], j_gc, verbose=False)
    fa.reset_launch_counts()
    t_resp, t_hist = vt.chat(tm, img, "ab你好", [], t_gc, verbose=False)
    assert t_resp == j_resp and t_hist == j_hist
    assert flash["jax"] > 0
    L = cfg.vision_config.num_hidden_layers + cfg.visual_resampler_config.num_hidden_layers
    assert flash["port"] == L  # one image encode
    assert not any(fa.LAUNCHES.values())  # on CPU tensors nothing is launched


def test_from_merged_pretrained(both):
    _, _, cfg, ckpt, _ = both
    m = vt.VisualCLA.from_merged_pretrained(ckpt, dtype=torch.float32, device="cpu",
                                            max_seq_len=256)
    assert isinstance(m, vt.VisualCLA) and m.num_patch == cfg.num_image_tokens
