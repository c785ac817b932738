"""Checkpoint conversion in the PyTorch port against the JAX package, on the
CPU: the reference's containers, the mapping, ``convert_merged`` (byte for
byte), ``convert_unmerged``, the exporter, the webui split, the factory on
merged and base + LoRA dirs (token for token in fp32), the quantized loads,
the vision pipeline's loaders and LoRA leaves.  Every reference-layout
fixture comes from the JAX package's own writers: ``init_params`` ->
``checkpoint.export.export_reference_merged`` for merged and base dirs,
``train.lora.add_lora`` (non-zero B) -> ``export_adapter`` for adapters."""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visualcla_tpu as vj
import visualcla_tpu_torch as vt
from tests.test_api import make_native_ckpt
from visualcla_tpu.checkpoint import convert as j_convert
from visualcla_tpu.checkpoint import export as j_export
from visualcla_tpu.checkpoint import lora as j_lora
from visualcla_tpu.checkpoint import mapping as j_mapping
from visualcla_tpu.checkpoint import serialize as j_serialize
from visualcla_tpu.checkpoint import split_adapter as j_split
from visualcla_tpu.checkpoint import torch_io as j_torch_io
from visualcla_tpu.engine import sampling as j_samp
from visualcla_tpu.train import lora as j_train_lora
from visualcla_tpu_torch.checkpoint import convert as t_convert
from visualcla_tpu_torch.checkpoint import export as t_export
from visualcla_tpu_torch.checkpoint import from_jax
from visualcla_tpu_torch.checkpoint import lora as t_lora
from visualcla_tpu_torch.checkpoint import mapping as t_mapping
from visualcla_tpu_torch.checkpoint import serialize as t_serialize
from visualcla_tpu_torch.checkpoint import split_adapter as t_split
from visualcla_tpu_torch.checkpoint import torch_io as t_torch_io
from visualcla_tpu_torch.core.config import VisualCLAConfig as TConfig
from visualcla_tpu_torch.engine import sampling as t_samp
from visualcla_tpu_torch.ops import linear as t_linear

R, ALPHA = 4, 8.0


def _np(t):
    """A torch tensor or JAX / numpy array as numpy (bf16 widened to fp32)."""
    if isinstance(t, torch.Tensor):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in j_serialize.flatten_tree(tree).items()}


def _t_cfg(cfg) -> TConfig:
    return TConfig.from_hf_dict(dataclasses.asdict(cfg))


def _write_cfg(cfg, path):
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**dataclasses.asdict(cfg), "model_type": "visualcla"}, f)


def _copy_tokenizer(src, dst):
    for name in ("tokenizer.model", "added_tokens.json"):
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))


def _lora_params(params, seed=5):
    """JAX ``add_lora`` over every text and vision projection, B made
    non-zero (``add_lora`` starts B at zero)."""
    lp = j_train_lora.add_lora(params, r=R, alpha=ALPHA, rng=jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for tower in ("text", "vision"):
        for node in lp[tower]["layers"].values():
            if isinstance(node, dict) and "lora_B" in node:
                node["lora_B"] = jnp.asarray(
                    rng.standard_normal(node["lora_B"].shape).astype(np.float32) * 0.3)
    return lp


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """A native checkpoint with its tokenizer, the reference layouts the
    JAX exporter writes from it, and a composite adapter."""
    tmp = str(tmp_path_factory.mktemp("torch_ckpt"))
    ckpt, cfg = make_native_ckpt(tmp)
    params, _ = j_serialize.load_checkpoint(ckpt, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, params)
    dirs = {}
    for dt in ("float32", "float16", "bfloat16"):
        dirs[dt] = os.path.join(tmp, "merged_" + dt)
        j_export.export_reference_merged(params, cfg, dirs[dt], dtype=dt, side_files_from=ckpt)
    lora_dir = os.path.join(tmp, "lora")
    lp = _lora_params(params)
    j_train_lora.export_adapter(lp, lora_dir, r=R, alpha=ALPHA)
    _write_cfg(cfg, lora_dir)
    _copy_tokenizer(ckpt, lora_dir)
    return {"tmp": tmp, "ckpt": ckpt, "cfg": cfg, "params": params, "merged": dirs,
            "lora": lora_dir, "lora_params": lp}


def _assert_sd_equal(t_sd, j_sd):
    assert set(t_sd) == set(j_sd)
    for k in j_sd:
        np.testing.assert_array_equal(_np(t_sd[k]), np.asarray(j_sd[k]), err_msg=k)


# ---------------------------------------------------------------------------
# torch_io
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bin", "sharded", "safetensors", "safetensors_index",
                                    "glob", "adapter_safetensors"])
def test_torch_io_reads_every_container(ref, tmp_path, layout):
    src = t_torch_io.load_state_dict(os.path.join(ref["merged"]["bfloat16"], "text_encoder"))
    keys = sorted(src)
    d = str(tmp_path)
    if layout == "bin":
        torch.save(src, os.path.join(d, "pytorch_model.bin"))
    elif layout in ("sharded", "glob"):
        halves = (keys[:len(keys) // 2], keys[len(keys) // 2:])
        names = [f"pytorch_model-0000{i + 1}-of-00002.bin" for i in range(2)]
        for name, part in zip(names, halves):
            torch.save({k: src[k] for k in part}, os.path.join(d, name))
        if layout == "sharded":
            with open(os.path.join(d, "pytorch_model.bin.index.json"), "w") as f:
                json.dump({"weight_map": {k: names[i] for i, part in enumerate(halves)
                                          for k in part}}, f)
    elif layout == "safetensors":
        t_serialize.write_safetensors(os.path.join(d, "model.safetensors"), src)
    elif layout == "safetensors_index":
        t_serialize.write_safetensors(os.path.join(d, "a.safetensors"), src)
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"weight_map": {k: "a.safetensors" for k in keys}}, f)
    else:
        t_serialize.write_safetensors(os.path.join(d, "adapter_model.safetensors"), src)
    got = t_torch_io.load_state_dict(d)
    assert set(got) == set(src)
    for k in keys:
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k], src[k]), k
    # the JAX reader sees the same values (it widens bf16 to fp32)
    _assert_sd_equal(got, j_torch_io.load_state_dict(d))


def test_torch_io_mmaps_pickles_and_refuses_empty_dirs(ref, tmp_path):
    path = os.path.join(ref["merged"]["float32"], "text_encoder", "pytorch_model.bin")
    sd = t_torch_io.load_file(path)
    _assert_sd_equal(sd, j_torch_io.load_file(path))
    with pytest.raises(FileNotFoundError):
        t_torch_io.load_state_dict(str(tmp_path))


# ---------------------------------------------------------------------------
# mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["float32", "float16"])
@pytest.mark.parametrize("tower", ["text", "vision", "resampler", "projection"])
def test_mapping_equals_the_jax_tree(ref, tower, dt):
    m = ref["merged"][dt]
    src = {"text": "text_encoder", "vision": "vision_encoder"}.get(tower, "")
    sd_t = t_torch_io.load_state_dict(os.path.join(m, src))
    sd_j = j_torch_io.load_state_dict(os.path.join(m, src))
    j_fn = {"text": j_mapping.llama_tree_from_sd, "vision": j_mapping.vit_tree_from_sd,
            "resampler": j_mapping.resampler_tree_from_sd,
            "projection": j_mapping.projection_tree_from_sd}[tower]
    j_flat = {f"{tower}/{k}": v for k, v in _flat_np(j_fn(sd_j)).items()}
    t_flat = {f"{tower}/{k}": v for k, v in t_mapping.tower_tree_from_sd(sd_t, tower).items()}
    assert list(t_flat) == list(j_flat)  # the same leaves in the same order
    for k in j_flat:
        assert tuple(t_flat[k].shape) == j_flat[k].shape, k
        np.testing.assert_array_equal(_np(t_flat[k]), j_flat[k], err_msg=k)


def test_iter_leaves_map_onto_the_modules_as_params_from_jax(ref):
    """The direct path (one layer's slice at a time) gives the state the
    stacked JAX tree gives through ``params_from_jax``."""
    m = ref["merged"]["float32"]
    cfg = _t_cfg(ref["cfg"])
    direct = {}
    for tower, sub in (("text", "text_encoder"), ("vision", "vision_encoder"),
                       ("projection", ""), ("resampler", "")):
        sd = t_torch_io.load_state_dict(os.path.join(m, sub))
        for key, layer, t in t_mapping.iter_leaves(sd, tower, consume=True):
            direct.update(from_jax.leaf_to_state(key, t, layer))
    stacked = from_jax.params_from_jax(
        {k: v for k, v in _flat_np(ref["params"]).items()}, cfg)
    assert set(direct) == set(stacked) - {"resampler.head_mask"}
    for k, v in direct.items():
        assert torch.equal(v.contiguous(), stacked[k].contiguous()), k


# ---------------------------------------------------------------------------
# convert / save_checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,out", [("float32", "bfloat16"), ("float16", "bfloat16"),
                                     ("bfloat16", "bfloat16"), ("float32", "float32"),
                                     ("float16", "float16")])
def test_convert_merged_bytes_equal_jax(ref, tmp_path, src, out):
    j_out, t_out = str(tmp_path / "j"), str(tmp_path / "t")
    j_convert.convert_merged(ref["merged"][src], j_out, dtype=out)
    t_convert.convert_merged(ref["merged"][src], t_out, dtype=out)
    with open(os.path.join(j_out, "params.safetensors"), "rb") as f:
        j_bytes = f.read()
    with open(os.path.join(t_out, "params.safetensors"), "rb") as f:
        t_bytes = f.read()
    assert t_bytes == j_bytes
    with open(os.path.join(j_out, "config.json")) as f, \
            open(os.path.join(t_out, "config.json")) as g:
        assert json.load(g) == json.load(f)
    assert sorted(os.listdir(t_out)) == sorted(os.listdir(j_out))


def test_convert_cli(ref, tmp_path):
    out = str(tmp_path / "cli")
    t_convert.main(["--merged_model", ref["merged"]["float32"], "--output", out,
                    "--dtype", "float32"])
    model, cfg = t_serialize.load_checkpoint(out, device="cpu", dtype=torch.float32)
    j_params, _ = j_serialize.load_checkpoint(ref["ckpt"], dtype=jnp.float32)
    flat = from_jax.params_to_jax(model)
    for k, v in _flat_np(j_params).items():
        np.testing.assert_array_equal(_np(flat[k]), v, err_msg=k)
    with pytest.raises(SystemExit):
        t_convert.main(["--text_model", "x", "--output", out])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_checkpoint_bytes_equal_jax(ref, tmp_path, dtype):
    """The port's writer on its model's tree (``params_to_jax``, in the JAX
    tree's leaf order) writes the JAX writer's bytes for that tree."""
    cfg = ref["cfg"]
    model, _ = t_serialize.load_checkpoint(ref["ckpt"], device="cpu", dtype=torch.float32)
    j_serialize.save_checkpoint(str(tmp_path / "j"), ref["params"], cfg, dtype)
    flat = from_jax.params_to_jax(model)
    t_serialize.save_checkpoint(str(tmp_path / "t"),
                                {k: flat[k] for k in j_serialize.flatten_tree(ref["params"])},
                                _t_cfg(cfg), dtype)
    for name in ("params.safetensors", "config.json"):
        with open(tmp_path / "j" / name, "rb") as f, open(tmp_path / "t" / name, "rb") as g:
            assert g.read() == f.read(), name


def test_flatten_and_unflatten_tree_equal_jax(ref):
    flat = t_serialize.flatten_tree(ref["params"])
    assert list(flat) == list(j_serialize.flatten_tree(ref["params"]))
    assert _flat_np(t_serialize.unflatten_tree(flat)).keys() == flat.keys()


def _fold_delta(lp, key):
    """max |A B scale| of one LoRA leaf of the JAX tree (the fold's size)."""
    node = lp
    for p in key.split("/"):
        node = node[p]
    d = np.einsum("lir,lro->lio", np.asarray(node["lora_A"]), np.asarray(node["lora_B"]))
    return float(np.abs(d * ALPHA / R).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_unmerged_against_jax(ref, tmp_path, dtype):
    """fp32: every leaf within 1e-6 of the largest |delta| of its fold (the
    folds' products in another order); bf16: at most 1 ulp apart."""
    base = ref["merged"]["float32"]
    args = (os.path.join(base, "text_encoder"), os.path.join(base, "vision_encoder"),
            [ref["lora"]])
    j_convert.convert_unmerged(*args, str(tmp_path / "j"), dtype=dtype)
    t_convert.convert_unmerged(*args, str(tmp_path / "t"), dtype=dtype)
    j_flat = dict(t_serialize.iter_safetensors(str(tmp_path / "j" / "params.safetensors")))
    t_flat = dict(t_serialize.iter_safetensors(str(tmp_path / "t" / "params.safetensors")))
    assert list(t_flat) == list(j_flat)
    for k in j_flat:
        a, b = t_flat[k], j_flat[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if dtype == "float32":
            parts = k.split("/")
            tol = (1e-6 * _fold_delta(ref["lora_params"], "/".join(parts[:3]))
                   if parts[1] == "layers" and parts[2] in j_train_lora.TEXT_TARGETS
                   + j_train_lora.VISION_TARGETS and parts[0] in ("text", "vision") else 0.0)
            assert float((a - b).abs().max()) <= tol, k
        else:
            ulps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max()
            assert int(ulps) <= 1, k
    with open(tmp_path / "j" / "config.json") as f, open(tmp_path / "t" / "config.json") as g:
        assert json.load(g) == json.load(f)


@pytest.mark.parametrize("src", ["float32", "float16", "bfloat16"])
def test_resize_embeddings_rows_bitwise_equal_jax(ref, src):
    sd_t = t_torch_io.load_state_dict(os.path.join(ref["merged"][src], "text_encoder"))
    sd_j = j_torch_io.load_state_dict(os.path.join(ref["merged"][src], "text_encoder"))
    V = sd_t["model.embed_tokens.weight"].shape[0]
    got = t_lora.resize_embeddings(sd_t, V + 5, seed=3)
    want = j_lora.resize_embeddings(sd_j, V + 5, seed=3)
    for k in ("model.embed_tokens.weight", "lm_head.weight"):
        assert got[k].shape == (V + 5, sd_t[k].shape[1])
        # the JAX package holds bf16 as fp32 until it writes: compare in the
        # stored dtype, as both checkpoints would
        j_rows = torch.from_numpy(want[k]).to(got[k].dtype)
        assert torch.equal(got[k], j_rows), k


def test_fold_lora_options_against_jax():
    rng = np.random.default_rng(0)
    base = {"m.weight": rng.standard_normal((6, 4)).astype(np.float32)}
    adapter = {"base_model.model.m.lora_A.weight": rng.standard_normal((2, 4)).astype(np.float32),
               "base_model.model.m.lora_B.weight": rng.standard_normal((6, 2)).astype(np.float32),
               "base_model.model.n.modules_to_save.default.weight": np.ones((3,), np.float32)}
    base["n.weight"] = np.zeros((3,), np.float16)
    t_base = {k: torch.from_numpy(v) for k, v in base.items()}
    t_adapter = {k: torch.from_numpy(v) for k, v in adapter.items()}
    for cfg in ({"r": 2, "lora_alpha": 4}, {"r": 2, "lora_alpha": 4, "use_rslora": True}):
        got = t_lora.fold_lora(t_base, t_adapter, cfg)
        want = j_lora.fold_lora(base, adapter, cfg)
        np.testing.assert_allclose(_np(got["m.weight"]), want["m.weight"], rtol=1e-6, atol=1e-6)
        assert got["n.weight"].dtype == torch.float16
        np.testing.assert_array_equal(_np(got["n.weight"]), want["n.weight"])
    fifo = {"m.weight": torch.from_numpy(base["m.weight"].T.copy())}
    got = t_lora.fold_lora(fifo, t_adapter, {"r": 2, "lora_alpha": 4, "fan_in_fan_out": True})
    want = j_lora.fold_lora({"m.weight": base["m.weight"].T.copy()}, adapter,
                            {"r": 2, "lora_alpha": 4, "fan_in_fan_out": True})
    np.testing.assert_allclose(_np(got["m.weight"]), want["m.weight"], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="no adapter keys matched"):
        t_lora.fold_lora({"x.weight": torch.zeros(2)}, t_adapter, {})


def test_partition_and_split_adapter_equal_jax(ref):
    sd_t, cfg_t = t_lora.load_adapter(ref["lora"])
    sd_j, cfg_j = j_lora.load_adapter(ref["lora"])
    assert cfg_t == cfg_j
    comp_t = t_lora.partition_visualcla_adapter(sd_t)
    comp_j = j_lora.partition_visualcla_adapter(sd_j)
    for name in comp_j:
        _assert_sd_equal(comp_t[name], comp_j[name])
    pairs_t, full_t = t_lora.split_adapter(sd_t)
    pairs_j, full_j = j_lora.split_adapter(sd_j)
    assert set(pairs_t) == set(pairs_j)
    _assert_sd_equal(full_t, full_j)


def test_init_missing_heads_by_shape_and_statistics(ref, tmp_path):
    """Without a LoRA the projector and resampler are made fresh: the JAX
    package draws them from its own generator, the port from a seeded
    torch.Generator, so the two agree in structure, dtype and shape, and the
    draws in their statistics."""
    base = ref["merged"]["float32"]
    args = (os.path.join(base, "text_encoder"), os.path.join(base, "vision_encoder"), [])
    j_convert.convert_unmerged(*args, str(tmp_path / "j"), dtype="float32")
    t_convert.convert_unmerged(*args, str(tmp_path / "t"), dtype="float32")
    j_flat = dict(t_serialize.iter_safetensors(str(tmp_path / "j" / "params.safetensors")))
    t_flat = dict(t_serialize.iter_safetensors(str(tmp_path / "t" / "params.safetensors")))
    assert list(t_flat) == list(j_flat)
    for k in j_flat:
        a, b = t_flat[k], j_flat[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if not k.startswith(("projection/", "resampler/")):
            assert torch.equal(a, b), k
        elif k.endswith(("bias", "query_embedding")):
            assert not a.any() and not b.any(), k
        elif "_ln/" in k and k.endswith("weight"):
            assert bool((a == 1).all()), k
    with open(tmp_path / "j" / "config.json") as f, open(tmp_path / "t" / "config.json") as g:
        assert json.load(g) == json.load(f)
    cfg = _t_cfg(ref["cfg"])  # wide enough for statistics
    big_cfg = dataclasses.replace(
        cfg, vision_config=dataclasses.replace(cfg.vision_config, hidden_size=256),
        text_config=dataclasses.replace(cfg.text_config, hidden_size=512))
    big, synced = t_convert._init_missing_heads({}, big_cfg)
    assert synced.visual_resampler_config.hidden_size == 256  # the vision width
    w = big["projection"]["weight"]
    assert w.shape == (256, 512)
    assert abs(float(w.std()) - cfg.initializer_range) < 0.05 * cfg.initializer_range
    assert abs(float(w.mean())) < 0.05 * cfg.initializer_range
    q = big["resampler"]["layers"]["q_proj"]
    assert abs(float(q.std()) - 0.02) < 0.05 * 0.02
    again = t_convert._init_missing_heads({}, big_cfg)[0]
    assert torch.equal(again["projection"]["weight"], w)  # seeded: the same draws


# ---------------------------------------------------------------------------
# export and split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["tree", "module"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_export_equals_jax(ref, tmp_path, source, dtype):
    cfg = ref["cfg"]
    j_export.export_reference_merged(ref["params"], cfg, str(tmp_path / "j"), dtype=dtype,
                                     side_files_from=ref["ckpt"])
    if source == "tree":
        src = ref["params"]
    else:
        src, _ = t_serialize.load_checkpoint(ref["ckpt"], device="cpu", dtype=torch.float32)
    t_export.export_reference_merged(src, _t_cfg(cfg), str(tmp_path / "t"), dtype=dtype,
                                     side_files_from=ref["ckpt"])
    for rel in ("pytorch_model.bin", "text_encoder/pytorch_model.bin",
                "vision_encoder/pytorch_model.bin"):
        got = torch.load(tmp_path / "t" / rel, weights_only=True)
        want = torch.load(tmp_path / "j" / rel, weights_only=True)
        assert list(got) == list(want) or set(got) == set(want), rel
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (rel, k)
    for rel in ("config.json", "text_encoder/config.json", "vision_encoder/config.json"):
        with open(tmp_path / "j" / rel) as f, open(tmp_path / "t" / rel) as g:
            assert json.load(g) == json.load(f), rel
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


@pytest.mark.parametrize("kind", ["lora", "int8", "int4"])
def test_export_refuses_lora_and_quantized_leaves(ref, tmp_path, kind):
    cfg = _t_cfg(ref["cfg"])
    if kind == "lora":
        flat = j_serialize.flatten_tree(jax.tree.map(np.asarray, ref["lora_params"]))
        model = from_jax.build_model(flat, cfg, device="cpu", dtype=torch.float32)
        match = "LoRA"
    else:
        model, _ = t_serialize.load_checkpoint(ref["ckpt"], device="cpu", dtype=torch.float32,
                                               quantize=kind)
        match = "int8 / int4"
    with pytest.raises(ValueError, match=match):
        t_export.export_reference_merged(model, cfg, str(tmp_path / "x"))
    with pytest.raises(ValueError, match=match):
        t_export.export_reference_merged(from_jax.params_to_jax(model), cfg,
                                         str(tmp_path / "y"))


def test_export_cli_round_trips(ref, tmp_path):
    out = str(tmp_path / "merged")
    t_export.main(["--checkpoint", ref["ckpt"], "--output", out, "--dtype", "float32"])
    back = str(tmp_path / "back")
    t_convert.convert_merged(out, back, dtype="float32")
    want = t_serialize.read_safetensors(os.path.join(ref["ckpt"], "params.safetensors"))
    got = t_serialize.read_safetensors(os.path.join(back, "params.safetensors"))
    assert set(got) == set(want)
    for k in want:  # bit for bit
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_split_adapter_equals_jax_file_by_file(ref, tmp_path):
    j_dirs = j_split.split(ref["lora"], str(tmp_path / "j"))
    t_dirs = t_split.split(ref["lora"], str(tmp_path / "t"))
    for jd, td in zip(j_dirs, t_dirs):
        assert os.path.basename(td).replace("t_", "j_", 1) == os.path.basename(jd)
        assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
        for name in os.listdir(jd):
            if name.endswith(".json"):
                with open(os.path.join(jd, name)) as f, open(os.path.join(td, name)) as g:
                    assert json.load(g) == json.load(f), name
            else:
                got = torch.load(os.path.join(td, name), weights_only=True)
                want = torch.load(os.path.join(jd, name), weights_only=True)
                assert list(got) == list(want), name
                for k in want:
                    assert torch.equal(got[k], want[k]), (name, k)
    assert t_split.TEXT_TARGET_MODULES == j_split.TEXT_TARGET_MODULES
    t_split.main(["--lora_model", ref["lora"], "--out_prefix", str(tmp_path / "cli")])
    assert os.path.isdir(str(tmp_path / "cli") + "_vision_lora_model")


# ---------------------------------------------------------------------------
# the factory and the pipeline on the reference layouts
# ---------------------------------------------------------------------------

def _pixels(cfg, seed=1):
    s = cfg.vision_config.image_size
    return np.random.default_rng(seed).standard_normal((1, 3, s, s)).astype(np.float32)


def _both_chats(jm, tm, cfg, n=10):
    pix = _pixels(cfg)
    j_resp, _ = vj.chat(jm, pix, "ab你好", [], j_samp.SamplingConfig.greedy(n), verbose=False)
    t_resp, _ = vt.chat(tm, pix, "ab你好", [], t_samp.SamplingConfig.greedy(n), verbose=False)
    return j_resp, t_resp


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_factory_on_a_merged_dir_matches_jax(ref, src):
    m = ref["merged"][src]
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(visualcla_model=m, dtype=jnp.float32,
                                                        max_seq_len=256)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(visualcla_model=m, dtype=torch.float32,
                                                        device="cpu", max_seq_len=256)
    flat = from_jax.params_to_jax(tm.model)
    for k, v in _flat_np(jm.params).items():
        np.testing.assert_array_equal(_np(flat[k]), v, err_msg=k)
    j_resp, t_resp = _both_chats(jm, tm, ref["cfg"])
    assert t_resp == j_resp
    again = vt.VisualCLA.from_merged_pretrained(m, dtype=torch.float32, device="cpu",
                                                max_seq_len=256)
    assert vt.chat(again, _pixels(ref["cfg"]), "ab你好", [],
                   t_samp.SamplingConfig.greedy(10), verbose=False)[0] == j_resp


@pytest.mark.parametrize("with_lora", [True, False], ids=["lora", "no_lora"])
def test_factory_on_base_and_lora_dirs_matches_jax(ref, with_lora):
    base = ref["merged"]["float32"]
    text, vision = os.path.join(base, "text_encoder"), os.path.join(base, "vision_encoder")
    if not with_lora:  # the fresh heads differ by generator: compare the text towers
        _copy_tokenizer(ref["ckpt"], text)
        tm, tok, _ = vt.get_model_and_tokenizer_and_processor(
            text_model=text, vision_model=vision, dtype=torch.float32, device="cpu",
            max_seq_len=256)
        flat = from_jax.params_to_jax(tm.model)
        for k, v in _flat_np(ref["params"]).items():
            if k.startswith(("text/", "vision/")):
                np.testing.assert_array_equal(_np(flat[k]), v, err_msg=k)
        assert tm.model.text.embed_tokens.shape[0] == len(tok)
        return
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        text_model=text, vision_model=vision, lora_model=ref["lora"], dtype=jnp.float32,
        max_seq_len=256)
    tm = vt.VisualCLA.from_vision_text_pretrained(vision, text, ref["lora"],
                                                  dtype=torch.float32, device="cpu",
                                                  max_seq_len=256)
    flat = from_jax.params_to_jax(tm.model)
    for k, v in _flat_np(jm.params).items():
        np.testing.assert_allclose(_np(flat[k]), v, rtol=0, atol=1e-6, err_msg=k)
    j_resp, t_resp = _both_chats(jm, tm, ref["cfg"])
    assert t_resp == j_resp


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_loads_of_a_merged_dir_equal_jax_bytes(ref, bits):
    m = ref["merged"]["float32"]
    kw = {"load_in_8bit": True} if bits == 8 else {"load_in_4bit": True}
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(visualcla_model=m, dtype=jnp.float32,
                                                        max_seq_len=256, **kw)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(visualcla_model=m, dtype=torch.float32,
                                                        device="cpu", max_seq_len=256, **kw)
    flat = from_jax.params_to_jax(tm.model)
    j_flat = _flat_np(jm.params)
    qkeys = [k for k in j_flat if k.endswith(("/q", "/scale"))]
    assert len(qkeys) == 2 * 9
    for k in qkeys:
        assert _np(flat[k]).dtype == j_flat[k].dtype, k
        np.testing.assert_array_equal(_np(flat[k]), j_flat[k], err_msg=k)
    j_resp, t_resp = _both_chats(jm, tm, ref["cfg"], n=6)
    assert t_resp == j_resp


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_loads_of_base_and_lora_dirs_equal_jax_bytes(ref, bits):
    """The unmerged load at the int8 / int4 tier folds on the host, one
    tensor at a time, and quantizes the folded weights to JAX's bytes."""
    base = ref["merged"]["float32"]
    text, vision = os.path.join(base, "text_encoder"), os.path.join(base, "vision_encoder")
    kw = {"load_in_8bit": True} if bits == 8 else {"load_in_4bit": True}
    jm, _, _ = vj.get_model_and_tokenizer_and_processor(
        text_model=text, vision_model=vision, lora_model=ref["lora"], dtype=jnp.float32,
        max_seq_len=256, **kw)
    tm, _, _ = vt.get_model_and_tokenizer_and_processor(
        text_model=text, vision_model=vision, lora_model=ref["lora"], dtype=torch.float32,
        device="cpu", max_seq_len=256, **kw)
    flat = from_jax.params_to_jax(tm.model)
    j_flat = _flat_np(jm.params)
    qkeys = [k for k in j_flat if k.endswith(("/q", "/scale"))]
    assert len(qkeys) == 2 * 9
    for k in qkeys:
        assert _np(flat[k]).dtype == j_flat[k].dtype, k
        np.testing.assert_array_equal(_np(flat[k]), j_flat[k], err_msg=k)
    j_resp, t_resp = _both_chats(jm, tm, ref["cfg"], n=6)
    assert t_resp == j_resp


@pytest.mark.parametrize("with_lora", [False, True], ids=["resize", "lora"])
def test_unmerged_state_reads_each_tensor_onto_its_device(ref, with_lora):
    """Each tower tensor reaches the target device as it is read, with its
    resize (new rows made there too), folds and replacements; ``meta``
    stands in for the card: a tensor left on the host would not join one
    there.  Without a LoRA the resize to ``vocab_size`` is the embedding's
    one change; the fixture's adapter replaces the whole embedding after
    it."""
    base = ref["merged"]["float32"]
    text, vision = os.path.join(base, "text_encoder"), os.path.join(base, "vision_encoder")
    V = t_torch_io.load_state_dict(text)["model.embed_tokens.weight"].shape[0]
    text_sd, vision_sd, _, _, _ = t_convert.unmerged_state(
        text, vision, [ref["lora"]] if with_lora else [], vocab_size=V + 4, device="meta")
    assert isinstance(text_sd, t_lora.FoldingStateDict)
    assert text_sd.shape("model.embed_tokens.weight")[0] == (V if with_lora else V + 4)
    n = len(text_sd) + len(vision_sd)
    for sd in (text_sd, vision_sd):
        for k in list(sd):
            want = sd.shape(k)
            t = sd.pop(k)
            assert t.device.type == "meta" and tuple(t.shape) == want, k
            assert k not in sd
    assert n > 0 and len(text_sd) == len(vision_sd) == 0


def _images(cfg, n=2):
    from PIL import Image

    rng = np.random.default_rng(3)
    return [Image.fromarray(rng.integers(0, 256, (40, 30, 3), dtype=np.uint8))
            for _ in range(n)]


@pytest.mark.parametrize("layout", ["merged", "webui_split", "webui_split_with_lora"])
def test_vision_pipeline_reference_loaders_match_jax(ref, tmp_path, layout):
    from visualcla_tpu.pipeline import VisionPipeline as JPipe
    from visualcla_tpu_torch.pipeline import VisionPipeline as TPipe

    base = ref["merged"]["float32"]
    if layout == "merged":
        jp = JPipe.from_reference_merged(base, dtype=jnp.float32)
        tp = TPipe.from_reference_merged(base, dtype=torch.float32, device="cpu")
        tp_any = TPipe.from_any(base, dtype=torch.float32, device="cpu")
    else:
        lora = ref["lora"]
        if layout == "webui_split":  # an adapter without vision LoRA pairs
            lora = str(tmp_path / "lora_novis")
            os.makedirs(lora)
            sd = torch.load(os.path.join(ref["lora"], "adapter_model.bin"), weights_only=True)
            torch.save({k: v for k, v in sd.items() if ".vision_model." not in k},
                       os.path.join(lora, "adapter_model.bin"))
            for name in ("adapter_config.json", "config.json"):
                shutil.copy(os.path.join(ref["lora"], name), os.path.join(lora, name))
        _, vision_dir = j_split.split(lora, str(tmp_path / "split"))
        clip = os.path.join(base, "vision_encoder")
        jp = JPipe.from_webui_split(vision_dir, clip, dtype=jnp.float32)
        tp = TPipe.from_webui_split(vision_dir, clip, dtype=torch.float32, device="cpu")
        tp_any = TPipe.from_any(vision_dir, clip_model=clip, dtype=torch.float32, device="cpu")
    imgs = _images(ref["cfg"])
    want = np.asarray(jp.embed_images(imgs))
    for pipe in (tp, tp_any):
        got = pipe.embed_images(imgs)
        assert got.shape == want.shape
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 1e-5, rel


def test_unported_reference_options_are_gone(ref):
    with pytest.raises(ValueError, match="text_model and vision_model"):
        vt.get_model_and_tokenizer_and_processor(text_model=ref["ckpt"], device="cpu")


# ---------------------------------------------------------------------------
# LoRA leaves
# ---------------------------------------------------------------------------

def _lora_leaf(kind, fin=64, fout=24, r=4, seed=0):
    from visualcla_tpu.ops import quantization as j_q

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((fin, fout)).astype(np.float32) * 0.1
    a = rng.standard_normal((fin, r)).astype(np.float32) * 0.2
    b = rng.standard_normal((r, fout)).astype(np.float32) * 0.2
    if kind == "dense":
        base = w
    elif kind == "int8":
        base = j_q.quantize_np(w, axis=-2)
    else:
        base = j_q.quantize_grouped_np(w, group=32, bits=4)
        base = {"q": base["q"], "scale": base["scale"]}
    return {"w": base, "lora_A": a, "lora_B": b, "lora_scale": np.float32(1.5)}


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_lora_linear_against_jax_linear(kind):
    from visualcla_tpu.ops.linear import linear as j_linear

    leaf = _lora_leaf(kind)
    x = np.random.default_rng(1).standard_normal((3, 5, 64)).astype(np.float32)
    want = np.asarray(j_linear(jnp.asarray(x), jax.tree.map(jnp.asarray, leaf)))
    flat = j_serialize.flatten_tree({"text": {"layers": {"q_proj": jax.tree.map(
        lambda v: np.asarray(v)[None], leaf)}}})
    shapes = {k: (v.shape, v.dtype) for k, v in flat.items()}
    spec = from_jax.lora_specs(shapes)["text/layers/q_proj"]
    assert spec["base"] == kind and spec["rank"] == 4
    state = {}
    for k, v in flat.items():
        state.update(from_jax.leaf_to_state(k, v))
    base = {"dense": t_linear.Linear(64, 24, False, dtype=torch.float32),
            "int8": t_linear.Int8Linear(64, 24), "int4": t_linear.Int4Linear(64, 24, 32)}[kind]
    mod = t_linear.LoraLinear(base, 4, dtype=torch.float32)
    mod.load_state_dict({k[len("text.layers.0.q_proj."):]: v for k, v in state.items()})
    assert t_linear.base_features(base) == (64, 24)
    got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def lora_models(ref):
    """The JAX tree with LoRA leaves in both packages, and as a native
    checkpoint."""
    cfg = ref["cfg"]
    lp = jax.tree.map(jnp.asarray, ref["lora_params"])
    from visualcla_tpu.text import VisualCLATokenizer as JTok
    from visualcla_tpu_torch.text import VisualCLATokenizer as TTok

    jtok, ttok = JTok.from_pretrained(ref["ckpt"]), TTok.from_pretrained(ref["ckpt"])
    from visualcla_tpu.processor import ImageProcessor as JIP
    from visualcla_tpu_torch.processor import ImageProcessor as TIP

    s = cfg.vision_config.image_size
    jm = vj.VisualCLA(lp, cfg, jtok, JIP(image_size=s), dtype=jnp.float32, max_seq_len=256)
    flat = {k: np.asarray(v) for k, v in j_serialize.flatten_tree(lp).items()}
    tm = vt.VisualCLA(flat, _t_cfg(cfg), ttok, TIP(image_size=s), dtype=torch.float32,
                      device="cpu", max_seq_len=256)
    native = os.path.join(ref["tmp"], "native_lora")
    j_serialize.save_checkpoint(native, jax.tree.map(np.asarray, lp), cfg, "float32")
    _copy_tokenizer(ref["ckpt"], native)
    return jm, tm, native


def test_a_model_holding_lora_leaves_generates_like_jax(ref, lora_models):
    jm, tm, _ = lora_models
    layer = tm.model.text.layers[0]
    assert isinstance(layer.q_proj, t_linear.LoraLinear)
    assert isinstance(tm.model.vision.layers[0].fc1, t_linear.LoraLinear)
    assert tm.model.vision.layers[0].fc1.bias is not None
    j_resp, t_resp = _both_chats(jm, tm, ref["cfg"])
    assert t_resp == j_resp


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_native_checkpoint_with_lora_leaves_loads_like_jax(ref, lora_models, quantize):
    jm, _, native = lora_models
    q8 = quantize == "int8"
    jn, _, _ = vj.get_model_and_tokenizer_and_processor(
        visualcla_model=native, dtype=jnp.float32, max_seq_len=256, load_in_8bit=q8)
    tn, _, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=native, dtype=torch.float32, device="cpu", max_seq_len=256,
        load_in_8bit=q8)
    lora = tn.model.text.layers[1].down_proj
    assert isinstance(lora, t_linear.LoraLinear) and isinstance(lora.base, t_linear.Linear)
    if q8:  # the JAX loader quantizes the plain leaves only
        assert isinstance(tn.model.text.lm_head, t_linear.Int8Linear)
    j_resp, t_resp = _both_chats(jn, tn, ref["cfg"])
    assert t_resp == j_resp
    back = from_jax.params_to_jax(tn.model)
    for k, v in _flat_np(jn.params).items():
        np.testing.assert_array_equal(_np(back[k]), v, err_msg=k)


def test_repl_loads_base_and_lora_dirs(ref, monkeypatch, capsys):
    """The REPL's unmerged flags fold the adapter at load and chat."""
    import io

    from visualcla_tpu_torch.apps import inference

    base = ref["merged"]["float32"]
    monkeypatch.setattr("sys.stdin", io.StringIO("ab你好\nexit\n"))
    inference.main(["--text_model", os.path.join(base, "text_encoder"),
                    "--vision_model", os.path.join(base, "vision_encoder"),
                    "--lora_model", ref["lora"], "--only_cpu"])
    out = capsys.readouterr().out
    assert "Usage" in out and "Response:" in out
