"""Train-state checkpoints and the training CLI of the PyTorch port, on the
CPU: a saved and restored state continues bit for bit, the CLI end to end at
both stages (the merged checkpoint, the adapter, train states), ``--resume``
equal to an uninterrupted run, the trained output chatting through the
factory and its adapter folding to the merged model through the unmerged
loader, and the mesh flags (``--n_data``, ``--pipeline``, ``--n_micro``,
``--fsdp``) in two gloo ranks against the one-rank CLI.

Tolerances: resumed runs bit for bit; the folded adapter's logits against
the bf16 merged checkpoint's within 0.05 + 2 % (bf16 rounding of both)."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tests.test_api import make_native_ckpt
from tests.test_torch_train import lora_params, base_params, make_batch, port_model, t_cfg
from visualcla_tpu.core.config import tiny_visualcla_config
from visualcla_tpu.train import lora as j_lora
from visualcla_tpu_torch.checkpoint.serialize import load_checkpoint
from visualcla_tpu_torch.train import checkpointing as ckpt_lib
from visualcla_tpu_torch.train import trainer as t_trainer
from visualcla_tpu_torch.train.run_training import main


def _state_and_step(cfg):
    model = port_model(lora_params(base_params(cfg)), cfg)
    opt = t_trainer.make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=6)
    train, frozen = t_trainer.partition_params(model, j_lora.lora_trainable)
    step = t_trainer.make_train_step_subset(model, t_cfg(cfg), opt, j_lora.lora_trainable)
    return model, t_trainer.init_train_state(train, opt), frozen, step


def _tensors(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}")


def test_train_state_resume_is_bitwise(tmp_path):
    cfg = tiny_visualcla_config()
    batch = make_batch(cfg)
    _, st, frozen, step = _state_and_step(cfg)
    for _ in range(2):
        st, _ = step(st, frozen, batch)
    root = str(tmp_path / "ts")
    ckpt_lib.save_train_state(os.path.join(root, "step_2"), st)
    assert ckpt_lib.latest_step_dir(root).endswith("step_2")
    assert ckpt_lib.latest_step_dir(str(tmp_path / "none")) is None
    st, m = step(st, frozen, batch)

    _, fresh, frozen2, step2 = _state_and_step(cfg)
    restored = ckpt_lib.restore_train_state(ckpt_lib.latest_step_dir(root), fresh)
    assert restored.step == 2 and restored.opt_state["count"] == 2
    restored, m2 = step2(restored, frozen2, batch)
    assert restored.step == 3 and float(m2["loss"]) == float(m["loss"])
    a, b = dict(_tensors(st.params)), dict(_tensors(restored.params))
    a.update(_tensors(st.opt_state, "opt"))
    b.update(_tensors(restored.opt_state, "opt"))
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_restore_refuses_another_structure(tmp_path):
    cfg = tiny_visualcla_config()
    _, st, _, _ = _state_and_step(cfg)
    ckpt_lib.save_train_state(str(tmp_path / "s"), st)
    model = port_model(base_params(cfg), cfg)
    opt = t_trainer.make_optimizer()
    train, _ = t_trainer.partition_params(model, t_trainer.stage1_trainable)
    with pytest.raises(ValueError, match="keys differ"):
        ckpt_lib.restore_train_state(str(tmp_path / "s"), t_trainer.init_train_state(train, opt))


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    from PIL import Image

    tmp = str(tmp_path_factory.mktemp("cli"))
    ckpt, cfg = make_native_ckpt(tmp)
    img_dir = os.path.join(tmp, "imgs")
    os.makedirs(img_dir)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
        os.path.join(img_dir, "a.png"))
    np.save(os.path.join(img_dir, "b.npy"), rng.integers(0, 256, (30, 50, 3), dtype=np.uint8))
    data = os.path.join(tmp, "d.jsonl")
    with open(data, "w") as f:
        for rec in ([{"image": "a.png", "instruction": "ab", "response": "gh"}] * 3
                    + [{"image": "b.npy", "instruction": "你好", "response": "ab cd"}] * 3
                    + [{"image": "a.png", "caption": "图片"},
                       {"instruction": "ab", "response": "hg"}]):
            f.write(json.dumps(rec) + "\n")
    return {"tmp": tmp, "ckpt": ckpt, "cfg": cfg, "img_dir": img_dir, "data": data}


def _args(run_dir, out, *extra):
    return ["--checkpoint", run_dir["ckpt"], "--data", run_dir["data"], "--image_dir",
            run_dir["img_dir"], "--output", out, "--lora_r", "2", "--batch_size", "2",
            "--log_every", "1", "--device", "cpu", "--warmup_steps", "1", *extra]


@pytest.fixture(scope="module")
def stage2(run_dir):
    out = os.path.join(run_dir["tmp"], "trained")
    state = main(_args(run_dir, out, "--stage", "2", "--steps", "3", "--save_every", "2",
                       "--remat"))
    return out, state


def test_cli_stage2_end_to_end(stage2):
    out, state = stage2
    assert state.step == 3
    for name in ("params.safetensors", "config.json", "tokenizer.model",
                 os.path.join("adapter", "adapter_model.bin"),
                 os.path.join("adapter", "adapter_config.json"),
                 os.path.join("train_state", "step_2", "train_state.pt")):
        assert os.path.exists(os.path.join(out, name)), name
    model, _ = load_checkpoint(out, device="cpu", dtype=torch.float32)
    assert type(model.text.layers[0].q_proj).__name__ == "Linear"  # merged
    sd = torch.load(os.path.join(out, "adapter", "adapter_model.bin"), weights_only=True)
    assert any(k.endswith("lora_B.weight") and v.any() for k, v in sd.items())


def test_cli_resume_equals_uninterrupted_run(run_dir, stage2):
    out, _ = stage2
    resumed = os.path.join(run_dir["tmp"], "resumed")
    state = main(_args(run_dir, resumed, "--stage", "2", "--steps", "3", "--remat",
                       "--resume", os.path.join(out, "train_state")))
    assert state.step == 3
    a = torch.load(os.path.join(out, "adapter", "adapter_model.bin"), weights_only=True)
    b = torch.load(os.path.join(resumed, "adapter", "adapter_model.bin"), weights_only=True)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with open(os.path.join(out, "params.safetensors"), "rb") as f, \
            open(os.path.join(resumed, "params.safetensors"), "rb") as g:
        assert f.read() == g.read()


def test_trained_output_chats_and_its_adapter_folds_to_it(run_dir, stage2):
    """The merged output loads through the factory and chats; the adapter
    on base dirs exported from the input checkpoint loads through the
    unmerged loader to the same logits, within bf16 rounding."""
    import visualcla_tpu_torch as vt
    from visualcla_tpu_torch.checkpoint.export import export_reference_merged
    from visualcla_tpu_torch.engine.sampling import SamplingConfig

    out, _ = stage2
    bundle, tok, _ = vt.get_model_and_tokenizer_and_processor(
        visualcla_model=out, dtype=torch.float32, device="cpu", max_seq_len=256)
    image = np.random.default_rng(1).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    reply, hist = vt.chat(bundle, image, "你好", [], SamplingConfig.greedy(max_new_tokens=5),
                          verbose=False)
    assert isinstance(reply, str) and hist[-1]["type"] == "response"

    base, tc = load_checkpoint(run_dir["ckpt"], device="cpu", dtype=torch.float32)
    ref = os.path.join(run_dir["tmp"], "ref")
    export_reference_merged(base, tc, ref, dtype="float32", side_files_from=run_dir["ckpt"])
    adapter = os.path.join(out, "adapter")
    for name in ("tokenizer.model", "added_tokens.json", "config.json"):
        shutil.copy(os.path.join(run_dir["ckpt"], name), os.path.join(adapter, name))
    folded, _, _ = vt.get_model_and_tokenizer_and_processor(
        text_model=os.path.join(ref, "text_encoder"),
        vision_model=os.path.join(ref, "vision_encoder"), lora_model=adapter,
        dtype=torch.float32, device="cpu")
    batch = make_batch(tc, S=20)
    logits = []
    for m in (bundle.model, folded.model):
        b = t_trainer.batch_to_device(m, batch)
        with torch.no_grad():
            logits.append(t_trainer.train_forward_logits(
                m, tc, b["input_ids"], b["attention_mask"], b["img_start_pos"],
                b["pixel_values"]).numpy())
    np.testing.assert_allclose(logits[1], logits[0], rtol=0.02, atol=0.05)


def test_cli_stage1(run_dir):
    out = os.path.join(run_dir["tmp"], "stage1")
    state = main(_args(run_dir, out, "--stage", "1", "--steps", "2"))
    assert state.step == 2
    assert all(n.startswith(("vision.", "resampler.", "projection.")) for n in state.params)
    assert not os.path.exists(os.path.join(out, "adapter"))
    model, _ = load_checkpoint(out, device="cpu", dtype=torch.float32)
    base, _ = load_checkpoint(run_dir["ckpt"], device="cpu", dtype=torch.float32)
    # the text tower came back unchanged (up to the bf16 save)
    np.testing.assert_array_equal(
        model.text.layers[0].q_proj.weight.numpy(),
        base.text.layers[0].q_proj.weight.to(torch.bfloat16).float().numpy())
    assert not torch.equal(model.projection.weight,
                           base.projection.weight.to(torch.bfloat16).float())


MESH_RUNS = {"n_data": ["--n_data", "2"], "pipeline": ["--pipeline", "2", "--n_micro", "2"],
             "fsdp": ["--n_data", "2", "--fsdp"]}


@pytest.fixture(scope="module")
def mesh_runs(run_dir):
    """The CLI under each set of mesh flags in two gloo ranks
    (``tests/torch_mesh_ranks.py``), and the one-rank CLI on the same
    arguments: 2 steps each, saving every step, then a run resumed from
    step 1."""
    from tests.torch_mesh_ranks import spawn

    root = os.path.join(run_dir["tmp"], "mesh")
    args = _args(run_dir, "", "--stage", "2", "--steps", "2")
    i = args.index("--output")
    del args[i:i + 2]
    main(args + ["--output", os.path.join(root, "one_rank"), "--save_every", "1"])
    ranks = spawn("cli", 2, os.path.join(root, "ranks"),
                  {"root": root, "args": args, "runs": MESH_RUNS})
    return root, ranks


def _state(path):
    return torch.load(os.path.join(path, "train_state", "step_2", "train_state.pt"),
                      weights_only=True)


@pytest.mark.parametrize("name", sorted(MESH_RUNS))
def test_cli_mesh_flags_match_one_rank(mesh_runs, name):
    """``--n_data 2``, ``--pipeline 2 --n_micro 2`` and ``--n_data 2 --fsdp``
    over two ranks: the train state, the adapter (fp32, atol 1e-5: the data
    ranks' sums add in another order) and the bf16 merged checkpoint (within
    one bf16 ulp) of the one-rank CLI, written once by rank 0."""
    from visualcla_tpu_torch.checkpoint.serialize import iter_safetensors

    root, ranks = mesh_runs
    assert all(r[name] == (2, 2) for r in ranks)
    a, b = _state(os.path.join(root, "one_rank")), _state(os.path.join(root, name))
    assert a["step"] == b["step"] == 2 and a["opt_state"]["count"] == b["opt_state"]["count"]
    for part in ("params", ("opt_state", "mu"), ("opt_state", "nu")):
        x = a[part] if isinstance(part, str) else a[part[0]][part[1]]
        y = b[part] if isinstance(part, str) else b[part[0]][part[1]]
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_allclose(y[k].numpy(), x[k].numpy(), atol=1e-5, err_msg=k)
    ad = [torch.load(os.path.join(root, d, "adapter", "adapter_model.bin"), weights_only=True)
          for d in ("one_rank", name)]
    assert sorted(ad[0]) == sorted(ad[1])
    for k in ad[0]:
        np.testing.assert_allclose(ad[1][k].numpy(), ad[0][k].numpy(), atol=1e-5, err_msg=k)
    ck = [{k: torch.as_tensor(v) for k, v in
           iter_safetensors(os.path.join(root, d, "params.safetensors"))}
          for d in ("one_rank", name)]
    assert sorted(ck[0]) == sorted(ck[1])
    for k in ck[0]:
        np.testing.assert_allclose(ck[1][k].float().numpy(), ck[0][k].float().numpy(),
                                   rtol=2 ** -8, atol=1e-6, err_msg=k)
    assert os.path.exists(os.path.join(root, name, "tokenizer.model"))


@pytest.mark.parametrize("name", sorted(MESH_RUNS))
def test_cli_mesh_resume_equals_uninterrupted(mesh_runs, name):
    root, _ = mesh_runs
    a, b = _state(os.path.join(root, name)), _state(os.path.join(root, name + "_resumed"))
    for part in ("params", ("opt_state", "mu"), ("opt_state", "nu")):
        x = a[part] if isinstance(part, str) else a[part[0]][part[1]]
        y = b[part] if isinstance(part, str) else b[part[0]][part[1]]
        for k in x:
            assert torch.equal(x[k], y[k]), k
    with open(os.path.join(root, name, "params.safetensors"), "rb") as f, \
            open(os.path.join(root, name + "_resumed", "params.safetensors"), "rb") as g:
        assert f.read() == g.read()


def test_cli_pipeline_layers_must_divide(run_dir):
    """``--pipeline 3`` over the 2-layer text tower raises ValueError, as the
    JAX CLI does, before any process group comes up."""
    with pytest.raises(ValueError, match="not divisible by pipe=3"):
        main(_args(run_dir, os.path.join(run_dir["tmp"], "pipe3"), "--steps", "1",
                   "--pipeline", "3"))


def test_cli_needs_a_gpu_unless_asked_for_the_cpu(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    args = [a for a in _args(run_dir, os.path.join(run_dir["tmp"], "nogpu"), "--steps", "1")]
    i = args.index("--device")
    del args[i:i + 2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
