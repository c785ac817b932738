"""The port's mesh layer against the JAX package's, on the CPU: the partition
rules leaf for leaf; then, in four spawned gloo ranks on a (data=2, model=2)
mesh (``tests/torch_mesh_ranks.py``), the TP x DP forward at the dense, int8
and int4 tiers against the JAX forward on ``Mesh(devices[:4].reshape(2, 2))``
and the port's unmeshed forward, on a config whose vocabulary, int4 groups
and GQA heads exercise every collective rule (the odd vocabulary and the
3-group ``down_proj`` stay whole, the 1-group ``o_proj`` too);
``ring_attention_sharded`` on a (data=1, seq=4) mesh against JAX's; and the
sharded load, which copies only a rank's bytes out of the map.

Tolerances: logits atol = rtol = 1e-5 (fp32: the sums over the model axis
add in another order than one device's); the ring 2e-5 (fp32 online
softmax); specs, shapes and loaded tensors exactly."""
import os

import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import _forward_logits, spawn
from visualcla_tpu_torch.checkpoint.from_jax import build_model
from visualcla_tpu_torch.parallel import sharding as t_shd

ATOL = 1e-5


def jax_config():
    from visualcla_tpu.core.config import LlamaConfig, ResamplerConfig, ViTConfig, VisualCLAConfig

    return VisualCLAConfig(
        text_config=LlamaConfig(vocab_size=97, hidden_size=32, intermediate_size=48,
                                num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, max_position_embeddings=256),
        vision_config=ViTConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                                num_attention_heads=2, image_size=28, patch_size=14),
        visual_resampler_config=ResamplerConfig(hidden_size=16, num_hidden_layers=2,
                                                num_attention_heads=2, intermediate_size=32,
                                                num_query_tokens=4))


def _numpy_flat(tree):
    from visualcla_tpu.checkpoint.serialize import flatten_tree

    return {k: np.asarray(v) for k, v in flatten_tree(tree).items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from tests.test_torch_host import port_config
    from visualcla_tpu.checkpoint import save_checkpoint
    from visualcla_tpu.models import llama as j_llama
    from visualcla_tpu.models import visualcla as j_vis
    from visualcla_tpu.ops.quantization import quantize_tree
    from visualcla_tpu.parallel import ring as j_ring
    from visualcla_tpu.parallel import sharding as j_shd

    tmp = str(tmp_path_factory.mktemp("mesh"))
    jcfg = jax_config()
    params = j_vis.init_params(jax.random.PRNGKey(3), jcfg, jnp.float32)
    trees = {"dense": params, "int8": quantize_tree(params, bits=8),
             "int4": quantize_tree(params, bits=4, group=128)}
    rng = np.random.default_rng(4)
    B, S = 4, 16
    ids = rng.integers(3, 90, (B, S)).astype(np.int64)
    ids[:, 3] = 95
    inp = {"ids": ids, "mask": np.ones((B, S), np.int64),
           "img_pos": np.full((B,), 3, np.int64),
           "pixels": rng.normal(size=(B, 3, 28, 28)).astype(np.float32)}
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    data_sh = NamedSharding(mesh, P("data"))

    def run(p, ids, mask, img_pos, pixels):
        cache = j_llama.init_kv_cache(jcfg.text_config, B, S, jnp.float32)
        return j_vis.prefill_forward(p, jcfg, ids, mask, img_pos, pixels, cache)[0]

    want = {}
    for tier, tree in trees.items():
        with mesh:
            want[tier] = np.asarray(jax.jit(run)(
                j_shd.shard_params(tree, mesh),
                *(jax.device_put(jnp.asarray(inp[k]), data_sh)
                  for k in ("ids", "mask", "img_pos", "pixels"))))
    ckpt = os.path.join(tmp, "ckpt")
    save_checkpoint(ckpt, params, jcfg, dtype="float32")
    # ring: GQA (4 q heads over 2 kv heads) with padding, over (data=1, seq=4)
    q = rng.normal(size=(2, 64, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 8)).astype(np.float32)
    valid = np.ones((2, 64), bool)
    valid[1, 40:] = False
    cp = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4), ("data", "seq"))
    want_ring = np.asarray(j_ring.ring_attention_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cp, kv_valid=jnp.asarray(valid)))
    # B2u's mesh form (the JAX package's test_sharded_flash shapes) on (2, 2)
    from visualcla_tpu.ops import attention as j_attn

    fq = rng.standard_normal((4, 16, 8, 64)).astype(np.float32)
    fk = rng.standard_normal((4, 8, 64, 64)).astype(np.float32)  # cache order
    fv = rng.standard_normal((4, 8, 64, 64)).astype(np.float32)
    fvalid = np.zeros((4, 64), bool)
    fvalid[:, 4:20] = True
    want_flash = np.asarray(j_attn._flash_sharded(
        jax.device_put(jnp.asarray(fq), NamedSharding(mesh, P("data", None, "model", None))),
        *(jax.device_put(jnp.asarray(t), NamedSharding(mesh, P("data", "model", None, None)))
          for t in (fk, fv)),
        jax.device_put(jnp.asarray(fvalid), data_sh), jnp.int32(4), mesh))
    want_dense3 = np.asarray(j_attn.cached_attention(
        jnp.asarray(fq[:, :, :3]), jnp.asarray(fk[:, :3]), jnp.asarray(fv[:, :3]),
        jnp.asarray(fvalid), jnp.int32(4), impl="xla"))
    cfg = port_config(jcfg)
    flat = {tier: _numpy_flat(tree) for tier, tree in trees.items()}
    payload = {"trees": flat, "cfg": cfg, "inp": inp, "ckpt": ckpt,
               "ring": {"q": q, "k": k, "v": v, "valid": valid},
               "flash": {"q": fq, "k": fk, "v": fv, "valid": fvalid}}
    ranks = spawn("forward", 4, os.path.join(tmp, "ranks"), payload)
    unmeshed = {tier: _forward_logits(build_model(f, cfg, device="cpu", dtype=torch.float32),
                                      cfg, inp) for tier, f in flat.items()}
    return {"want": want, "ranks": ranks, "unmeshed": unmeshed, "ring": want_ring,
            "flash": want_flash, "dense3": want_dense3,
            "cfg": cfg, "flat": flat, "ckpt": ckpt, "trees": trees}


# ---------------------------------------------------------------------------
# the partition rules (no ranks)
# ---------------------------------------------------------------------------

def _spec_tree_equal(j, t):
    from visualcla_tpu.checkpoint.serialize import flatten_tree

    jf, tf = flatten_tree(j), flatten_tree(t)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tuple(jf[k]) == tf[k], k


@pytest.mark.parametrize("tier", ["dense", "int8", "int4"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
def test_param_specs_match_jax(tier, fsdp):
    import jax
    import jax.numpy as jnp

    from visualcla_tpu.models import visualcla as j_vis
    from visualcla_tpu.ops.quantization import quantize_tree
    from visualcla_tpu.parallel import sharding as j_shd

    params = j_vis.init_params(jax.random.PRNGKey(0), jax_config(), jnp.float32)
    if tier != "dense":
        params = quantize_tree(params, bits=8 if tier == "int8" else 4)
    shapes = jax.tree.map(lambda x: np.broadcast_to(np.zeros((), bool), np.shape(x)), params)
    _spec_tree_equal(j_shd.param_specs(params, fsdp=fsdp), t_shd.param_specs(shapes, fsdp=fsdp))


@pytest.mark.parametrize("key", ["text/layers/q_proj", "text/layers/down_proj/scale",
                                 "text/lm_head/q", "vision/layers/o_bias",
                                 "resampler/layers/inter_bias", "projection/weight",
                                 "projection/bias", "embed_tokens", "", "vision/pre_layernorm"])
def test_lookup_flat_matches_jax(key):
    from visualcla_tpu.parallel import sharding as j_shd

    assert tuple(j_shd._lookup_flat(key)) == t_shd._lookup_flat(key)


@pytest.mark.parametrize("spec,shape", [
    ((None, "model"), (3, 6)), ((None, "model"), (3, 8)), (("data", None, "model"), (4, 5, 12)),
    (("data", "model"), (3, 4)), ((None, None, "model"), (2, 8)), (("seq", "model"), (8, 8))])
def test_valid_spec_matches_jax(spec, shape):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from visualcla_tpu.parallel import sharding as j_shd

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    assert tuple(j_shd._valid_spec(P(*spec), shape, mesh)) == t_shd._valid_spec(
        spec, shape, {"data": 2, "model": 4})


def test_kv_cache_and_batch_specs_match_jax():
    from visualcla_tpu.parallel import sharding as j_shd

    assert {k: tuple(v) for k, v in j_shd.kv_cache_specs().items()} == t_shd.kv_cache_specs()
    assert tuple(j_shd.batch_spec()) == t_shd.batch_spec()


def test_mesh_must_be_a_device_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        t_shd.check_mesh({"data": 2, "model": 2})


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["dense", "int8", "int4"])
def test_tp_dp_forward_matches_jax_mesh(setup, tier):
    for r in setup["ranks"]:
        np.testing.assert_allclose(r[f"logits_{tier}"], setup["want"][tier], atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("tier", ["dense", "int8", "int4"])
def test_tp_dp_forward_matches_unmeshed_port(setup, tier):
    for r in setup["ranks"]:
        np.testing.assert_allclose(r[f"logits_{tier}"], setup["unmeshed"][tier], atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("tier", ["dense", "int8", "int4"])
def test_each_rank_holds_its_shard(setup, tier):
    """Sharded leaves hold half their columns or rows; the leaves that do
    not divide ``model`` stay whole (the odd vocabulary, int4's 3-group
    down_proj and 1-group o_proj); the local heads are 2 q over 1 kv."""
    shapes = setup["ranks"][0][f"shapes_{tier}"]
    V, H, I = 97, 32, 48
    assert shapes["vision.layers.0.q_proj.weight"] == (8, 16)
    assert shapes["vision.layers.0.o_proj.weight"] == (16, 8)
    assert shapes["vision.layers.0.o_proj.bias"] == (16,)
    assert shapes["projection.weight"] == (16, 16)
    assert setup["ranks"][0][f"heads_{tier}"][0][:2] == (2, 1)
    if tier == "dense":
        assert shapes["text.lm_head.weight"] == (V, H)  # 97 % 2: whole
        assert shapes["text.embed_tokens"] == (V, H // 2)
        assert shapes["text.layers.0.down_proj.weight"] == (H, I // 2)
    elif tier == "int8":
        assert shapes["text.lm_head.q"] == (V, H)
        assert shapes["text.layers.0.o_proj.q"] == (H, H // 2)
        assert shapes["text.layers.0.o_proj.scale"] == (1, H)  # the whole contraction's
        assert shapes["text.embed_tokens.q"] == (V, H // 2)
    else:
        assert shapes["text.layers.0.gate_proj.q"] == (1, 16, I // 2)
        assert shapes["text.layers.0.down_proj.q"] == (3, 8, H)  # 3 groups: whole
        assert shapes["text.layers.0.o_proj.q"] == (1, 16, H)  # 1 group: whole
        assert shapes["text.lm_head.q"] == (1, 16, V)


def test_ring_attention_sharded_matches_jax(setup):
    for r in setup["ranks"]:
        np.testing.assert_allclose(r["ring"], setup["ring"], atol=2e-5, rtol=2e-5)


def test_sharded_load_reads_only_the_rank_bytes(setup):
    """Each rank copies exactly its local tensors' bytes out of the map (the
    fp32 file): less than the file holds."""
    size = os.path.getsize(os.path.join(setup["ckpt"], "params.safetensors"))
    for r in setup["ranks"]:
        assert r["read_bytes"] == r["local_bytes"]
        assert r["read_bytes"] < 0.75 * size


def test_sharded_load_equals_shard_params(setup):
    for r in setup["ranks"]:
        assert r["load_equal"]
        np.testing.assert_allclose(r["logits_loaded"], setup["want"]["dense"], atol=ATOL,
                                   rtol=ATOL)


@pytest.mark.parametrize("tier", ["dense", "int8", "int4"])
def test_build_model_shards_the_jax_tree_straight_to_the_rank(setup, tier):
    """``build_model(flat, cfg, mesh=)`` cuts each numpy leaf to the rank's
    slice: the same tensors as a whole model sliced by ``shard_params``."""
    for r in setup["ranks"]:
        if tier == "dense":
            assert r["built_equal"]["dense"]
        np.testing.assert_allclose(r["built_logits"][tier], setup["want"][tier], atol=ATOL,
                                   rtol=ATOL)


def test_initialize_is_a_noop_when_up_and_pod_mesh_shapes(setup):
    for r in setup["ranks"]:
        assert r["pod"] == (("data", "model"), (2, 2))
        assert r["default"] == (1, 4)  # every rank on 'model' by default


def test_ranks_never_load_jax(setup):
    assert not any(r["jax_loaded"] for r in setup["ranks"])


def test_flash_sharded_matches_jax(setup):
    """B2u's mesh form (each rank runs the plain version of B2u here on its
    rows and kv heads) against JAX's ``_flash_sharded`` on the same (2, 2)
    mesh, within 2e-5 (fp32); 3 heads over model = 2 give None, and
    ``cached_attention`` under the mesh scope then runs B2u on the whole
    arrays (its plain version here), held against JAX's dense path."""
    for r in setup["ranks"]:
        np.testing.assert_allclose(r["flash_sharded"], setup["flash"], atol=2e-5, rtol=2e-5)
        assert r["flash_indivisible"] is None
        np.testing.assert_allclose(r["flash_fallback"], setup["dense3"], atol=2e-5,
                                   rtol=2e-5)
