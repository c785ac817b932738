"""``models.visualcla.resize_token_embeddings`` over a built model against
the JAX function on ``tiny_visualcla_config(vocab_size=100)`` in fp32: the
kept rows bitwise, the shapes when growing to 108 and shrinking to 96, the
new rows' mean and standard deviation within 4 sigma of N(0, 0.02) (the JAX
rows come from ``jax.random``, so their bits are not the spec), a forward
over ids 105 and 107 at width 108, the dtype and device of the new rows,
and the refusals: the int8 / int4 head tiers, a LoRA head and a model
sharded over a mesh.

Tolerance: kept rows exact; new rows' statistics within 4 sigma."""
import dataclasses

import numpy as np
import pytest
import torch

from visualcla_tpu_torch.models import visualcla as t_vis

STD = 0.02


@pytest.fixture(scope="module")
def pair():
    import jax
    import jax.numpy as jnp

    from tests.test_torch_host import port_config
    from visualcla_tpu.checkpoint.serialize import flatten_tree
    from visualcla_tpu.core.config import tiny_visualcla_config
    from visualcla_tpu.models import visualcla as j_vis

    jcfg = tiny_visualcla_config(vocab_size=100)
    params = j_vis.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tree = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    return jcfg, params, port_config(jcfg), tree


def _model(pair):
    from visualcla_tpu_torch.checkpoint.from_jax import build_model

    _, _, cfg, tree = pair
    return build_model(tree, cfg, device="cpu", dtype=torch.float32)


def _check_draw(rows: np.ndarray):
    n = rows.size
    assert abs(rows.mean()) < 4 * STD / np.sqrt(n)
    # the sample std's own sigma is about std / sqrt(2n)
    assert abs(rows.std() - STD) < 4 * STD / np.sqrt(2 * n)


@pytest.mark.parametrize("new_size", [108, 96, 100])
def test_resize_matches_the_jax_function(pair, new_size):
    import jax.numpy as jnp

    from visualcla_tpu.models import llama as j_llama
    from visualcla_tpu.models import visualcla as j_vis

    jcfg, params, _, _ = pair
    model = _model(pair)
    old_embed = model.text.embed_tokens.detach().clone()
    old_head = model.text.lm_head.weight.detach().clone()
    assert t_vis.resize_token_embeddings(model, new_size, torch.Generator().manual_seed(3)) \
        is model
    want = j_vis.resize_token_embeddings(params, new_size)["text"]
    embed, head = model.text.embed_tokens.detach(), model.text.lm_head.weight.detach()
    H = jcfg.text_config.hidden_size
    assert tuple(embed.shape) == tuple(want["embed_tokens"].shape) == (new_size, H)
    assert tuple(head.shape) == tuple(np.asarray(want["lm_head"]).T.shape) == (new_size, H)
    kept = min(new_size, 100)
    np.testing.assert_array_equal(embed[:kept].numpy(), np.asarray(want["embed_tokens"])[:kept])
    np.testing.assert_array_equal(head[:kept].numpy(), np.asarray(want["lm_head"]).T[:kept])
    np.testing.assert_array_equal(embed[:kept].numpy(), old_embed[:kept].numpy())
    np.testing.assert_array_equal(head[:kept].numpy(), old_head[:kept].numpy())
    assert not model.text.embed_tokens.requires_grad
    if new_size > 100:
        _check_draw(embed[100:].numpy())
        _check_draw(head[100:].numpy())
        # a forward over ids in the new range: logits of the new width, and
        # the JAX forward's over the JAX rows' own draw is the same shape
        ids = torch.tensor([[1, 105, 107]])
        got = model.text.forward_logits(ids)
        assert got.shape == (1, 3, new_size) and torch.isfinite(got).all()
        jcfg2 = dataclasses.replace(jcfg, text_config=dataclasses.replace(
            jcfg.text_config, vocab_size=new_size))
        jl = j_llama.forward_logits(j_vis.resize_token_embeddings(params, new_size)["text"],
                                    jcfg2.text_config, jnp.asarray(ids.numpy(), jnp.int32))
        assert jl.shape == got.shape


def test_new_rows_follow_the_generator_and_the_leaf_dtype(pair):
    a, b = _model(pair), _model(pair)
    t_vis.resize_token_embeddings(a, 110, torch.Generator().manual_seed(7))
    t_vis.resize_token_embeddings(b, 110, torch.Generator().manual_seed(7))
    assert torch.equal(a.text.embed_tokens, b.text.embed_tokens)
    assert torch.equal(a.text.lm_head.weight, b.text.lm_head.weight)
    assert not torch.equal(a.text.embed_tokens[100:], a.text.lm_head.weight[100:])
    c = _model(pair).to(torch.bfloat16)
    t_vis.resize_token_embeddings(c, 110)  # default: a CPU generator seeded 0
    assert c.text.embed_tokens.dtype == c.text.lm_head.weight.dtype == torch.bfloat16
    assert c.text.embed_tokens.device.type == "cpu"


@pytest.mark.parametrize("bits,head,tier", [(8, True, "int8"), (4, True, "int4")])
def test_quantized_head_tiers_raise(pair, bits, head, tier):
    model = t_vis.quantize_text_tower_(_model(pair), bits, head=head)
    with pytest.raises(ValueError, match="int8 tier"):  # the table is per-row int8 at both
        t_vis.resize_token_embeddings(model, 108)
    model.text.embed_tokens = torch.nn.Parameter(torch.zeros(100, 16), requires_grad=False)
    with pytest.raises(ValueError, match=f"LM head is at the {tier} tier"):
        t_vis.resize_token_embeddings(model, 108)


def test_lora_head_and_meshed_model_raise(pair):
    from visualcla_tpu_torch.ops.linear import LoraLinear

    model = _model(pair)
    head = model.text.lm_head
    model.text.lm_head = LoraLinear(head, 2)
    with pytest.raises(ValueError, match="LoRA tier"):
        t_vis.resize_token_embeddings(model, 108)
    model = _model(pair)
    model.mesh = object()  # what parallel.tp.attach records on a sharded model
    with pytest.raises(ValueError, match="before shard_params"):
        t_vis.resize_token_embeddings(model, 108)
