"""A configuration of the benchmark's shape at a size the CPU runs in
seconds: every tower present, GQA 2:1, widths that the int4 group of 128
divides, and the vocabulary the tokenizer table needs."""
from __future__ import annotations

import copy


def tiny_config(weights: str = "bf16", kv_cache: str = "bf16") -> dict:
    return copy.deepcopy({
        "name": "tiny",
        "text_config": {"hidden_size": 128, "intermediate_size": 256, "num_hidden_layers": 2,
                        "num_attention_heads": 4, "num_key_value_heads": 2,
                        "vocab_size": 22000, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
                        "max_position_embeddings": 2048, "hidden_act": "silu",
                        "tie_word_embeddings": False},
        "vision_config": {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                          "num_attention_heads": 2, "image_size": 28, "patch_size": 14,
                          "layer_norm_eps": 1e-5, "hidden_act": "quick_gelu"},
        "visual_resampler_config": {"hidden_size": 32, "intermediate_size": 64,
                                    "num_hidden_layers": 2, "num_attention_heads": 2,
                                    "num_query_tokens": 4, "hidden_act": "gelu",
                                    "layer_norm_eps": 1e-12, "add_pooling_layer": False},
        "weights": weights, "int4_group": 128, "kv_cache": kv_cache,
        "pool": {"rows": 4, "block_size": 64, "num_blocks": 64, "max_seq_len": 1024,
                 "step_chunk": 8, "prefill_chunk": 256},
    })
