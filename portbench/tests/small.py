"""Small copies of the benchmark's configurations and mixes for CPU tests:
every width cut, every mechanism kept (GQA with biases; MLA with both
low-rank branches, MoE with shared experts, a leading dense layer and
capacity drops)."""

from __future__ import annotations

import copy

from portbench import bench

SMALL = {
    "qwen2.5-3b": dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
                       intermediate_size=256, vocab_size=512, num_hidden_layers=2),
    "deepseek-v2-236b-l8": dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=4,
                                intermediate_size=256, vocab_size=512, num_hidden_layers=8,
                                kv_lora_rank=32, q_lora_rank=48, qk_nope_head_dim=16,
                                qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                                num_experts_per_tok=2, moe_intermediate_size=64,
                                n_shared_experts=2, first_k_dense_replace=1),
}


#: cells whose files stay under ``portbench/`` while BENCHMARK.json leaves them
#: out (the port does not yet run deepseek-v2-236b as published: no YaRN); the
#: tests still drive their paths (MLA, MoE, the served entry) through them
OUT_OF_BENCHMARK = {
    "deepseek-v2-236b-l8.prefill_mixed": ("deepseek-v2-236b-l8", "prefill_mixed"),
    "deepseek-v2-236b-l8.serve_b64": ("deepseek-v2-236b-l8", "serve_b64"),
}


def workload(name: str) -> dict:
    """The cell ``name`` of BENCHMARK.json, or one of OUT_OF_BENCHMARK."""
    if name in OUT_OF_BENCHMARK:
        config, traffic = OUT_OF_BENCHMARK[name]
        return dict(name=name, config=config, traffic=traffic, chips=1)
    return bench.workload(name)


def small_config(name: str, dtype: str = "bfloat16"):
    """(configuration file dict, port ModelConfig) of a small copy of ``name``."""
    cfg_file = copy.deepcopy(bench.config(name))
    cfg_file.update(SMALL[name])
    cfg_file["dtype"] = dtype
    cfg_file.pop("torch_dtype", None)
    port = dict(cfg_file["port"])
    for key in SMALL[name]:
        port[bench.PUBLISHED_TO_PORT[key]] = cfg_file[key]
    port["head_dim"] = cfg_file["hidden_size"] // cfg_file["num_attention_heads"]
    port["dtype"] = dtype
    cfg_file["port"] = port
    return cfg_file, bench.model_config(cfg_file)


def small_mix(name: str, **changes) -> dict:
    """The mix ``name`` with ``changes``; a served mix's profiled steps are
    moved into its small groups, and a held pool is cut to two cycles of
    its small lengths."""
    mix = dict(bench.traffic(name), **changes)
    if mix["entry"] == "serve" and "trace_steps" not in changes:
        mix["trace_steps"] = [1, 3]
    if mix.get("held_calls") and "held_calls" not in changes:
        mix["held_calls"] = 2 * len(mix["lengths"])
    return mix
