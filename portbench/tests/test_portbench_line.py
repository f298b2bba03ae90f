"""The shape of a run's last line, and BENCHMARK.json against the rules a
benchmark file keeps (names, units, sources, the files each entry names)."""

from __future__ import annotations

import json
import re
import time

import pytest
import torch

from portbench import bench
from portbench.run import run_cell
from portbench.tests.small import small_config, small_mix, workload as workload_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {"qwen2.5-3b.prefill_long": ("qwen2.5-3b", dict(lengths=[8, 16, 32], sample_from=1)),
         "deepseek-v2-236b-l8.serve_b64": ("deepseek-v2-236b-l8",
                                           dict(requests=4, max_batch=4, prompt_len=4,
                                                new_tokens=3, sample_from=1))}


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_last_line_shape(workload):
    config, changes = CELLS[workload]
    cfg_file, mcfg = small_config(config)
    wl = workload_of(workload)
    mix = small_mix(wl["traffic"], **changes)
    line = run_cell(wl, 2**31 + 11, 1.0, False, torch.device("cpu"), t_start=time.perf_counter(),
                    cfg_file=cfg_file, model_cfg=mcfg, mix=mix)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    json.dumps(line)
    want = {m["name"]: m["unit"] for m in bench.end_to_end_metrics(workload)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) >= set(bench.limits(workload))
    assert all(set(c) == {"value", "limit"} and c["value"] is not None
               for c in line["checks"].values())


def test_benchmark_file_keeps_the_rules():
    b = bench.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    cells = len(b["workloads"])
    assert 1 <= b["run_seconds"] <= 51
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        cfg = bench.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["source"] == cfg["source"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        for key, change in cfg["reduced"].items():
            assert cfg[key] == change["run"], key
            assert not key.endswith(("_dim", "_rank", "_size")), key
        bench.model_config(cfg)
    names = {c["name"] for c in b["configs"]}
    assert 1 <= cells <= 24
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in names and w["chips"] == 1 and len(w["why"]) <= 200
        assert (bench.HERE / "entries" / f"{bench.traffic(w['traffic'])['entry']}.py").exists()
        assert bench.limits(w["name"]), w["name"]
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"] if "workloads" in m else ()) <= {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in b["workloads"]:
        reported = {m["name"] for m in bench.end_to_end_metrics(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.per_layer_metrics(w["name"], reported)


def test_deepseek_file_holds_the_catalog_numbers():
    """Every number of the published config (as the architecture catalog
    holds it) is in the file under its key, or the key is in ``reduced``."""
    published = {"attention_bias": False, "first_k_dense_replace": 1, "hidden_size": 5120,
                 "intermediate_size": 12288, "kv_lora_rank": 512,
                 "max_position_embeddings": 163840, "moe_intermediate_size": 1536,
                 "moe_layer_freq": 1, "n_group": 8, "n_routed_experts": 160,
                 "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 128,
                 "num_experts_per_tok": 6, "num_hidden_layers": 60, "num_key_value_heads": 128,
                 "q_lora_rank": 1536, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                 "rms_norm_eps": 1e-06, "rope_theta": 10000, "routed_scaling_factor": 16,
                 "seq_aux": True, "tie_word_embeddings": False, "topk_group": 3,
                 "v_head_dim": 128, "vocab_size": 102400}
    cfg = bench.config("deepseek-v2-236b-l8")
    for key, value in published.items():
        assert cfg[key] == value or key in cfg["reduced"], key
        if key in cfg["reduced"]:
            assert cfg["reduced"][key]["published"] == value
