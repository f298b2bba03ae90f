"""What the harness finds by name: the benchmark's cells, configurations,
traffic mixes, limits and per-layer metric readers.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric sits in a file of its own, named after it:

  portbench/configs/<config>.json     sizes as run, the source, what was cut
  portbench/traffic/<mix>.json        the entry the window drives and its load
  portbench/entries/<entry>.py        ``build`` and ``Entry``: what a window drives
  portbench/limits/<workload>.json    each compared number's limit, and the
                                      readings the limit was set from
  portbench/metrics/<metric>.py       ``read(ctx)``: one per-layer number
  portbench/reference/<family>.py     the plain fp32 reference of a family, its
                                      random-weight scales and its operation count

so that a new cell, mix or metric is new files and entries in
``BENCHMARK.json``, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: the H100 SXM data sheet's dense peaks (the benchmark's own constants)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

#: the published config's keys and the port's ModelConfig fields they set;
#: the harness refuses a configuration file that disagrees with what it runs
PUBLISHED_TO_PORT = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "d_ff", "vocab_size": "vocab_size", "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings",
    "n_routed_experts": "num_experts", "num_experts_per_tok": "top_k",
    "moe_intermediate_size": "d_ff_expert", "n_shared_experts": "num_shared_experts",
    "first_k_dense_replace": "first_dense_layers", "kv_lora_rank": "kv_lora_rank",
    "q_lora_rank": "q_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
    "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
    "torch_dtype": "dtype",
}

#: top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list:
    """The names among ``names`` whose top-level name (before the first
    dot), compared whole, is one of FORBIDDEN_MODULES."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN_MODULES)


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}")


def config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str) -> dict:
    """{number: limit} for the cell's comparison ({} for a cell without a
    limits file, which then never reads correct)."""
    path = HERE / "limits" / f"{workload_name}.json"
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {k: v["limit"] for k, v in data["numbers"].items()}


def reference(family: str):
    return importlib.import_module(f"portbench.reference.{family}")


def _load(kind: str, name: str, folder: pathlib.Path):
    """The module ``<folder>/<name>.py`` (names may hold dots)."""
    path = folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, folder: pathlib.Path = HERE / "metrics"):
    """The ``read`` function of ``<folder>/<name>.py``."""
    return _load("metric", name, folder).read


def entry(name: str, folder: pathlib.Path = HERE / "entries"):
    """The entry module ``<folder>/<name>.py`` (``build``, ``Entry``)."""
    return _load("entry", name, folder)


def per_layer_metrics(workload_name: str, end_to_end: set) -> list:
    """The per-layer metrics a cell reports: those that list it, or, without
    a list, those whose end-to-end metric the cell reports."""
    return [m for m in benchmark()["per_layer"]
            if workload_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in end_to_end)]


def end_to_end_metrics(workload_name: str) -> list:
    return [m for m in benchmark()["end_to_end"]
            if "workloads" not in m or workload_name in m["workloads"]]


def model_config(cfg_file: dict):
    """The port's ModelConfig for a configuration file: the registry's
    architecture with the file's ``port`` overrides, checked against every
    published key the file states."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(cfg_file["arch"]), **cfg_file.get("port", {}))
    for key, field in PUBLISHED_TO_PORT.items():
        if key not in cfg_file:
            continue
        want, got = cfg_file[key], getattr(cfg, field)
        if key == "torch_dtype":
            ok = want == got
        elif key == "q_lora_rank" and want is None:
            ok = got == 0
        else:
            ok = float(want) == float(got)
        if not ok:
            raise ValueError(f"{cfg_file['arch']}: the file states {key} = {want!r}, "
                             f"the port would run {field} = {got!r}")
    if cfg.dtype != cfg_file["dtype"]:
        raise ValueError(f"{cfg_file['arch']}: dtype {cfg.dtype} != {cfg_file['dtype']}")
    return cfg
