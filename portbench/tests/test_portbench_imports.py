"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` passes, ``repro`` fails), and
nothing reads the JAX package's benchmark folder."""

from __future__ import annotations

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

from portbench import bench

HERE = pathlib.Path(bench.__file__).resolve().parent
ROOT = HERE.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def test_names_are_compared_whole():
    assert bench.forbidden_modules(["repro_torch", "repro_torch.models", "reproducible",
                                    "jaxtyping", "flaxen", "torch"]) == []
    assert bench.forbidden_modules(["repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen",
                                    "repro_torch"]) == ["flax.linen", "jax.numpy", "jaxlib",
                                                        "repro", "repro.core"]


def test_no_source_imports_jax_or_reads_benchmarks():
    for path in SOURCES:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                names = []
            assert not bench.forbidden_modules(names), (path, names)
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "benchmarks" not in node.value and "BENCH_pipeline" not in node.value, path


RUN_SMALL_CELL = """
import json, sys, time, torch
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from portbench import bench
from portbench.run import run_cell
from portbench.tests.small import small_config, small_mix, workload
cfg_file, mcfg = small_config("deepseek-v2-236b-l8")
mix = small_mix("serve_b64", requests=4, max_batch=4, prompt_len=4, new_tokens=3)
run_cell(workload("deepseek-v2-236b-l8.serve_b64"), 5, 0.2, False, torch.device("cpu"),
         t_start=time.perf_counter(), cfg_file=cfg_file, model_cfg=mcfg, mix=mix,
         limits={{"token_gap": 1.0}})
cfg_file, mcfg = small_config("qwen2.5-3b")
mix = small_mix("prefill_long", lengths=[8, 16])
run_cell(bench.workload("qwen2.5-3b.prefill_long"), 5, 0.2, False, torch.device("cpu"),
         t_start=time.perf_counter(), cfg_file=cfg_file, model_cfg=mcfg, mix=mix)
print(json.dumps(sorted(sys.modules)))
"""


def test_a_run_loads_no_forbidden_module():
    """A whole (small, CPU) run of both entries, then the process's modules."""
    out = subprocess.run([sys.executable, "-c", RUN_SMALL_CELL.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in modules
    assert bench.forbidden_modules(modules) == []


def _run(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_a_card():
    out = _run(ROOT, "--workload", "qwen2.5-3b.prefill_long", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "qwen2.5-3b.prefill_long", "--seed", "1",
               "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""
