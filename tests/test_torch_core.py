"""The port's copy of the AMP4EC control plane (``repro_torch.core`` and
``repro_torch.models.graph``) against the reference ``repro.core``.

The samplers of ``test_engine_parity``, ``test_dag`` and ``test_faults`` are
imported, not copied: their run helpers are re-bound onto the port (every
global that names a module, class or function of ``repro`` is swapped for
the port's object of the same name), and a few tier-1 configurations of each
run on both packages. The reports must be equal bit for bit. An AST
comparison pins the copy to the reference outside the named adaptations.
"""

import ast
import importlib
import importlib.util
import inspect
import pathlib
import re
import sys
import types

import numpy as np
import pytest

import test_dag
import test_engine_parity
import test_faults

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"


def _port_twin(obj):
    """The port's counterpart of a ``repro`` module, class or function."""
    if isinstance(obj, types.ModuleType):
        name = obj.__name__
        return importlib.import_module("repro_torch" + name[5:]) if name.startswith("repro.") else obj
    mod = getattr(obj, "__module__", None) or ""
    if (inspect.isclass(obj) or inspect.isfunction(obj)) and mod.startswith("repro."):
        return getattr(importlib.import_module("repro_torch" + mod[5:]), obj.__name__)
    return obj


def _on_port(module):
    """A namespace holding ``module``'s globals with every reference object
    swapped for the port's, and the module's own functions re-bound to it."""
    from repro_torch.models.graph import mobilenetv2_graph
    ns = {k: _port_twin(v) for k, v in vars(module).items()}
    if "GRAPH" in ns:
        ns["GRAPH"] = mobilenetv2_graph()
    for k, v in vars(module).items():
        if inspect.isfunction(v) and v.__module__ == module.__name__:
            ns[k] = types.FunctionType(v.__code__, ns, v.__name__, v.__defaults__, v.__closure__)
    return types.SimpleNamespace(**ns)


def _assert_same(ref, port, what):
    """Reports of the two packages: equal bit for bit, or failed alike."""
    (r, r_ev), (p, p_ev) = ref, port
    if isinstance(r, str) or isinstance(p, str):
        assert r == p, what
        return
    assert r_ev == p_ev, what
    assert set(r.reports) == set(p.reports), what
    for name, h in r.reports.items():
        f = p.reports[name]
        assert h.columns.bitwise_equal(f.columns), f"RequestColumns differ: {name} {what}"
        assert h.batch_hist == f.batch_hist, what
        assert h.network_bytes == f.network_bytes, what
        assert h.adaptation == f.adaptation, what
        assert h.fault_stats == f.fault_stats, what
        assert h.fabric_stats == f.fabric_stats, what
    assert r.arbitration == p.arbitration, what


@pytest.mark.parametrize("core", ("fast", "heap"))
@pytest.mark.parametrize("index", range(4))
def test_engine_sampler_runs_equal_on_both_packages(index, core):
    m = test_engine_parity
    cfg = m._config_at(m.SAMPLER_SEED, index)
    _assert_same(m._run(core, cfg), _on_port(m)._run(core, cfg), f"engine config {index}")


@pytest.mark.parametrize("core", ("fast", "heap"))
@pytest.mark.parametrize("index", range(4))
def test_dag_sampler_runs_equal_on_both_packages(index, core):
    m, port = test_dag, _on_port(test_dag)
    cfg = m._config_at(m.SAMPLER_SEED, index)
    for ref_graph, port_graph in zip(m._chain_pair(cfg), port._chain_pair(cfg)):
        _assert_same(m._run(core, ref_graph, cfg), port._run(core, port_graph, cfg),
                     f"dag config {index}")


@pytest.mark.parametrize("core", ("fast", "heap"))
@pytest.mark.parametrize("index", range(4))
def test_fault_sampler_runs_equal_on_both_packages(index, core):
    m = test_faults
    cfg = m._config_at(m.SAMPLER_SEED, index)
    _assert_same(m._run(core, cfg), _on_port(m)._run(core, cfg), f"fault config {index}")


def _quickstart(pkg):
    """The quickstart's control-plane flow: partition sizes and the three
    ``run(100)`` rows."""
    core = importlib.import_module(f"{pkg}.core")
    graph = importlib.import_module(f"{pkg}.models.graph").mobilenetv2_graph()
    partitioner = core.ModelPartitioner(graph)
    mono_cluster = core.EdgeCluster()
    mono_cluster.add_node("mono", "monolithic")
    rows = [core.run_monolithic(mono_cluster, core.ModelPartitioner(graph), 100),
            core.DistributedInference(core.make_paper_cluster(), partitioner).run(100, name="amp4ec"),
            core.DistributedInference(core.make_paper_cluster(), core.ModelPartitioner(graph),
                                      use_cache=True).run(100, repeat_rate=0.8, name="amp4ec+cache")]
    return [partitioner.plan(n).sizes for n in (2, 3)], rows


def test_quickstart_flow_equal_on_both_packages():
    ref_sizes, ref_rows = _quickstart("repro")
    sizes, rows = _quickstart("repro_torch")
    assert sizes == ref_sizes == [[116, 25], [108, 16, 17]]
    for r, p in zip(ref_rows, rows):
        assert (p.name, p.steady_latency_ms, p.throughput_rps, p.network_bytes) == \
               (r.name, r.steady_latency_ms, r.throughput_rps, r.network_bytes)
        assert r.columns.bitwise_equal(p.columns), r.name


def test_port_core_public_api_documented():
    spec = importlib.util.spec_from_file_location("check_docs", ROOT / "scripts" / "check_docs.py")
    check_docs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_docs)
    assert check_docs.check_package("repro_torch.core") == []


#: the copy's deliberate differences, as edits of the reference's source
ADAPTATIONS = {
    # np.asarray raises on a CUDA tensor, and str(torch.Size) is not str(tuple)
    "core/cache.py": [
        ("import numpy as np\n", "import numpy as np\nimport torch\n"),
        ("    arr = np.asarray(x)\n",
         "    if isinstance(x, torch.Tensor):\n"
         "        x = x.detach().cpu().numpy()\n"
         "    arr = np.asarray(x)\n")],
    # the same bound as np.allclose(h, y_mono), on tensors that may be on the card
    "core/pipeline.py": [
        ("import numpy as np\n", "import numpy as np\nimport torch\n"),
        ("ok = np.allclose(np.asarray(h), np.asarray(y_mono), rtol=1e-5, atol=1e-5)",
         "ok = torch.allclose(h, y_mono, rtol=1e-5, atol=1e-5)")],
    # a chain of almost no arrivals per on/off cycle raises, where the reference walks (near) for ever
    "core/traffic.py": [
        ("        assert self.off_rate_rps >= 0, self.off_rate_rps\n",
         "        assert self.off_rate_rps >= 0, self.off_rate_rps\n"
         "        per_cycle = (self.on_rate_rps * self.mean_on_ms\n"
         "                     + self.off_rate_rps * self.mean_off_ms) / 1000.0\n"
         "        if per_cycle < 1e-3:\n"
         "            raise ValueError(f\"{self.describe()}: {per_cycle:g} expected \"\n"
         "                             f\"arrivals per on/off cycle, under 1e-3\")\n")],
    # the default artifact is the card's curves, not the host-XLA ones
    "core/cost_model.py": [
        ('CALIBRATION_ARTIFACT = pathlib.Path("artifacts/calibration/batch_curves.json")',
         'CALIBRATION_ARTIFACT = pathlib.Path("artifacts/calibration/batch_curves_h100.json")')],
}
#: where the reference's TPU stage costing (v5e constants) starts; not copied
TPU_BLOCK = "# --- TPU adaptation"
#: where the port's H100 block, its counterpart, starts
GPU_BLOCK = "# --- H100 adaptation"
COPIED = ([f"core/{p.name}" for p in sorted((REF / "core").glob("*.py"))]
          + ["models/graph.py", "configs/mobilenetv2.py"])


class _Normalise(ast.NodeTransformer):
    """Drops docstrings and reads ``repro.`` imports as ``repro_torch.``."""

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _strip

    def visit_ImportFrom(self, node):
        if node.module and (node.module == "repro" or node.module.startswith("repro.")):
            node.module = "repro_torch" + node.module[5:]
        return node


def _dump(source: str) -> str:
    return ast.dump(_Normalise().visit(ast.parse(source)))


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_reference_outside_named_adaptations(rel):
    ref = (REF / rel).read_text()
    for old, new in ADAPTATIONS.get(rel, ()):
        assert ref.count(old) == 1, (rel, old)
        ref = ref.replace(old, new)
    port = (PORT / rel).read_text()
    if rel == "core/cost_model.py":
        ref, port = ref[:ref.index(TPU_BLOCK)], port[:port.index(GPU_BLOCK)]
    assert _dump(port) == _dump(ref), rel


def test_port_verify_numerics_bound_is_the_references():
    """``torch.allclose(h, y)`` accepts and refuses where ``np.allclose(h, y)``
    does, the asymmetric |h - y| <= atol + rtol |y| included."""
    import torch
    y = np.array([1.0, 1e-3, -2.0, 0.0], np.float32)
    rng = np.random.default_rng(0)
    for scale in (1e-6, 1e-5, 2e-5, 1e-4):
        for _ in range(50):
            h = (y + rng.uniform(-scale, scale, y.shape) * (1 + np.abs(y))).astype(np.float32)
            assert torch.allclose(torch.from_numpy(h), torch.from_numpy(y), rtol=1e-5, atol=1e-5) \
                == np.allclose(h, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chain, holds", [
    pytest.param(dict(on_rate_rps=40.0, mean_on_ms=0.0, mean_off_ms=50.0), False,
                 id="zero-on-dwell-silent-off"),
    pytest.param(dict(on_rate_rps=40.0, off_rate_rps=5.0, mean_on_ms=0.0, mean_off_ms=0.0),
                 False, id="both-dwells-zero"),
    pytest.param(dict(on_rate_rps=2000.0, mean_on_ms=5e-324, mean_off_ms=5e-324), False,
                 id="subnormal-dwells"),
    pytest.param(dict(on_rate_rps=2000.0, mean_on_ms=4e-4, mean_off_ms=4e-4), False,
                 id="under-1e-3-per-cycle"),
    pytest.param(dict(on_rate_rps=2000.0, mean_on_ms=0.01, mean_off_ms=0.01, seed=5), True,
                 id="short-bursts-silent-off"),
    pytest.param(dict(on_rate_rps=40.0, off_rate_rps=5.0, mean_on_ms=0.0, mean_off_ms=50.0),
                 True, id="zero-on-dwell-busy-off"),
    pytest.param(dict(on_rate_rps=40.0, mean_on_ms=200.0, mean_off_ms=600.0, seed=3), True,
                 id="silent-off"),
    pytest.param(dict(on_rate_rps=8.0, off_rate_rps=2.0, mean_on_ms=500.0, mean_off_ms=1500.0,
                      seed=7), True, id="busy-off"),
    pytest.param(dict(on_rate_rps=400.0, mean_on_ms=0.5, mean_off_ms=0.0, seed=11), True,
                 id="short-bursts-zero-off-dwell"),
])
def test_bursty_chain_of_almost_no_arrivals_raises(chain, holds):
    """The reference walks a chain of (almost) no arrivals per on/off cycle
    for ever, or near enough; the port refuses one of under 1e-3. Every
    other chain gives the reference's offsets bit for bit."""
    from repro.core.traffic import BurstyArrivals as RefBursty
    from repro_torch.core.traffic import BurstyArrivals
    if not holds:
        with pytest.raises(ValueError, match="expected arrivals per on/off cycle, under 1e-3"):
            BurstyArrivals(**chain).offsets(64)
        return
    got = BurstyArrivals(**chain).offsets(64)
    assert got.shape == (64,) and bool(np.all(np.diff(got) >= 0))
    assert np.array_equal(got, RefBursty(**chain).offsets(64))


def test_digest_of_a_tensor_is_the_references():
    import torch
    from repro.core.cache import digest as ref_digest
    from repro_torch.core.cache import digest
    x = np.random.default_rng(1).standard_normal((2, 5, 5, 3)).astype(np.float32)
    assert digest(torch.from_numpy(x)) == digest(x) == ref_digest(x)


def test_gpu_block_is_the_data_sheets():
    """The H100 SXM's published dense bf16 rate, HBM rate and NVLink rate
    each way, and the stage and boundary times they give."""
    from repro_torch.core import cost_model as cm
    assert (cm.GPU_PEAK_FLOPS, cm.GPU_HBM_BW, cm.GPU_LINK_BW) == (989e12, 3.35e12, 450e9)
    for flops, chips in ((1.5e15, 1), (4.9e14, 128), (7.0, 64)):
        assert cm.gpu_stage_ms(flops, chips) == flops / (989e12 * chips) * 1e3
    for num_bytes in (0.0, 1.0, 3.0e8):
        assert cm.gpu_boundary_ms(num_bytes) == num_bytes / 450e9 * 1e3


STAGE = re.compile(r"  stage (\d+): layers \[\s*(\d+),\s*(\d+)\) on\s+(\d+) chips -> "
                   r"\s*([\d.]+) ms compute, boundary\s+([\d.]+) ms (ICI|NVLink)")


def _example_lines(path, block_fns, monkeypatch, capsys):
    """``main()`` of an example at qwen2.5-3b: its lines, and the arguments
    its two block functions were called with."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    calls = []
    for name in block_fns:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn: calls.append(a) or fn(*a))
    monkeypatch.setattr(sys, "argv", [str(path), "--arch", "qwen2.5-3b"])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines(), calls


def test_partition_transformer_example_matches_reference(monkeypatch, capsys):
    """The same lines as the reference's example, but for the four stage
    lines: there the layer ranges and chip counts are the reference's, and
    the times are the H100 block's on the same FLOPs and bytes."""
    from repro_torch.core.cost_model import gpu_boundary_ms, gpu_stage_ms
    ref, ref_calls = _example_lines(ROOT / "examples" / "partition_transformer.py",
                                    ("tpu_stage_ms", "tpu_boundary_ms"), monkeypatch, capsys)
    port, calls = _example_lines(ROOT / "examples" / "partition_transformer_torch.py",
                                 ("gpu_stage_ms", "gpu_boundary_ms"), monkeypatch, capsys)
    assert calls == ref_calls and len(calls) == 8
    assert len(port) == len(ref)
    stages = [(r, p) for r, p in zip(ref, port) if STAGE.fullmatch(r)]
    assert len(stages) == 4
    assert [r for r, _ in stages] == ref[-4:]
    assert port[:-4] == ref[:-4]
    for i, (r, p) in enumerate(stages):
        rm, pm = STAGE.fullmatch(r), STAGE.fullmatch(p)
        assert pm and pm.group(7) == "NVLink", p
        assert pm.groups()[:4] == rm.groups()[:4]
        (flops, chips), (num_bytes,) = calls[2 * i], calls[2 * i + 1]
        assert int(pm.group(4)) == chips
        assert pm.group(5) == f"{gpu_stage_ms(flops, chips):.3f}"
        assert pm.group(6) == f"{gpu_boundary_ms(num_bytes):.3f}"


def _calibrated_run(pkg, method, calibrated=True):
    """MobileNetV2 on the paper cluster, planned and micro-batched at k = 4
    with the reference's committed calibration artifact (or the analytic
    model): (plan, placement, report)."""
    core = importlib.import_module(f"{pkg}.core")
    cost_model = importlib.import_module(f"{pkg}.core.cost_model")
    engine = importlib.import_module(f"{pkg}.core.engine")
    graph = importlib.import_module(f"{pkg}.models.graph").mobilenetv2_graph()
    model = cost_model.BatchCostModel.from_artifact(
        ROOT / "artifacts" / "calibration" / "batch_curves.json") if calibrated else None
    d = core.DistributedInference(core.make_paper_cluster(), core.ModelPartitioner(graph),
                                  method=method, expected_k=4, batch_model=model)
    rep = d.run(200, engine=engine.EngineConfig(transfer="overlap", micro_batch=4,
                                                adaptive_batch=True))
    return [(p.lo, p.hi) for p in d.plan.partitions], dict(d.placement), rep


@pytest.mark.parametrize("method", ("greedy", "planner"))
def test_calibrated_distributed_inference_equal_on_both_packages(method):
    """The batch-aware path with calibrated curves: the same plan and a
    bit-equal report on both packages, and a report that differs from the
    analytic model's (so the curves were read)."""
    ref_plan, ref_place, r = _calibrated_run("repro", method)
    plan, place, p = _calibrated_run("repro_torch", method)
    assert (plan, place) == (ref_plan, ref_place)
    assert r.columns.bitwise_equal(p.columns)
    assert (r.batch_hist, r.network_bytes, r.adaptation) == \
        (p.batch_hist, p.network_bytes, p.adaptation)
    *_, analytic = _calibrated_run("repro_torch", method, calibrated=False)
    assert not analytic.columns.bitwise_equal(p.columns)
