"""The port's batch-cost calibration (``scripts/calibrate_costmodel_torch.py``)
against the reference's (``scripts/calibrate_costmodel.py``).

Both scripts are loaded by path. Their fits and curve arithmetic must agree
bit for bit on one injected timing table, chosen so that a class passes the
tail threshold, classes are clipped at both ends of ``SCALE_CLIP`` and a
class has a zero fixed term. The port's sweep also runs end to end on the
CPU (the kernels' plain versions), and on the card (``gpu``) it must launch
each of the three Hopper kernels. Each point keeps the least of its
passes, and a stall that outlasts them is flagged and refused.
"""

import importlib.util
import json
import pathlib
import re
from dataclasses import astuple

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = ("Attention", "SSD", "RGLRU", "Linear", "Conv2d")
#: t(k) in µs at k = 1, 2, 4, 8. SSD bends up past k = 4 (a tail); RGLRU's
#: fit has a negative intercept (a zero fixed term); RGLRU's per-item cost
#: per unit is far above the mean and Linear's and Conv2d's far below (both
#: clip ends of the per-item scale), as are Attention's and Linear's
#: overhead shares (both clip ends of the overhead)
TABLE = {"Attention": (1020.0, 2020.0, 4020.0, 8020.0),
         "SSD": (400.0, 800.0, 1200.0, 3200.0),
         "RGLRU": (10.0, 30.0, 80.0, 160.0),
         "Linear": (150.0, 200.0, 300.0, 500.0),
         "Conv2d": (300.0, 500.0, 900.0, 1700.0)}


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port():
    return _load("scripts/calibrate_costmodel_torch.py", "calibrate_costmodel_torch")


@pytest.fixture(scope="module")
def ref():
    return _load("scripts/calibrate_costmodel.py", "calibrate_costmodel")


def test_constants_are_the_references(port, ref):
    for name in ("K_SWEEP", "SMALL_K", "TAIL_THRESHOLD", "SCALE_CLIP", "N_REPS"):
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("ts", [TABLE[k] for k in KINDS] + [(5.0, 4.0, 3.0, 1.0)])
def test_fit_is_bit_equal(port, ref, ts):
    ks = list(ref.K_SWEEP)
    assert port._fit(ks, list(ts)) == ref._fit(ks, list(ts))


def test_kernel_cases_have_the_references_kinds_and_unit_costs(port, ref):
    """The factories are not called: only their (kind, unit_cost) pairs."""
    want = [(kind, cost) for kind, cost, _ in ref._kernel_cases()]
    assert [(kind, cost) for kind, cost, _ in port._kernel_cases("cpu")] == want
    assert [kind for kind, _ in want] == list(KINDS)


def _inject(monkeypatch, module, unit_costs):
    """``_kernel_cases`` and ``_bench_us`` of ``module`` replaced by the table:
    each factory hands back the key its timing is looked up by."""
    ks = module.K_SWEEP

    def cases(*_):
        return [(kind, unit_costs[kind], lambda k, kind=kind: (kind, k)) for kind in KINDS]

    def bench(thunk, *args, n=None):
        kind, k = thunk
        return TABLE[kind][ks.index(k)]

    monkeypatch.setattr(module, "_kernel_cases", cases)
    monkeypatch.setattr(module, "_bench_us", bench)


def test_injected_timings_give_equal_curves(port, ref, monkeypatch):
    unit_costs = {kind: cost for kind, cost, _ in ref._kernel_cases()}
    _inject(monkeypatch, ref, unit_costs)
    _inject(monkeypatch, port, unit_costs)
    ref_model, ref_rows = ref.run_calibration()
    model, rows = port.run_calibration("cpu")
    curves = model.curves
    assert set(curves) == set(KINDS) | {"CrossAttention", "default"}
    # the two packages' KindCurve classes differ: compare their fields
    assert {k: astuple(c) for k, c in curves.items()} == \
        {k: astuple(c) for k, c in ref_model.curves.items()}
    got, want = model.to_artifact_dict(), ref_model.to_artifact_dict()
    assert got.pop("source") != want.pop("source")
    assert got == want
    # the table reaches every branch of the arithmetic
    lo, hi = ref.SCALE_CLIP
    assert {c.per_item_scale for c in curves.values()} >= {lo, hi}
    assert {c.overhead_ms / ref.FIXED_OVERHEAD_MS for c in curves.values()} >= {lo, hi}
    assert any(lo < c.per_item_scale < hi for k, c in curves.items() if k != "default")
    assert curves["SSD"].knee_k == ref.SMALL_K[-1] and curves["SSD"].tail_scale > ref.TAIL_THRESHOLD
    assert [r["fixed_us"] for r in rows if r["kind"] == "RGLRU"] == [0.0]
    for r, w in zip(rows, ref_rows):
        assert {k: r[k] for k in w} == w


@pytest.mark.parametrize("ts, want", [
    ((53.2, 201.8, 59.9, 54.4), [2]),        # a stall at k = 2
    ((234.5, 83.1, 80.7, 227.3), [1]),
    ((72.0, 88.7, 105.3, 10362.9), [8]),      # the last point past any tail
    ((44.7, 67.2, 109.8, 342.3), []),         # a tail the curve can clip
    ((110.2, 106.7, 94.1, 107.9), []),        # fixed cost alone
    (TABLE["SSD"], []),
])
def test_stalled_points(port, ts, want):
    assert port._stalled(list(ts)) == want


def test_a_stall_in_one_pass_is_dropped_and_a_lasting_one_refused(
        port, ref, monkeypatch, tmp_path):
    """Each point keeps the least of its passes; a stall in every pass is
    flagged, timed to MAX_PASSES, and keeps the port's artifact unwritten."""
    unit_costs = {kind: cost for kind, cost, _ in ref._kernel_cases()}
    _inject(monkeypatch, port, unit_costs)
    clean = port._bench_us
    seen = set()

    def first_pass_stalls(thunk, *args, n=None):
        stall = 1000.0 if thunk not in seen else 0.0
        seen.add(thunk)
        return clean(thunk) + stall
    monkeypatch.setattr(port, "_bench_us", first_pass_stalls)
    _, rows = port.run_calibration("cpu")
    for r in rows:
        assert r["t_us"] == {str(k): t for k, t in zip(port.K_SWEEP, TABLE[r["kind"]])}
        assert len(r["passes_us"]) == port.N_PASSES and "stalled_k" not in r

    monkeypatch.setattr(port, "_bench_us", lambda thunk, *a, n=None: (
        clean(thunk) * (10.0 if thunk == ("RGLRU", 2) else 1.0)))
    monkeypatch.setattr(port, "REPO", tmp_path)
    with pytest.raises(RuntimeError, match="host stalls"):
        port.main(tmp_path / port.CALIBRATION_ARTIFACT, device="cpu")
    assert not (tmp_path / port.CALIBRATION_ARTIFACT).exists()
    out = port.main(tmp_path / "elsewhere.json", device="cpu")
    rglru = [r for r in json.loads(out.read_text())["bench"] if r["kind"] == "RGLRU"][0]
    assert rglru["stalled_k"] == [2] and len(rglru["passes_us"]) == port.MAX_PASSES


def test_cpu_sweep_writes_a_calibrated_artifact(port, monkeypatch, tmp_path, capsys):
    from repro_torch.core.cost_model import BatchCostModel
    monkeypatch.setattr(port, "N_REPS", 1)
    with pytest.raises(ValueError):
        port.main(device="cpu")          # never over the card's artifact
    out = port.main(tmp_path / "curves.json", device="cpu")
    model = BatchCostModel.from_artifact(out)
    assert not model.is_analytic and model.source.startswith("kernel-microbench-cpu")
    assert set(model.curves) == set(KINDS) | {"CrossAttention", "default"}
    body = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == body
    assert [r["kind"] for r in body["bench"]] == list(KINDS)
    assert body["k_sweep"] == [1, 2, 4, 8]


def test_committed_card_artifact_loads_as_calibrated():
    """The card's curves, where committed, are what the port's cost model
    reads; without them it falls back to the analytic model."""
    from repro_torch.core.cost_model import CALIBRATION_ARTIFACT, BatchCostModel
    path = ROOT / CALIBRATION_ARTIFACT
    model = BatchCostModel.from_artifact(path)
    if not path.exists():
        assert model.is_analytic and model.source == "analytic-fallback"
        return
    assert not model.is_analytic
    assert set(model.curves) == set(KINDS) | {"CrossAttention", "default"}
    assert re.fullmatch(r"kernel-microbench-h100: .*H100.*, \d+(\.\d+)? W", model.source), \
        model.source
    bench = {r["kind"]: r for r in json.loads(path.read_text())["bench"]}
    assert all(bench[k]["launches"] > 0 for k in ("Attention", "SSD", "RGLRU"))


@pytest.mark.gpu
def test_sweep_on_the_card_launches_each_kernel(port, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(port, "N_REPS", 1)
    model, rows = port.run_calibration("cuda")
    assert not model.is_analytic and "H100" in model.source
    by_kind = {r["kind"]: r for r in rows}
    for kind in ("Attention", "SSD", "RGLRU"):
        # a warm-up and N_REPS timed calls per point and pass
        calls = len(port.K_SWEEP) * 2 * len(by_kind[kind]["passes_us"])
        assert by_kind[kind]["launches"] == calls, by_kind[kind]
        # fp32 inputs take the CUDA-core variants
        if kind != "RGLRU":
            assert by_kind[kind]["variants"] == {"cuda_core": calls}
