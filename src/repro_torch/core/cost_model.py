"""AMP4EC cost model (paper §III-B2, Eq. 1/2/9) + edge-node timing model.

The *layer* costs live on the ``ModelGraph`` (see models/graph.py). This
module turns partition costs into simulated execution times on heterogeneous
edge nodes. In place of the reference's TPU stage costing, its last block
holds the H100's published peaks (NVIDIA's data sheet) and the stage and
boundary times they give, for mesh stage assignment on the card.

Calibration: Table II of the paper gives per-profile inference times that are
exactly proportional to 1/CPU (234.56 * 1.0 ≈ 389.27 * 0.6 ≈ 583.91 * 0.4 ≈
233.6 cpu·ms). We anchor the simulator's base throughput so that one
balanced 3-way MobileNetV2 partition on a 1.0-CPU node takes 234.56 ms —
reproducing Table II by construction and leaving Table I as a genuine
prediction of the model.
"""

from __future__ import annotations

import json
import math
import pathlib
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.models.graph import LayerSpec, ModelGraph

# --- edge-node hardware model ----------------------------------------------

#: cost-units processed per millisecond per 1.0 CPU. Calibrated (see module
#: docstring): the average 3-way MobileNetV2 partition (44,049,952 / 3 =
#: 14,683,317 cost units) takes 234.56 ms on a 1.0-CPU node (Table II),
#: net of the fixed per-inference overhead.
BASE_THROUGHPUT = 14_683_317.33 / (234.56 - 2.0)  # ~63,138 cost-units/ms/cpu

#: memory-pressure exponent: working sets above the node's memory limit slow
#: execution superlinearly (swap/thrash) — the paper's own observation that
#: "reduced memory had a more significant impact ... than CPU".
MEM_PRESSURE_ALPHA = 1.5

#: fixed per-inference overhead (interpreter, dispatch), ms
FIXED_OVERHEAD_MS = 2.0


@dataclass(frozen=True)
class NodeProfile:
    """Provisioned resources of one edge device (the paper's cgroup
    limits plus bridge-network link parameters)."""
    cpu: float           # CPU fraction (1.0 == one core)
    mem_mb: float
    net_latency_ms: float = 1.0
    net_bw_mbps: float = 800.0    # bridge-network bandwidth

    @property
    def mem_bytes(self) -> float:
        """Memory limit in bytes."""
        return self.mem_mb * 1024 * 1024


# paper resource profiles (§IV-A)
PROFILES = {
    "high": NodeProfile(cpu=1.0, mem_mb=1024),
    "medium": NodeProfile(cpu=0.6, mem_mb=512),
    "low": NodeProfile(cpu=0.4, mem_mb=512),
    "monolithic": NodeProfile(cpu=2.0, mem_mb=2048),
}


def execution_ms(cost: float, profile: NodeProfile, working_set_bytes: float = 0.0,
                 *, threads: float = 1.0) -> float:
    """Simulated execution time of ``cost`` units on a node.

    ``threads``: effective parallelism of the runtime on this node (the
    paper's PyTorch inference is effectively single-threaded per request, so
    callers use min(cpu, 1.0) unless modeling batch-parallel runtimes).
    """
    eff_cpu = min(profile.cpu, threads)
    t = cost / (BASE_THROUGHPUT * eff_cpu) + FIXED_OVERHEAD_MS
    if working_set_bytes > profile.mem_bytes:
        t *= (working_set_bytes / profile.mem_bytes) ** MEM_PRESSURE_ALPHA
    return t


def transfer_ms(num_bytes: float, profile: NodeProfile) -> float:
    """Network transfer time for a partition boundary activation."""
    if num_bytes <= 0:
        return 0.0
    return profile.net_latency_ms + num_bytes * 8.0 / (profile.net_bw_mbps * 1e3)


def link_rate_bits_per_ms(profile: NodeProfile) -> float:
    """Link drain rate in bits per millisecond — the denominator of
    :func:`transfer_ms`'s bandwidth term, exposed as the capacity the
    shared fabric (``core.fabric``) divides among concurrent flows. Using
    the identical expression keeps the fluid model's solo-flow progress
    consistent with the isolated per-message charge."""
    return profile.net_bw_mbps * 1e3


# --- cached / vectorized entry points (the engine's hot-path mirrors) --------

@lru_cache(maxsize=65536)
def execution_ms_cached(cost: float, profile: NodeProfile,
                        working_set_bytes: float = 0.0,
                        threads: float = 1.0) -> float:
    """Memoized :func:`execution_ms` (``NodeProfile`` is frozen, hence
    hashable). The pipeline engine's per-plan ``StageTable`` is rebuilt on
    every re-deploy / migration / profile change; identical (cost, profile,
    working-set) keys recur constantly across rebuilds, so this keeps table
    construction O(1) per stage after the first run. Delegates to the scalar
    model, so the cached and uncached paths cannot drift apart."""
    return execution_ms(cost, profile, working_set_bytes, threads=threads)


@lru_cache(maxsize=65536)
def transfer_ms_cached(num_bytes: float, profile: NodeProfile) -> float:
    """Memoized :func:`transfer_ms` — same rationale (and same exact float
    result) as :func:`execution_ms_cached`, for boundary transfers."""
    return transfer_ms(num_bytes, profile)


def execution_ms_vec(costs, profile: NodeProfile, working_sets=0.0,
                     threads: float = 1.0):
    """Vectorized :func:`execution_ms` over arrays of (cost, working-set)
    pairs for one node profile; returns an ``np.ndarray`` of stage times.

    The element-wise math mirrors the scalar model term for term (CPU share,
    fixed per-inference overhead, superlinear memory pressure);
    ``tests/test_engine.py`` pins it element-wise against the scalar model
    so the two cannot drift. Used by ``benchmarks/pipeline_bench.py`` to
    sweep the analytic micro-batch amortization curve without a Python loop.
    """
    costs = np.asarray(costs, dtype=np.float64)
    ws = np.broadcast_to(np.asarray(working_sets, dtype=np.float64),
                         costs.shape)
    eff_cpu = min(profile.cpu, threads)
    t = costs / (BASE_THROUGHPUT * eff_cpu) + FIXED_OVERHEAD_MS
    over = ws > profile.mem_bytes
    if over.any():
        pressure = np.where(over, ws / profile.mem_bytes, 1.0)
        t = t * pressure ** MEM_PRESSURE_ALPHA
    return t


def partition_cost(graph: ModelGraph, lo: int, hi: int) -> float:
    """Raw (uncalibrated) cost of layers ``[lo, hi)``."""
    return sum(l.cost for l in graph.layers[lo:hi])


def partition_params_bytes(graph: ModelGraph, lo: int, hi: int, dtype_bytes: int = 4) -> int:
    """Parameter bytes of layers ``[lo, hi)`` at ``dtype_bytes`` per
    weight."""
    return dtype_bytes * sum(l.params for l in graph.layers[lo:hi])


def boundary_bytes(graph: ModelGraph, cut: int) -> int:
    """Activation bytes crossing the boundary *before* layer ``cut``."""
    if cut <= 0 or cut >= len(graph.layers):
        return 0
    return graph.layers[cut - 1].out_bytes + graph.layers[cut - 1].state_bytes


def working_set_bytes(graph: ModelGraph, lo: int, hi: int, batch: int = 1) -> float:
    """Params + peak activation for a partition (memory-pressure input).

    The peak counts each layer's activation *and* its recurrent/KV state
    (``state_bytes``): a resident SSD/RG-LRU scan state occupies memory at
    execution time exactly like the activation does, and ``boundary_bytes``
    already charges it at the wire — dropping it here made recurrent stages
    underestimate memory pressure.
    """
    params = partition_params_bytes(graph, lo, hi)
    peak_act = max((l.out_bytes + l.state_bytes for l in graph.layers[lo:hi]),
                   default=0)
    return params + batch * peak_act


# --- batch-aware cost model (calibrated exec_for(k) curves) ------------------

#: default artifact path (repo-relative) for kernel-calibrated batch curves;
#: written by ``scripts/calibrate_costmodel_torch.py`` from the Hopper
#: kernels on the card, loaded explicitly via
#: :meth:`BatchCostModel.from_artifact` — never implicitly, so the analytic
#: default stays bit-for-bit reproducible
CALIBRATION_ARTIFACT = pathlib.Path("artifacts/calibration/batch_curves_h100.json")


@dataclass(frozen=True)
class KindCurve:
    """Batch-scaling curve of one layer class: ``exec(k) = per_item * k *
    per_item_scale * tail + overhead_ms`` (then memory pressure at the
    k-scaled working set).

    ``overhead_ms``: the fixed per-execution overhead a k-batch amortizes
    (the analytic model's :data:`FIXED_OVERHEAD_MS`). ``per_item_scale``:
    relative per-item throughput of this kind vs. the fleet anchor (> 1 =
    this kind runs hotter than the paper-calibrated base throughput).
    ``knee_k`` / ``tail_scale``: past ``knee_k`` coalesced items the kernel
    leaves the overhead-amortizing regime and goes bandwidth-bound — per-item
    time is multiplied by ``tail_scale`` (>= 1). ``knee_k = 0`` disables the
    tail."""
    overhead_ms: float = FIXED_OVERHEAD_MS
    per_item_scale: float = 1.0
    knee_k: float = 0.0
    tail_scale: float = 1.0

    def tail_factor(self, k: int) -> float:
        """Bandwidth-tail multiplier on per-item time at batch ``k``."""
        return self.tail_scale if self.knee_k and k > self.knee_k else 1.0


#: the analytic fallback curve — exactly the scalar cost model's terms
ANALYTIC_CURVE = KindCurve()


class BatchCostModel:
    """Batch-aware stage cost interface shared by the engine's
    ``StageEntry.exec_for/xfer_for``, the planner's batch-aware bottleneck
    objective, tenancy budgets, and adaptation gain predictions.

    Without calibration curves (``is_analytic``) every method reduces to
    the scalar cost model with k-scaled cost/bytes — the engine's original
    micro-batch semantics, preserved bit-for-bit (callers keep their
    literal k=1 expressions on the analytic path). With per-kind
    :class:`KindCurve` entries (fit from kernel
    microbenchmarks by ``scripts/calibrate_costmodel_torch.py``), execution
    curves gain measured overhead knees and bandwidth-bound tails while
    the absolute throughput anchor stays the paper's Table-II calibration.
    """

    def __init__(self, curves: Optional[Dict[str, KindCurve]] = None,
                 source: str = "analytic"):
        self.curves: Dict[str, KindCurve] = dict(curves or {})
        self.source = source

    @property
    def is_analytic(self) -> bool:
        """True when no calibration artifact is loaded — the scalar-model
        fallback whose results are pinned bit-for-bit by the parity
        tests."""
        return not self.curves

    def curve_for(self, kind: str) -> KindCurve:
        """The calibration curve of one layer class; the artifact's
        ``default`` entry (or the analytic curve) for unknown kinds."""
        c = self.curves.get(kind)
        if c is None:
            c = self.curves.get("default", ANALYTIC_CURVE)
        return c

    def partition_curve(self, graph: ModelGraph, lo: int,
                        hi: int) -> KindCurve:
        """Cost-weighted blend of the per-kind curves over layers
        ``[lo, hi)`` — one effective curve per pipeline stage. Zero-cost
        ranges fall back to the analytic curve."""
        if self.is_analytic:
            return ANALYTIC_CURVE
        tot = o = s = kn = tl = 0.0
        for l in graph.layers[lo:hi]:
            w = l.cost
            if w <= 0:
                continue
            c = self.curve_for(l.kind)
            tot += w
            o += w * c.overhead_ms
            s += w * c.per_item_scale
            kn += w * c.knee_k
            tl += w * c.tail_scale
        if tot <= 0:
            return ANALYTIC_CURVE
        return KindCurve(o / tot, s / tot, kn / tot, tl / tot)

    def exec_ms(self, cost: float, profile: NodeProfile,
                working_set: float = 0.0, k: int = 1,
                curve: Optional[KindCurve] = None,
                threads: float = 1.0) -> float:
        """Execution time of a k-item micro-batch of ``cost`` per-item
        units: k× the compute, one (curve-calibrated) fixed overhead,
        memory pressure at the caller's (k-scaled) working set. The
        analytic path is exactly ``execution_ms(cost * k, ...)``."""
        if curve is None or curve is ANALYTIC_CURVE:
            return execution_ms(cost * k, profile, working_set,
                                threads=threads)
        eff_cpu = min(profile.cpu, threads)
        per_item = (cost / (BASE_THROUGHPUT * eff_cpu)
                    * curve.per_item_scale * curve.tail_factor(k))
        t = per_item * k + curve.overhead_ms
        if working_set > profile.mem_bytes:
            t *= (working_set / profile.mem_bytes) ** MEM_PRESSURE_ALPHA
        return t

    def xfer_ms(self, num_bytes: float, profile: NodeProfile,
                k: int = 1) -> float:
        """Transfer time of a k-request coalesced boundary message: one
        per-message latency, k× the payload bytes."""
        return transfer_ms(num_bytes * k, profile)

    def amortized_stage_ms(self, cost: float, working_set: float,
                           in_bytes: float, profile: NodeProfile,
                           k: int = 1,
                           curve: Optional[KindCurve] = None) -> float:
        """Per-request steady-state stage period at operating micro-batch
        ``k``: (batched execution + one coalesced incoming transfer) / k —
        the batch-aware term the planner's bottleneck objective maximizes
        over nodes. ``working_set`` must already be k-scaled; ``in_bytes``
        is the per-request boundary payload (0 for the first stage)."""
        t = self.exec_ms(cost, profile, working_set, k, curve)
        if in_bytes > 0:
            t += transfer_ms(in_bytes * k, profile)
        return t / k if k != 1 else t

    # --- artifact persistence ------------------------------------------------

    @classmethod
    def from_artifact(cls, path: Union[str, pathlib.Path, None] = None
                      ) -> "BatchCostModel":
        """Load a calibration artifact (``scripts/calibrate_costmodel_torch.py``
        output). A missing or unreadable artifact returns the analytic
        fallback model instead of raising — calibration is an overlay, not
        a dependency."""
        p = pathlib.Path(path) if path is not None else CALIBRATION_ARTIFACT
        try:
            raw = json.loads(p.read_text())
            curves = {kind: KindCurve(
                overhead_ms=float(c["overhead_ms"]),
                per_item_scale=float(c["per_item_scale"]),
                knee_k=float(c.get("knee_k", 0.0)),
                tail_scale=float(c.get("tail_scale", 1.0)))
                for kind, c in raw["curves"].items()}
        except (OSError, ValueError, KeyError, TypeError):
            return cls(source="analytic-fallback")
        return cls(curves, source=str(raw.get("source", p)))

    def to_artifact_dict(self) -> dict:
        """JSON-serializable artifact body (round-trips through
        :meth:`from_artifact`)."""
        return dict(
            version=1, source=self.source,
            curves={kind: dict(overhead_ms=c.overhead_ms,
                               per_item_scale=c.per_item_scale,
                               knee_k=c.knee_k, tail_scale=c.tail_scale)
                    for kind, c in self.curves.items()})


#: the shared analytic model instance — every batch-aware call site
#: defaults to this, so "no artifact" means one object identity, not
#: scattered None checks
ANALYTIC_BATCH_MODEL = BatchCostModel()


# --- H100 adaptation ---------------------------------------------------------

# NVIDIA H100 SXM published peaks (per card; NVIDIA's data sheet, dense rates,
# at the 700 W power limit), used for stage costing and roofline bounds.
GPU_PEAK_FLOPS = 989e12          # bf16 tensor cores, dense
GPU_HBM_BW = 3.35e12             # bytes/s
GPU_LINK_BW = 450e9              # bytes/s, NVLink each way per card


def gpu_stage_ms(flops: float, chips: int) -> float:
    """Compute-roofline stage time on ``chips`` H100 cards."""
    return flops / (GPU_PEAK_FLOPS * chips) * 1e3


def gpu_boundary_ms(num_bytes: float) -> float:
    """NVLink transfer time for a stage-boundary activation."""
    return num_bytes / GPU_LINK_BW * 1e3
