"""Model Partitioner (paper §III-B).

B1 Layer Analysis  -> per-layer type/params/cost attributes (ModelGraph)
B2 Cost Estimation -> Eq. 1/2/9 costs (models/graph.py) with optional
                      history recalibration from observed execution times
B3 Partition Boundaries -> greedy cumulative-cost split (Eq. 3): layers are
                      added until the running cost meets/exceeds the target,
                      then a new partition starts; remaining layers join the
                      final partition. Reproduces the paper's MobileNetV2
                      splits exactly: [116, 25] (2-way), [108, 16, 17] (3-way).
B4 Distributed Model -> ``Partition`` records (layer range + boundary bytes),
                      executable via models/mobilenetv2.run_range or the
                      transformer stage executor.

Beyond the paper (recorded in EXPERIMENTS.md §Perf): capability-weighted
targets (`weights=`) and a balance-refinement pass that shrinks the max
stage time — the paper's uniform Eq. 3 targets leave the bottleneck stage
~17% above the mean on heterogeneous nodes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import (boundary_bytes, partition_cost,
                                   partition_params_bytes, working_set_bytes)
from repro_torch.models.graph import ModelGraph


def bottleneck_boundaries(layer_costs: Sequence[float], num_partitions: int,
                          weights: Optional[Sequence[float]] = None,
                          iters: int = 60) -> Optional[List[int]]:
    """Contiguous cuts minimizing the bottleneck stage *time* (beyond-paper):
    binary search on the bottleneck T with a greedy feasibility walk;
    partition i must satisfy cost_i <= T * weights[i]. Degenerate trailing
    stages are filled as empty ``[L, L]`` ranges. Returns None only if no
    feasible split was found (the upper bound makes this unreachable for
    positive weights). Shared by ``ModelPartitioner.optimal_boundaries``
    and the planner's candidate-order seeding."""
    costs = list(layer_costs)
    n = num_partitions
    w = list(weights) if weights is not None else [1.0] * n

    def feasible(T: float) -> Optional[List[int]]:
        cuts = [0]
        cum = 0.0
        pi = 0
        for i, c in enumerate(costs):
            if cum + c > T * w[pi] + 1e-9:
                if cum == 0.0:      # single layer exceeds budget
                    return None
                cuts.append(i)
                pi += 1
                cum = c
                if pi >= n:
                    return None
            else:
                cum += c
        cuts.append(len(costs))
        while len(cuts) < n + 1:
            cuts.insert(-1, len(costs))
        return cuts

    lo = max(costs) / max(w)
    hi = sum(costs) / min(w) + 1.0
    best = None
    for _ in range(iters):
        mid = (lo + hi) / 2
        cand = feasible(mid)
        if cand is not None:
            best, hi = cand, mid
        else:
            lo = mid
    return best


@dataclass(frozen=True)
class StageDag:
    """Stage-level dataflow derived from the layer DAG for one cut list.

    Stages remain contiguous ranges of the topologically-ordered layer
    list; the layer edges induce stage edges (coalesced per stage pair,
    bytes summed), join fan-in counts, per-stage early-exit heads, and
    per-stage reach probabilities. ``None`` on a :class:`PartitionPlan`
    means the graph is a chain and the original FIFO stage pipeline
    applies bit-for-bit."""
    #: per stage: ``((succ_stage, bytes), ...)`` sorted by successor id
    succs: Tuple[Tuple[Tuple[int, int], ...], ...]
    #: per stage: number of distinct predecessor stages (>1 == join)
    pred_counts: Tuple[int, ...]
    #: per stage: ``((exit_layer_id, exit_prob), ...)`` for exit heads
    #: contained in the stage (the request draws its exit when the stage
    #: completes)
    exit_heads: Tuple[Tuple[Tuple[int, float], ...], ...]
    #: per stage: probability a request still executes the stage (product
    #: of ``1 - exit_prob`` over exit heads in strictly earlier layers)
    reach: Tuple[float, ...]


def build_stage_dag(graph: ModelGraph, cuts: Sequence[int]) -> StageDag:
    """Derive the :class:`StageDag` for ``cuts`` over a validated operator
    DAG. Cuts must be strictly increasing (no degenerate empty stages —
    an empty stage has no layer edges and would be unreachable)."""
    graph.validate_dag()
    assert all(cuts[i] < cuts[i + 1] for i in range(len(cuts) - 1)), (
        f"DAG plans forbid empty stages: {cuts}")
    m = len(cuts) - 1
    stage_of: List[int] = []
    for i in range(m):
        stage_of += [i] * (cuts[i + 1] - cuts[i])
    edge_bytes: dict = {}
    for u, v in graph.layer_edges():
        su, sv = stage_of[u], stage_of[v]
        if su == sv:
            continue
        b = graph.layers[u].out_bytes + graph.layers[u].state_bytes
        edge_bytes[(su, sv)] = edge_bytes.get((su, sv), 0) + b
    succs: List[List[Tuple[int, int]]] = [[] for _ in range(m)]
    pred_counts = [0] * m
    for (su, sv), b in sorted(edge_bytes.items()):
        succs[su].append((sv, b))
        pred_counts[sv] += 1
    exit_heads: List[List[Tuple[int, float]]] = [[] for _ in range(m)]
    for e, l in enumerate(graph.layers):
        if l.exit_prob > 0.0:
            exit_heads[stage_of[e]].append((e, l.exit_prob))
    reach_l = graph.reach_probs()
    return StageDag(
        succs=tuple(tuple(s) for s in succs),
        pred_counts=tuple(pred_counts),
        exit_heads=tuple(tuple(h) for h in exit_heads),
        reach=tuple(reach_l[cuts[i]] for i in range(m)),
    )


@dataclass(frozen=True)
class Partition:
    """One deployable stage: the contiguous layer range ``[lo, hi)`` plus
    its cost, parameter bytes, and boundary activation sizes (paper B4)."""
    index: int
    lo: int                      # first layer (inclusive)
    hi: int                      # last layer (exclusive)
    cost: float
    params_bytes: int
    in_bytes: int                # activation bytes entering this partition
    out_bytes: int               # activation bytes leaving this partition

    @property
    def num_layers(self) -> int:
        """Number of layers in this partition."""
        return self.hi - self.lo


@dataclass
class PartitionPlan:
    """An ordered list of contiguous ``Partition`` stages covering the
    whole model graph."""
    graph_name: str
    partitions: List[Partition]
    #: stage-level dataflow for operator-DAG graphs; None == chain plan
    stage_dag: Optional[StageDag] = None

    @property
    def sizes(self) -> List[int]:
        """Per-stage layer counts (the paper reports plans in this form)."""
        return [p.num_layers for p in self.partitions]

    @property
    def costs(self) -> List[float]:
        """Per-stage computation costs (calibrated Eq. 1/2/9 units)."""
        return [p.cost for p in self.partitions]

    @property
    def comm_bytes(self) -> int:
        """Total activation bytes crossing stage boundaries per request."""
        return sum(p.out_bytes for p in self.partitions[:-1])

    @property
    def imbalance(self) -> float:
        """Max stage cost over mean stage cost (1.0 = perfectly balanced)."""
        c = self.costs
        mean = sum(c) / len(c)
        return max(c) / mean if mean else 1.0


class ModelPartitioner:
    """Paper §III-B: layer analysis, cost estimation (with historical
    recalibration), boundary search, and ``PartitionPlan`` construction
    for one ``ModelGraph``."""

    def __init__(self, graph: ModelGraph):
        self.graph = graph
        self._calibration = 1.0
        self._ws_cache: dict = {}     # (lo, hi, batch) -> working-set bytes

    # --- B1/B2 --------------------------------------------------------------

    def analyze(self) -> List[dict]:
        """Layer analysis report (paper B1)."""
        return [
            dict(name=l.name, kind=l.kind, params=l.params, cost=l.cost,
                 out_bytes=l.out_bytes)
            for l in self.graph.layers
        ]

    def recalibrate(self, observed_ms: float, predicted_ms: float) -> None:
        """Blend observed/predicted execution time into the cost scale
        (the paper's 'historical performance data' feedback into B2)."""
        if predicted_ms > 0:
            ratio = observed_ms / predicted_ms
            self._calibration = 0.8 * self._calibration + 0.2 * ratio

    @property
    def calibration(self) -> float:
        """Current observed/predicted execution-time blend (1.0 = the
        a-priori cost model)."""
        return self._calibration

    def calibration_drift(self, reference: float = 1.0) -> float:
        """Relative miscalibration vs. the scale the current plan was built
        with; the Adaptation Controller re-plans beyond a configurable band."""
        return abs(self._calibration - reference) / max(reference, 1e-9)

    def reset_calibration(self) -> None:
        """Forget observed history; back to the a-priori cost model."""
        self._calibration = 1.0

    # --- B3 -----------------------------------------------------------------

    def boundaries(self, num_partitions: int,
                   weights: Optional[Sequence[float]] = None) -> List[int]:
        """Greedy cumulative-cost boundaries (Eq. 3).

        ``weights``: optional per-partition capability weights (beyond-paper);
        None reproduces the paper's uniform targets exactly.
        """
        costs = [l.cost for l in self.graph.layers]
        total = sum(costs)
        n = num_partitions
        assert 1 <= n <= len(costs)
        if weights is None:
            targets = [total / n] * n
        else:
            assert len(weights) == n
            wsum = sum(weights)
            targets = [total * w / wsum for w in weights]

        cuts = [0]
        cum = 0.0
        pi = 0
        for i, c in enumerate(costs):
            cum += c
            if pi < n - 1 and cum >= targets[pi]:
                cuts.append(i + 1)
                cum = 0.0
                pi += 1
        while len(cuts) < n:
            cuts.append(len(costs))       # degenerate: empty tail partitions
        cuts.append(len(costs))
        return cuts

    def refine(self, cuts: List[int], weights: Optional[Sequence[float]] = None,
               iters: int = 200) -> List[int]:
        """Bottleneck-reduction pass (beyond-paper): move single layers across
        the boundaries of the max-*time* partition while it helps.

        With ``weights`` (node capabilities), partition i's time proxy is
        cost_i / weights[i]; without, uniform capability is assumed.
        """
        cuts = list(cuts)
        costs = [l.cost for l in self.graph.layers]
        n = len(cuts) - 1
        w = list(weights) if weights is not None else [1.0] * n
        assert len(w) == n

        def ptime(i, extra=0.0):
            return (sum(costs[cuts[i]:cuts[i + 1]]) + extra) / w[i]

        for _ in range(iters):
            pt = [ptime(i) for i in range(n)]
            worst = max(range(n), key=lambda i: pt[i])
            best_move = None
            # shrink the worst partition from either side
            if worst > 0 and cuts[worst + 1] - cuts[worst] > 1:
                c = costs[cuts[worst]]
                new_max = max(pt[worst] - c / w[worst], ptime(worst - 1, c))
                if new_max < pt[worst]:
                    best_move = ("left", new_max)
            if worst < n - 1 and cuts[worst + 1] - cuts[worst] > 1:
                c = costs[cuts[worst + 1] - 1]
                new_max = max(pt[worst] - c / w[worst], ptime(worst + 1, c))
                if new_max < pt[worst] and (best_move is None or new_max < best_move[1]):
                    best_move = ("right", new_max)
            if best_move is None:
                break
            if best_move[0] == "left":
                cuts[worst] += 1
            else:
                cuts[worst + 1] -= 1
        return cuts

    def optimal_boundaries(self, num_partitions: int,
                           weights: Optional[Sequence[float]] = None) -> List[int]:
        """Minimize the bottleneck stage *time* over contiguous partitions
        (beyond-paper) via the shared :func:`bottleneck_boundaries` search.
        """
        best = bottleneck_boundaries([l.cost for l in self.graph.layers],
                                     num_partitions, weights)
        assert best is not None
        return best

    # --- B4 -----------------------------------------------------------------

    def plan(self, num_partitions: int, weights: Optional[Sequence[float]] = None,
             refine: bool = False, method: str = "greedy") -> PartitionPlan:
        """Build a ``PartitionPlan`` with ``num_partitions`` contiguous stages.

        Args:
            num_partitions: stage count (1 <= n <= number of layers).
            weights: optional per-stage capability weights; None keeps the
                paper's uniform Eq. 3 targets.
            refine: apply the bottleneck-reduction pass (greedy method only).
            method: ``greedy`` (paper Eq. 3 cumulative split) or ``optimal``
                (binary-search bottleneck minimization). For the joint
                boundary+assignment search over a live cluster use
                ``core.planner.PartitionPlanner`` and :meth:`plan_from_cuts`.
        """
        if method == "optimal":
            cuts = self.optimal_boundaries(num_partitions, weights)
        else:
            cuts = self.boundaries(num_partitions, weights)
            if refine:
                cuts = self.refine(cuts, weights)
        return self.plan_from_cuts(cuts)

    def plan_from_cuts(self, cuts: Sequence[int]) -> PartitionPlan:
        """Materialize ``Partition`` records for an explicit cut list
        (``[0, ..., num_layers]``) — the handoff point from the planner's DP
        search, which chooses cuts jointly with the node assignment. Costs
        are scaled by the current calibration, as in :meth:`plan`."""
        assert cuts[0] == 0 and cuts[-1] == len(self.graph.layers), cuts
        parts = []
        if self.graph.is_chain:
            for i in range(len(cuts) - 1):
                lo, hi = cuts[i], cuts[i + 1]
                parts.append(Partition(
                    index=i, lo=lo, hi=hi,
                    cost=partition_cost(self.graph, lo, hi) * self._calibration,
                    params_bytes=partition_params_bytes(self.graph, lo, hi),
                    in_bytes=boundary_bytes(self.graph, lo),
                    out_bytes=boundary_bytes(self.graph, hi),
                ))
            return PartitionPlan(self.graph.name, parts)
        # operator DAG: boundary bytes are the summed layer edges crossing
        # each stage boundary (a chain's single crossing edge degenerates
        # to boundary_bytes above)
        dag = build_stage_dag(self.graph, cuts)
        in_b = [0] * (len(cuts) - 1)
        out_b = [0] * (len(cuts) - 1)
        for si, edges in enumerate(dag.succs):
            for sj, b in edges:
                out_b[si] += b
                in_b[sj] += b
        for i in range(len(cuts) - 1):
            lo, hi = cuts[i], cuts[i + 1]
            parts.append(Partition(
                index=i, lo=lo, hi=hi,
                cost=partition_cost(self.graph, lo, hi) * self._calibration,
                params_bytes=partition_params_bytes(self.graph, lo, hi),
                in_bytes=in_b[i], out_bytes=out_b[i],
            ))
        return PartitionPlan(self.graph.name, parts, stage_dag=dag)

    def working_set(self, part: Partition, batch: int = 1) -> float:
        """Params + peak activation bytes for one partition at ``batch`` —
        the memory-pressure input to ``cost_model.execution_ms``. Memoized
        per (layer range, batch): the graph is immutable, so the O(layers)
        scan runs once per distinct partition instead of once per request
        (the seed re-derived it on every request × stage)."""
        key = (part.lo, part.hi, batch)
        ws = self._ws_cache.get(key)
        if ws is None:
            ws = working_set_bytes(self.graph, part.lo, part.hi, batch)
            self._ws_cache[key] = ws
        return ws
