"""Scalable joint boundary + stage->node assignment planner.

PR 1's ``AdaptationController`` solved the joint problem by scoring every
node permutation, which caps out around n = 5 nodes (n! plans). This module
replaces that with the dynamic-programming formulation used by the edge-
cluster partitioning literature (Parthasarathy & Krishnamachari,
*Partitioning and Deployment of DNNs on Edge Clusters*; *SEIFER*), so the
closed loop scales to the 20-50+ node regime.

**Objective.** A candidate is (cuts, assignment): contiguous layer ranges
(stages) and one node per stage. The planner minimizes the steady-state
pipeline period — the bottleneck node's serialized time per request::

    stage_ms(a, b, v)  = transfer_in(boundary_bytes(a), v) + execution_ms(.)
    bottleneck         = max over nodes of sum of that node's stage_ms

Execution uses the real ``cost_model`` terms (CPU share, fixed overhead,
memory-pressure superlinearity); the transfer term charges each stage's
incoming activation to the *receiving* node's link (latency + bandwidth from
``NodeProfile``), so heavy boundaries avoid slow links.

**DP.** For a fixed node *order* v_1..v_k, let ``dp[j][l]`` be the best
bottleneck covering layers ``[0, l)`` with stages assigned to an increasing
subsequence of v_1..v_j (each node hosts at most one stage)::

    dp[j][l] = min( dp[j-1][l],                                # skip v_j
                    min over a < l of max(dp[j-1][a], t_j[a][l]) )

This is exact *for that order* and runs in O(layers^2 * nodes) — each node
step is one vectorized (L+1)x(L+1) max/min reduction. Free-order optimality
is recovered by searching a small set of candidate orders (capability-sorted
both ways plus, for every stage count m, the order induced by sorted-
matching a balanced m-way split's stage costs to the m most capable nodes),
then iterating DP <-> rematch to a fixed point and polishing with pairwise
assignment swaps. ``mode="exhaustive"`` runs the same recurrence over *all*
node orders — exact, feasible only for n <= ~5, and kept as the parity
oracle for the tests.

**Non-contiguous placement.** The DP gives each node at most one
contiguous stage. When one node is far faster than the rest it can pay to
give it several *non-contiguous* stages (e.g. both heavy ends of the
model). ``mode="assign"`` solves this as min-max (stage, node) assignment
— balanced cut candidates, longest-processing-time-first list scheduling
onto per-node stage times, single-stage-move polish — seeded with the DP's
contiguous optimum, so it never returns a worse plan than the DP. It
replaces the older ``mode="beam"`` width-bounded search (kept as a
comparison oracle) as the non-contiguous fallback.

**Tenancy.** Every search accepts per-node *committed time budgets*
(``committed_ms`` — ms/request already charged to a node by other
tenants' resident stages) and a tenant traffic ``weight``: a node's
bottleneck contribution is its committed load plus its new stages, so
plans route around co-resident models. :func:`plan_tenants` iterates the
per-tenant search Gauss-Seidel style into a joint multi-tenant plan, and
:meth:`PartitionPlanner.plan_partial` solves the bounded-migration
variant — keep the cuts, move at most k stages — whose transfer cost is
only the moved stages' parameters (the Adaptation Controller's cheap
candidate).
"""

from __future__ import annotations

import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import (ANALYTIC_BATCH_MODEL, BASE_THROUGHPUT,
                                   FIXED_OVERHEAD_MS, MEM_PRESSURE_ALPHA,
                                   BatchCostModel, NodeProfile, execution_ms,
                                   partition_cost, transfer_ms,
                                   working_set_bytes)
from repro_torch.core.partitioner import bottleneck_boundaries
from repro_torch.models.graph import ModelGraph

_EPS = 1e-9


@dataclass(frozen=True)
class NodeView:
    """What the planner needs to know about one node.

    ``profile`` drives the timing model (the node's provisioned resources);
    ``capability`` is the live scalar score (``NodeStats.capability``) used
    to order and select nodes — a throttled or unstable node is deprioritized
    even though its provisioned profile is unchanged.
    """
    node_id: str
    profile: NodeProfile
    capability: float


def node_views_from_stats(stats, cluster, scheduler=None) -> List[NodeView]:
    """Planner inputs from live monitor snapshots (mid-run re-planning).

    Offline / zero-capability nodes are dropped. With a ``scheduler``, each
    capability is scaled by ``TaskScheduler.perf_weight`` so nodes whose
    observed execution times run hot against the fleet are deprioritized
    (the paper's historical-performance signal, S_P, reaching the planner).
    """
    views = []
    for nid, s in stats.items():
        if not s.online or s.capability <= 0.0 or nid not in cluster.nodes:
            continue
        cap = s.capability
        if scheduler is not None:
            cap *= scheduler.perf_weight(nid)
        views.append(NodeView(nid, cluster.nodes[nid].profile, cap))
    return views


def node_views_from_cluster(cluster, scheduler=None) -> List[NodeView]:
    """Planner inputs from provisioned profiles (initial deployment: no
    telemetry yet, so capability defaults to the node's CPU share)."""
    views = []
    for node in cluster.online_nodes():
        cap = node.profile.cpu
        if scheduler is not None:
            cap *= scheduler.perf_weight(node.node_id)
        views.append(NodeView(node.node_id, node.profile, cap))
    return views


@dataclass
class PlannerConfig:
    """Search knobs for :class:`PartitionPlanner`.

    ``mode``: ``auto`` (exhaustive when n <= ``exhaustive_max_nodes``, DP
    otherwise), ``dp``, ``assign`` (non-contiguous min-max assignment,
    DP-seeded), ``beam`` (legacy non-contiguous search), or
    ``exhaustive``.
    """
    mode: str = "auto"
    exhaustive_max_nodes: int = 5     # n! orders stays tractable up to here
    rematch_iters: int = 6            # DP <-> sorted-rematch fixed point
    local_swap_iters: int = 12        # pairwise-swap polish rounds
    beam_width: int = 16
    max_stages: Optional[int] = None  # cap on stage count (None: min(n, L))


@dataclass
class PlanResult:
    """A solved joint plan: cut list, per-stage node ids, and the predicted
    bottleneck under the planner's objective. ``mode`` records which search
    produced it; ``dp_runs`` counts (order, DP) solves spent;
    ``moved_stages`` (partial mode) counts stage re-assignments vs. the
    plan the search started from."""
    cuts: List[int]
    assignment: List[str]
    bottleneck_ms: float
    mode: str
    dp_runs: int = 0
    elapsed_ms: float = 0.0
    node_idx: List[int] = field(default_factory=list)   # internal indices
    moved_stages: int = 0

    @property
    def stages(self) -> int:
        """Number of pipeline stages in the plan."""
        return len(self.cuts) - 1


# --- full-plan evaluator (shared with the AdaptationController) --------------

def _stage_ms(cost: float, ws: float, in_bytes: float,
              profile: NodeProfile) -> float:
    """One stage's period on one node: ``cost_model.execution_ms``
    (single-threaded runtime, fixed overhead, memory-pressure
    superlinearity) plus the incoming boundary transfer on this node's
    link. ``_time_matrix`` is the vectorized mirror of this."""
    return execution_ms(cost, profile, ws) + transfer_ms(in_bytes, profile)


def bottleneck_ms(graph: ModelGraph, partitions, assignment: Dict[int, str],
                  cluster, batch: int = 1, calibration: float = 1.0,
                  speedup: float = 1.0, expected_k: int = 1,
                  batch_model: Optional[BatchCostModel] = None) -> float:
    """Steady-state period of an arbitrary (partitions, placement) pair:
    max over nodes of that node's serialized stage time, each stage charged
    its execution plus its incoming boundary transfer.

    Stage costs are recomputed from the graph at the *current* calibration
    (not the plan-time scale baked into ``Partition.cost``) so current and
    candidate plans are always compared apples-to-apples. Any offline
    placement node makes the plan unservable (``inf``). This is the single
    objective the planner optimizes and the controller decides with.

    ``expected_k``: the operating micro-batch the engine coalesces at —
    stages are charged their *per-request amortized* batched time
    (``BatchCostModel.amortized_stage_ms``: k× compute + one overhead +
    one coalesced transfer, all over k, with memory pressure at the
    k-scaled working set). ``expected_k=1`` with the analytic model (no
    calibration artifact) reproduces the original k=1 objective
    bit-for-bit.
    """
    scale = calibration * batch / speedup
    model = batch_model if batch_model is not None else ANALYTIC_BATCH_MODEL
    k = max(int(expected_k), 1)
    plain = k == 1 and model.is_analytic
    if not graph.is_chain:
        return _dag_bottleneck_ms(graph, partitions, assignment, cluster,
                                  scale, batch, model, k, plain)
    per_node: Dict[str, float] = {}
    for part in partitions:
        node = cluster.nodes[assignment[part.index]]
        if not node.online:
            return math.inf
        if plain:
            t = _stage_ms(partition_cost(graph, part.lo, part.hi) * scale,
                          working_set_bytes(graph, part.lo, part.hi, batch),
                          part.in_bytes * batch if part.lo > 0 else 0.0,
                          node.profile)
        else:
            t = model.amortized_stage_ms(
                partition_cost(graph, part.lo, part.hi) * scale,
                working_set_bytes(graph, part.lo, part.hi, batch * k),
                part.in_bytes * batch if part.lo > 0 else 0.0,
                node.profile, k,
                model.partition_curve(graph, part.lo, part.hi))
        per_node[node.node_id] = per_node.get(node.node_id, 0.0) + t
    return max(per_node.values()) if per_node else math.inf


def _dag_bottleneck_ms(graph: ModelGraph, partitions, assignment, cluster,
                       scale: float, batch: int, model: BatchCostModel,
                       k: int, plain: bool) -> float:
    """The DAG branch of :func:`bottleneck_ms`: stage compute is
    reach-weighted (downstream of an exit head only the surviving
    probability mass runs), and each stage's incoming traffic is the sum
    of the layer edges entering it — every crossing edge pays its own
    link latency on the receiving node (join synchronization), weighted
    by the destination layer's reach. Mirrors the DAG terms of
    ``PartitionPlanner._time_matrix`` so the planner's DP and the
    controller's evaluator agree on DAG plans too."""
    reach = graph.reach_probs()
    stage_of: Dict[int, int] = {}
    for part in partitions:
        for l in range(part.lo, part.hi):
            stage_of[l] = part.index
    in_edges: Dict[int, List[Tuple[int, float]]] = {
        part.index: [] for part in partitions}
    for u, v in graph.layer_edges():
        if stage_of[u] == stage_of[v]:
            continue
        b = graph.layers[u].out_bytes + graph.layers[u].state_bytes
        in_edges[stage_of[v]].append((b, reach[v]))
    per_node: Dict[str, float] = {}
    for part in partitions:
        node = cluster.nodes[assignment[part.index]]
        if not node.online:
            return math.inf
        cost = sum(graph.layers[i].cost * reach[i]
                   for i in range(part.lo, part.hi)) * scale
        if plain:
            t = execution_ms(cost, node.profile,
                             working_set_bytes(graph, part.lo, part.hi, batch))
            t += sum(w * transfer_ms(b * batch, node.profile)
                     for b, w in in_edges[part.index])
        else:
            t = model.amortized_stage_ms(
                cost, working_set_bytes(graph, part.lo, part.hi, batch * k),
                0.0, node.profile, k,
                model.partition_curve(graph, part.lo, part.hi))
            t += sum(w * transfer_ms(b * batch * k, node.profile)
                     for b, w in in_edges[part.index]) / k
        per_node[node.node_id] = per_node.get(node.node_id, 0.0) + t
    return max(per_node.values()) if per_node else math.inf


# --- the planner -------------------------------------------------------------

class PartitionPlanner:
    """Joint (boundaries, assignment) search over one ``ModelGraph``.

    One instance serves both initial deployment (``DistributedInference``)
    and mid-run re-planning (``AdaptationController``); per-call state
    (batch, calibration, opt-level speedup, live node set) is passed to
    :meth:`plan`, so the instance only caches graph invariants.
    """

    def __init__(self, graph: ModelGraph,
                 config: Optional[PlannerConfig] = None,
                 batch_model: Optional[BatchCostModel] = None):
        self.graph = graph
        self.cfg = config or PlannerConfig()
        self.batch_model = (batch_model if batch_model is not None
                            else ANALYTIC_BATCH_MODEL)
        L = len(graph.layers)
        costs = np.array([l.cost for l in graph.layers], dtype=np.float64)
        prefix = np.concatenate([[0.0], np.cumsum(costs)])
        # stage_cost[a, b] = raw (uncalibrated) cost of layers [a, b)
        self._stage_cost = prefix[None, :] - prefix[:, None]
        pparams = np.concatenate(
            [[0.0], np.cumsum([4.0 * l.params for l in graph.layers])])
        self._params_mat = pparams[None, :] - pparams[:, None]
        # peak resident bytes over [a, b): activation + recurrent/KV state
        # (running max from each start a) — mirrors working_set_bytes
        out_b = np.array([l.out_bytes + l.state_bytes
                          for l in graph.layers], dtype=np.float64)
        peak = np.zeros((L + 1, L + 1))
        for a in range(L):
            peak[a, a + 1:] = np.maximum.accumulate(out_b[a:])
        self._peak_act = peak
        self._in_bytes = np.array(
            [0.0] + [graph.layers[c - 1].out_bytes
                     + graph.layers[c - 1].state_bytes for c in range(1, L)]
            + [0.0])
        self._empty_mask = np.tril(np.ones((L + 1, L + 1), dtype=bool))
        self._L = L
        self._curve_mats = None   # lazy blended calibration matrices
        # --- operator-DAG overlays (chain graphs never touch these, so the
        # chain DP path stays bit-for-bit the original) -----------------------
        self._dag = not graph.is_chain
        if self._dag:
            graph.validate_dag()
            reach = np.array(graph.reach_probs(), dtype=np.float64)
            wprefix = np.concatenate([[0.0], np.cumsum(costs * reach)])
            # reach-weighted expected cost of layers [a, b): downstream of an
            # exit head, compute only runs with the surviving probability mass
            self._stage_cost_dag = wprefix[None, :] - wprefix[:, None]
            # incoming boundary traffic of stage [a, b) is the sum over layer
            # edges (u, v) with u < a <= v < b — 2D, unlike the chain's
            # single left-boundary edge; each crossing edge pays its own link
            # latency (join synchronization), weighted by reach[v]
            in_b2 = np.zeros((L + 1, L + 1))
            in_c2 = np.zeros((L + 1, L + 1))
            for u, v in graph.layer_edges():
                b = graph.layers[u].out_bytes + graph.layers[u].state_bytes
                w = float(reach[v])
                in_b2[u + 1:v + 1, v + 1:] += b * w
                in_c2[u + 1:v + 1, v + 1:] += w
            self._in_bytes2 = in_b2
            self._in_cnt2 = in_c2

    def _curve_matrices(self):
        """(O, S, KN, TL) matrices of the cost-weighted blended calibration
        curve per layer range [a, b) — ``BatchCostModel.partition_curve``
        vectorized over every range. Lazy: only calibrated models pay the
        O(L^2) build, and only once per planner instance."""
        if self._curve_mats is None:
            sc = self._stage_cost
            safe = np.where(sc > 0, sc, 1.0)
            mats = []
            for attr, default in (("overhead_ms", FIXED_OVERHEAD_MS),
                                  ("per_item_scale", 1.0),
                                  ("knee_k", 0.0), ("tail_scale", 1.0)):
                w = np.concatenate([[0.0], np.cumsum(
                    [l.cost * getattr(self.batch_model.curve_for(l.kind), attr)
                     for l in self.graph.layers])])
                blend = (w[None, :] - w[:, None]) / safe
                mats.append(np.where(sc > 0, blend, default))
            self._curve_mats = tuple(mats)
        return self._curve_mats

    # --- per-(call, node) stage-time matrices --------------------------------

    def _time_matrix(self, view: NodeView, batch: int, scale: float,
                     expected_k: int = 1) -> np.ndarray:
        """t[a, b] = stage period of layers [a, b) on this node, inf for
        b <= a. Vectorized mirror of ``_stage_ms`` (test_planner pins the
        two against each other so they cannot drift apart).

        ``expected_k`` > 1 (or a calibrated ``batch_model``) switches to
        the per-request *amortized* batched period — the vectorized mirror
        of ``BatchCostModel.amortized_stage_ms``: k× compute + one
        (calibrated) overhead + one coalesced incoming transfer, divided
        by k, with memory pressure at the k-scaled working set. The DP
        objective stays "max per-node serialized ms/request", so committed
        budgets and tenancy weights compose unchanged."""
        prof = view.profile
        k = max(int(expected_k), 1)
        sc = self._stage_cost_dag if self._dag else self._stage_cost
        if k == 1 and self.batch_model.is_analytic:
            t = (sc * scale
                 / (BASE_THROUGHPUT * min(prof.cpu, 1.0)) + FIXED_OVERHEAD_MS)
            ws = self._params_mat + batch * self._peak_act
        else:
            per_item = (sc * scale
                        / (BASE_THROUGHPUT * min(prof.cpu, 1.0)))
            if self.batch_model.is_analytic:
                t = per_item * k + FIXED_OVERHEAD_MS
            else:
                o_mat, s_mat, kn_mat, tl_mat = self._curve_matrices()
                per_item = per_item * s_mat * np.where(
                    (kn_mat > 0) & (k > kn_mat), tl_mat, 1.0)
                t = per_item * k + o_mat
            ws = self._params_mat + (batch * k) * self._peak_act
        over = ws > prof.mem_bytes
        if over.any():
            # exponentiate only where over-limit (elsewhere ws can be the
            # meaningless negative of an empty b < a range)
            pressure = np.where(over, ws / prof.mem_bytes, 1.0)
            t = t * pressure ** MEM_PRESSURE_ALPHA
        if self._dag:
            # per-crossing-edge latency (join synchronization: every
            # incoming branch pays its own link round-trip) + summed bytes
            in_b = self._in_bytes2 * (batch * k)
            xfer = np.where(self._in_cnt2 > 0,
                            self._in_cnt2 * prof.net_latency_ms
                            + in_b * 8.0 / (prof.net_bw_mbps * 1e3), 0.0)
            t = t + xfer
        else:
            in_b = self._in_bytes * (batch * k)
            xfer = np.where(in_b > 0,
                            prof.net_latency_ms
                            + in_b * 8.0 / (prof.net_bw_mbps * 1e3), 0.0)
            t = t + xfer[:, None]
        if k != 1:
            t = t / k
        return np.where(self._empty_mask, np.inf, t)

    # --- DP over one node order ----------------------------------------------

    def _dp_over_order(self, order: Sequence[int], tmats: List[np.ndarray]
                       ) -> Tuple[float, List[int], List[int]]:
        """Exact min-bottleneck for stages placed on an increasing
        subsequence of ``order``; O(L^2) per node step. Returns
        (bottleneck, cuts, node index per stage)."""
        L = self._L
        dp = np.full(L + 1, np.inf)
        dp[0] = 0.0
        rows = [dp]
        for j in order:
            stage_best = np.maximum(dp[:, None], tmats[j]).min(axis=0)
            dp = np.minimum(dp, stage_best)
            rows.append(dp)
        bott = float(dp[L])
        if not math.isfinite(bott):
            return math.inf, [], []
        # backtrack; prefer "skip node" on ties (fewer stages, less traffic)
        cuts_rev: List[int] = [L]
        nodes_rev: List[int] = []
        l, j = L, len(order)
        while l > 0:
            assert j > 0, "backtrack fell off the node order"
            prev = rows[j - 1]
            if prev[l] <= rows[j][l] + _EPS:
                j -= 1
                continue
            t = tmats[order[j - 1]]
            a = int(np.argmin(np.maximum(prev[:l], t[:l, l])))
            nodes_rev.append(order[j - 1])
            cuts_rev.append(a)
            l, j = a, j - 1
        return bott, cuts_rev[::-1], nodes_rev[::-1]

    # --- candidate node orders -----------------------------------------------

    def _balanced_cuts(self, m: int,
                       weights: Sequence[float]) -> Optional[List[int]]:
        """Bottleneck-balanced m-way cuts for per-stage capability weights —
        the shared ``partitioner.bottleneck_boundaries`` search. Only seeds
        candidate orders, so it ignores overhead/transfer terms. On a DAG
        graph the seeds balance the reach-weighted expected costs (the
        objective the DP actually prices stages at)."""
        sc = self._stage_cost_dag if self._dag else self._stage_cost
        return bottleneck_boundaries(np.diff(sc[0]).tolist(), m, weights)

    def _rematch_order(self, cuts: List[int], node_idx: List[int],
                       caps: List[float]) -> List[int]:
        """Sorted matching — heaviest stage gets the most capable of the
        chosen nodes — returned as the full node order induced along the
        pipeline (unused nodes appended by capability)."""
        m = len(cuts) - 1
        stage_costs = [float(self._stage_cost[cuts[i], cuts[i + 1]])
                       for i in range(m)]
        by_cost = sorted(range(m), key=lambda i: -stage_costs[i])
        by_cap = sorted(node_idx, key=lambda j: -caps[j])
        slot = [0] * m
        for rank, i in enumerate(by_cost):
            slot[i] = by_cap[rank]
        chosen = set(slot)
        rest = sorted((j for j in range(len(caps)) if j not in chosen),
                      key=lambda j: -caps[j])
        return slot + rest

    # --- public entry point --------------------------------------------------

    def plan(self, views: Sequence[NodeView], batch: int = 1,
             calibration: float = 1.0, speedup: float = 1.0,
             mode: Optional[str] = None,
             committed_ms: Optional[Dict[str, float]] = None,
             weight: float = 1.0, expected_k: int = 1) -> Optional[PlanResult]:
        """Solve (cuts, assignment) for the given live nodes.

        Args:
            views: live nodes (``node_views_from_stats`` / ``_from_cluster``).
            batch / calibration / speedup: cost scaling, matching how the
                pipeline charges stage execution.
            mode: override the configured search mode for this call.
            committed_ms: per-node time budget (ms/request) already held
                by other tenants' stages — added to each node's bottleneck
                contribution, so the search routes around co-resident
                models. Nodes absent from the map are uncommitted.
            weight: this tenant's relative traffic weight; scales its own
                stage times so tenants of different offered load compare
                in the same utilization units.
            expected_k: the operating micro-batch the engine is expected
                to coalesce at (queue-depth-driven ``traffic.adaptive_k``
                or the static engine cap) — the search co-designs cuts
                with the batch, costing stages at their per-request
                amortized batched time. 1 (with the analytic batch model)
                reproduces the original k=1 objective bit-for-bit.
        Returns:
            ``PlanResult`` with node ids filled in, or None when no node has
            capacity.
        """
        t_start = time.perf_counter()
        views = [v for v in views if v.capability > 0.0]
        if not views:
            return None
        mode = mode or self.cfg.mode
        if mode == "auto":
            mode = ("exhaustive"
                    if len(views) <= self.cfg.exhaustive_max_nodes else "dp")
        n = len(views)
        # one contiguous stage per node bounds dp/exhaustive at n stages;
        # assign/beam may reuse nodes, so they are only capped by config
        default_max = self._L if mode in ("beam", "assign") else n
        max_stages = min(self._L, self.cfg.max_stages or default_max)
        if mode not in ("beam", "assign"):
            # clamp a configured max_stages to the LIVE node count: after a
            # death, fewer nodes than the deploy-time stage count must yield
            # a shallower plan, not an empty permutation search (-> None,
            # which the controller would misread as "no capacity")
            max_stages = min(max_stages, n)
        scale = calibration * batch / speedup
        tmats = [self._time_matrix(v, batch, scale, expected_k)
                 for v in views]
        if weight != 1.0:
            tmats = [m * weight for m in tmats]
        caps = [v.capability for v in views]
        committed, floor = self._committed_vector(views, committed_ms)

        if mode == "beam":
            res = self._beam(tmats, n, max_stages, committed)
        elif mode == "assign":
            res = self._assign(tmats, caps, max_stages, committed)
        elif mode == "exhaustive":
            res = self._search_orders(
                itertools.permutations(range(n), max_stages),
                self._with_committed(tmats, committed), mode)
        elif mode == "dp":
            res = self._dp_candidates(self._with_committed(tmats, committed),
                                      caps, max_stages)
        else:
            raise ValueError(f"unknown planner mode: {mode}")
        if res is None:
            return None
        res.bottleneck_ms = max(res.bottleneck_ms, floor)
        res.assignment = [views[j].node_id for j in res.node_idx]
        res.elapsed_ms = (time.perf_counter() - t_start) * 1e3
        return res

    @staticmethod
    def _committed_vector(views, committed_ms):
        """Per-view committed-load array plus its max (the bottleneck
        floor a plan can never beat: a fully-committed node stays loaded
        whether or not this tenant lands stages on it)."""
        if not committed_ms:
            return None, 0.0
        committed = np.array([float(committed_ms.get(v.node_id, 0.0))
                              for v in views])
        return committed, float(committed.max())

    @staticmethod
    def _with_committed(tmats, committed):
        """Fold per-node committed load into the stage-time matrices —
        exact for the one-stage-per-node DP/exhaustive searches (a node's
        total is its committed load plus its single stage). The
        node-reuse searches (assign/beam) keep committed separate, as a
        per-node load initializer, to avoid charging it once per stage."""
        if committed is None:
            return tmats
        return [m + c for m, c in zip(tmats, committed)]

    # --- search drivers ------------------------------------------------------

    def _search_orders(self, orders, tmats, mode) -> Optional[PlanResult]:
        best = None
        runs = 0
        for order in orders:
            runs += 1
            bott, cuts, nidx = self._dp_over_order(list(order), tmats)
            if cuts and (best is None or bott < best.bottleneck_ms - _EPS):
                best = PlanResult(cuts, [], bott, mode, node_idx=nidx)
        if best is not None:
            best.dp_runs = runs
        return best

    def _dp_candidates(self, tmats, caps, max_stages) -> Optional[PlanResult]:
        """Polynomial search: capability-sorted orders plus per-stage-count
        rematch seeds, then DP <-> rematch iteration and pairwise-swap
        polish — O(n) DP solves of O(L^2 n) each."""
        n = len(caps)
        desc = sorted(range(n), key=lambda j: -caps[j])
        orders = [desc[:max_stages], desc[:max_stages][::-1]]
        for m in range(1, max_stages + 1):
            top = desc[:m]
            cuts = self._balanced_cuts(m, [caps[j] for j in top])
            if cuts is None:
                continue
            orders.append(self._rematch_order(cuts, top, caps)[:max_stages])
        best = self._search_orders(orders, tmats, "dp")
        if best is None:
            return None
        for _ in range(self.cfg.rematch_iters):
            order = self._rematch_order(best.cuts, best.node_idx,
                                        caps)[:max_stages]
            bott, cuts, nidx = self._dp_over_order(order, tmats)
            best.dp_runs += 1
            if cuts and bott < best.bottleneck_ms - _EPS:
                best = PlanResult(cuts, [], bott, "dp", best.dp_runs,
                                  node_idx=nidx)
            else:
                break
        return self._swap_polish(best, tmats, caps, max_stages)

    def _swap_polish(self, best: PlanResult, tmats, caps,
                     max_stages: int) -> PlanResult:
        """Local search over assignment permutations the sorted rematch
        cannot express (e.g. link-cost asymmetries): swap the bottleneck
        stage's node with every alternative, keep improvements, and let the
        DP re-optimize cuts on each improved order."""
        n = len(caps)
        for _ in range(self.cfg.local_swap_iters):
            nidx = best.node_idx
            m = len(nidx)
            stage_t = [float(tmats[nidx[i]][best.cuts[i], best.cuts[i + 1]])
                       for i in range(m)]
            worst = max(range(m), key=lambda i: stage_t[i])
            improved = False
            for j in range(n):
                trial = list(nidx)
                if j in trial:
                    k = trial.index(j)
                    trial[worst], trial[k] = trial[k], trial[worst]
                else:
                    trial[worst] = j
                if trial == nidx:
                    continue
                tt = max(float(tmats[trial[i]][best.cuts[i], best.cuts[i + 1]])
                         for i in range(m))
                if tt < best.bottleneck_ms - _EPS:
                    chosen = set(trial)
                    order = (trial + sorted(
                        (q for q in range(n) if q not in chosen),
                        key=lambda q: -caps[q]))[:max_stages]
                    bott, cuts, nidx2 = self._dp_over_order(order, tmats)
                    best.dp_runs += 1
                    if cuts and bott < best.bottleneck_ms - _EPS:
                        best = PlanResult(cuts, [], bott, "dp", best.dp_runs,
                                          node_idx=nidx2)
                        improved = True
                        break
            if not improved:
                break
        return best

    # --- non-contiguous placements -------------------------------------------

    def _assign(self, tmats, caps, max_stages,
                committed=None) -> Optional[PlanResult]:
        """Min-max (stage, node) assignment with node reuse — the
        non-contiguous search that replaced the beam fallback.

        Candidate cut lists (the DP's contiguous optimum plus a balanced
        cut list per stage count) are assigned to nodes by
        longest-processing-time-first list scheduling over the per-node
        stage times — each node's load starts at its committed (other-
        tenant) budget — then polished by single-stage moves off the
        bottleneck node. Seeded with the DP result, so it never returns a
        plan worse than the contiguous optimum it generalizes."""
        n = len(caps)
        base = self._dp_candidates(self._with_committed(tmats, committed),
                                   caps, min(n, max_stages))
        best = base
        cut_cands = [base.cuts] if base is not None else []
        for m in range(1, max_stages + 1):
            cuts = self._balanced_cuts(m, [1.0] * m)
            if cuts is not None:
                cut_cands.append(cuts)
        seen = set()
        for cuts in cut_cands:
            key = tuple(cuts)
            if key in seen:
                continue
            seen.add(key)
            res = self._lpt_assign(cuts, tmats, committed)
            if res is not None and (best is None
                                    or res.bottleneck_ms
                                    < best.bottleneck_ms - _EPS):
                best = res
        if best is not None:
            best.mode = "assign"
            if base is not None:
                best.dp_runs = base.dp_runs
        return best

    @staticmethod
    def _best_single_move(t, loads, assign, movable):
        """Best single stage→node move off the current bottleneck node:
        the (stage, node) pair minimizing the resulting global maximum,
        or None when no move of a ``movable`` stage strictly lowers it.
        Shared by the ``assign`` polish and :meth:`plan_partial`, so the
        two descents cannot drift apart."""
        n = len(loads)
        worst = int(np.argmax(loads))
        second = float(np.sort(loads)[-2]) if n > 1 else 0.0
        best_move, best_new = None, float(loads[worst])
        for i in (i for i in movable if assign[i] == worst):
            rem = float(loads[worst] - t[worst, i])
            for j in range(n):
                if j == worst:
                    continue
                cand = max(second, rem, float(loads[j] + t[j, i]))
                if cand < best_new - _EPS:
                    best_new, best_move = cand, (i, j)
        return best_move

    def _lpt_assign(self, cuts, tmats, committed=None) -> Optional[PlanResult]:
        """LPT list scheduling of the stages induced by ``cuts`` onto
        nodes (min-max objective, node reuse allowed), then a bounded
        single-stage-move polish: while some move of one stage off the
        bottleneck node strictly lowers the global maximum, apply the
        best such move."""
        m = len(cuts) - 1
        n = len(tmats)
        t = np.array([[float(tm[cuts[i], cuts[i + 1]]) for i in range(m)]
                      for tm in tmats])
        if not np.all(np.isfinite(t.min(axis=0))):
            return None              # some stage fits no node at finite time
        loads = (np.zeros(n) if committed is None
                 else np.asarray(committed, dtype=np.float64).copy())
        assign = [0] * m
        for i in sorted(range(m), key=lambda i: -float(t[:, i].min())):
            j = int(np.argmin(loads + t[:, i]))
            assign[i] = j
            loads[j] += t[j, i]
        all_stages = range(m)
        for _ in range(4 * m):
            move = self._best_single_move(t, loads, assign, all_stages)
            if move is None:
                break
            i, j = move
            loads[assign[i]] -= t[assign[i], i]
            loads[j] += t[j, i]
            assign[i] = j
        bott = float(loads.max())
        if not math.isfinite(bott):
            return None
        return PlanResult(list(cuts), [], bott, "assign", node_idx=assign)

    # --- bounded re-assignment (partial migrations) --------------------------

    def plan_partial(self, views: Sequence[NodeView], cuts: Sequence[int],
                     assignment: Sequence[str], max_moves: int,
                     batch: int = 1, calibration: float = 1.0,
                     speedup: float = 1.0,
                     committed_ms: Optional[Dict[str, float]] = None,
                     weight: float = 1.0,
                     expected_k: int = 1) -> Optional[PlanResult]:
        """Partial migration: keep the cut list fixed, move **at most**
        ``max_moves`` stages to new nodes (greedy best-move descent on the
        bottleneck). The candidate's migration cost is only the moved
        stages' parameter bytes — the cheap alternative the Adaptation
        Controller weighs against a full re-plan. Stages whose current
        node is absent from ``views`` (dead or zero-capability) are
        re-homed first and do not count against ``max_moves`` — repairing
        availability is not a voluntary move. Returns None when no finite
        assignment of the fixed cuts exists."""
        t_start = time.perf_counter()
        views = [v for v in views if v.capability > 0.0]
        if not views:
            return None
        scale = calibration * batch / speedup
        tmats = [self._time_matrix(v, batch, scale, expected_k)
                 for v in views]
        if weight != 1.0:
            tmats = [m * weight for m in tmats]
        committed, floor = self._committed_vector(views, committed_ms)
        n, m = len(views), len(cuts) - 1
        t = np.array([[float(tm[cuts[i], cuts[i + 1]]) for i in range(m)]
                      for tm in tmats])
        idx_of = {v.node_id: j for j, v in enumerate(views)}
        assign: List[int] = []
        forced: List[int] = []
        for i, nid in enumerate(assignment):
            j = idx_of.get(nid)
            if j is None:
                forced.append(i)
            assign.append(-1 if j is None else j)
        loads = (np.zeros(n) if committed is None
                 else np.asarray(committed, dtype=np.float64).copy())
        for i, j in enumerate(assign):
            if j >= 0:
                loads[j] += t[j, i]
        for i in forced:                    # dead homes: re-home first
            j = int(np.argmin(loads + t[:, i]))
            if not math.isfinite(float(t[j, i])):
                return None
            assign[i] = j
            loads[j] += t[j, i]
        moved: set = set()
        for _ in range(max_moves):
            movable = [i for i in range(m)
                       if i not in moved and i not in forced]
            move = self._best_single_move(t, loads, assign, movable)
            if move is None:
                break
            i, j = move
            loads[assign[i]] -= t[assign[i], i]
            loads[j] += t[j, i]
            assign[i] = j
            moved.add(i)
        bott = max(float(loads.max()), floor)
        if not math.isfinite(bott):
            return None
        return PlanResult(list(cuts), [views[j].node_id for j in assign],
                          bott, "partial", node_idx=assign,
                          moved_stages=len(moved) + len(forced),
                          elapsed_ms=(time.perf_counter() - t_start) * 1e3)

    # --- per-plan node loads (tenancy budgets) -------------------------------

    def stage_loads(self, cuts: Sequence[int], assignment: Sequence[str],
                    views: Sequence[NodeView], batch: int = 1,
                    calibration: float = 1.0, speedup: float = 1.0,
                    weight: float = 1.0,
                    expected_k: int = 1) -> Dict[str, float]:
        """Per-node time (ms/request, traffic-weighted) one plan charges:
        the committed budget its tenant contributes to every other
        tenant's search. Uses the scalar ``_stage_ms`` evaluator (the
        batch-aware ``amortized_stage_ms`` when ``expected_k`` > 1 or a
        calibration artifact is loaded), so the budget and the planner's
        own objective cannot drift apart."""
        scale = calibration * batch / speedup
        k = max(int(expected_k), 1)
        plain = k == 1 and self.batch_model.is_analytic
        view_by = {v.node_id: v for v in views}
        out: Dict[str, float] = {}
        for i in range(len(cuts) - 1):
            lo, hi = cuts[i], cuts[i + 1]
            v = view_by[assignment[i]]
            if self._dag:
                # mirror the DAG terms of _time_matrix: reach-weighted cost
                # plus per-crossing-edge transfers on the receiving link
                sc = float(self._stage_cost_dag[lo, hi]) * scale
                xfer = (float(self._in_cnt2[lo, hi]) * v.profile.net_latency_ms
                        + float(self._in_bytes2[lo, hi]) * (batch * k) * 8.0
                        / (v.profile.net_bw_mbps * 1e3))
                if plain:
                    ms = (execution_ms(
                        sc, v.profile,
                        float(self._params_mat[lo, hi]
                              + batch * self._peak_act[lo, hi])) + xfer) * weight
                else:
                    ms = (self.batch_model.amortized_stage_ms(
                        sc, float(self._params_mat[lo, hi]
                                  + (batch * k) * self._peak_act[lo, hi]),
                        0.0, v.profile, k,
                        self.batch_model.partition_curve(self.graph, lo, hi))
                        + xfer / k) * weight
            elif plain:
                ms = _stage_ms(
                    float(self._stage_cost[lo, hi]) * scale,
                    float(self._params_mat[lo, hi]
                          + batch * self._peak_act[lo, hi]),
                    float(self._in_bytes[lo]) * batch if lo > 0 else 0.0,
                    v.profile) * weight
            else:
                ms = self.batch_model.amortized_stage_ms(
                    float(self._stage_cost[lo, hi]) * scale,
                    float(self._params_mat[lo, hi]
                          + (batch * k) * self._peak_act[lo, hi]),
                    float(self._in_bytes[lo]) * batch if lo > 0 else 0.0,
                    v.profile, k,
                    self.batch_model.partition_curve(self.graph, lo, hi)
                ) * weight
            out[v.node_id] = out.get(v.node_id, 0.0) + ms
        return out

    # --- beam fallback (legacy non-contiguous search) ------------------------

    def _beam(self, tmats, n: int, max_stages: int,
              committed=None) -> Optional[PlanResult]:
        """Width-bounded left-to-right search that may give one node several
        non-contiguous stages (their times add up on that node), capped at
        ``max_stages`` stages total. Kept as the comparison oracle for the
        ``assign`` mode that superseded it.

        State: (bottleneck over closed stages, per-node busy times, start of
        the open stage, node of the open stage, cuts, stage nodes). At each
        boundary every beam state may cut and open a new stage on any node;
        scoring includes the open stage so long cheap extensions are kept.
        Per-node busy times start at the committed (other-tenant) budget.
        """
        L = self._L
        width = self.cfg.beam_width

        def score(state, l):
            bott, busy, a, jopen = state[0], state[1], state[2], state[3]
            return max(bott, busy[jopen] + float(tmats[jopen][a, l]))

        busy0 = (tuple([0.0] * n) if committed is None
                 else tuple(float(c) for c in committed))
        beam = [(0.0, busy0, 0, j, (0,), (j,)) for j in range(n)]
        for l in range(1, L):
            nxt = list(beam)   # continue the open stage through layer l
            for state in beam:
                bott, busy, a, jopen, cuts, nodes = state
                if len(nodes) >= max_stages:
                    continue   # stage budget spent: extend only
                t = float(tmats[jopen][a, l])
                nb = list(busy)
                nb[jopen] += t
                closed = max(bott, nb[jopen])
                for j in range(n):   # cut at l, open next stage on node j
                    nxt.append((closed, tuple(nb), l, j,
                                cuts + (l,), nodes + (j,)))
            nxt.sort(key=lambda s: (score(s, min(l + 1, L)), len(s[5])))
            beam = nxt[:width]
        best = min(beam, key=lambda s: score(s, L))
        final = score(best, L)
        if not math.isfinite(final):
            return None
        return PlanResult(list(best[4]) + [L], [], final, "beam",
                          node_idx=list(best[5]))


# --- joint multi-tenant planning ---------------------------------------------

@dataclass(frozen=True)
class TenantPlanSpec:
    """One tenant's inputs to the joint multi-tenant search: its planner
    (graph + config), cost scaling, and relative traffic weight."""
    name: str
    planner: PartitionPlanner
    batch: int = 1
    calibration: float = 1.0
    speedup: float = 1.0
    weight: float = 1.0
    expected_k: int = 1


def plan_tenants(specs: Sequence[TenantPlanSpec], views: Sequence[NodeView],
                 rounds: int = 3,
                 mode: Optional[str] = None) -> Optional[Dict[str, PlanResult]]:
    """Joint (tenant, stage, node) planning under shared per-node time
    budgets, by Gauss-Seidel descent: each tenant re-plans (DP, or the
    given mode) against the weighted per-node time committed by every
    *other* tenant's current plan, sweeping tenants until no plan changes
    or ``rounds`` sweeps elapse. The per-tenant subproblem is exact (the
    DP), so each sweep monotonically improves that tenant's bottleneck
    given the others — the fixed point is a plan-level equilibrium where
    no single tenant can improve by re-planning alone.

    Returns {tenant name: PlanResult}, or None if any tenant finds no
    capacity. Deterministic: tenants are swept in the given order.
    """
    results: Dict[str, PlanResult] = {}
    loads: Dict[str, Dict[str, float]] = {}
    for _ in range(max(rounds, 1)):
        changed = False
        for spec in specs:
            committed: Dict[str, float] = {}
            for other, node_ms in loads.items():
                if other == spec.name:
                    continue
                for nid, ms in node_ms.items():
                    committed[nid] = committed.get(nid, 0.0) + ms
            res = spec.planner.plan(
                views, batch=spec.batch, calibration=spec.calibration,
                speedup=spec.speedup, mode=mode,
                committed_ms=committed or None, weight=spec.weight,
                expected_k=spec.expected_k)
            if res is None:
                return None
            prev = results.get(spec.name)
            if (prev is None or res.cuts != prev.cuts
                    or res.assignment != prev.assignment):
                changed = True
            results[spec.name] = res
            loads[spec.name] = spec.planner.stage_loads(
                res.cuts, res.assignment, views, batch=spec.batch,
                calibration=spec.calibration, speedup=spec.speedup,
                weight=spec.weight, expected_k=spec.expected_k)
        if not changed:
            break
    return results
