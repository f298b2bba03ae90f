"""Task Scheduler with the Node Selection Algorithm (paper §III-C, Alg. 1).

Weighted scoring, Eq. 4:
    Total = 0.2 * S_R + 0.2 * S_L + 0.1 * S_P + 0.5 * S_B
with S_R (Eq. 5) resource sufficiency, S_L (Eq. 6) inverse load,
S_P (Eq. 7) inverse normalized historical execution time, and
S_B (Eq. 8) fairness 1 / (1 + 2 * task_count).

Nodes with current_load > 0.8 or network latency above threshold are
skipped, exactly as Alg. 1 lines 4–9. Completed tasks feed the performance
history; recent execution times are normalized into [0, 1] to form
AvgExecTime (the paper's §III-C note).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.monitor import LATENCY_THRESHOLD_MS, NodeStats

DEFAULT_WEIGHTS = dict(resource=0.2, load=0.2, perf=0.1, balance=0.5)
LOAD_SKIP_THRESHOLD = 0.8
LATENCY_SKIP_MS = LATENCY_THRESHOLD_MS
SCHEDULING_OVERHEAD_MS = 10.0      # paper Table I: 10 ms per decision
HISTORY_LEN = 32


@dataclass
class TaskRequirements:
    """Resource demand of one task, checked against node availability in
    Alg. 1's eligibility filter."""
    cpu: float = 0.1
    mem_mb: float = 64.0
    priority: int = 0


@dataclass
class NodeScore:
    """Per-node Eq. 4 score breakdown; ``skipped`` carries the Alg. 1
    exclusion reason when the node was filtered before scoring."""
    node_id: str
    resource: float
    load: float
    perf: float
    balance: float
    total: float
    skipped: Optional[str] = None


class TaskScheduler:
    """Node Selection Algorithm (paper Alg. 1): weighted Eq. 4 scoring over
    live ``NodeStats``, plus the execution-history feedback that both the
    S_P score and the planner's capability de-rating consume."""

    def __init__(self, weights: Optional[Dict[str, float]] = None,
                 load_threshold: float = LOAD_SKIP_THRESHOLD,
                 latency_threshold_ms: float = LATENCY_SKIP_MS):
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        assert abs(sum(self.weights.values()) - 1.0) < 1e-9
        self.load_threshold = load_threshold
        self.latency_threshold_ms = latency_threshold_ms
        self.exec_history: Dict[str, List[float]] = {}
        self.perf_ratios: Dict[str, List[float]] = {}   # observed / predicted
        self.task_counts: Dict[str, int] = {}
        self.skip_counts: Dict[str, int] = {}
        #: served execution time per (tenant, node) — the tenancy layer's
        #: observed counterpart of the planner's per-node time budgets
        self.node_service_ms: Dict[Tuple[str, str], float] = {}
        self.decisions = 0
        self.overhead_ms = 0.0

    # --- scoring (Eq. 5-8) ---------------------------------------------------

    def _resource_score(self, n: NodeStats, req: TaskRequirements) -> float:
        cpu_term = n.cpu_avail / max(req.cpu, 1e-9)
        mem_term = n.mem_avail_mb / max(req.mem_mb, 1e-9)
        return (cpu_term + mem_term) / 2.0

    @staticmethod
    def _load_score(n: NodeStats) -> float:
        return 1.0 - n.current_load

    def _perf_score(self, node_id: str,
                    tmax: Optional[float] = None) -> float:
        hist = self.exec_history.get(node_id)
        if not hist:
            return 1.0
        if tmax is None:   # fleet-wide max; score_nodes hoists it per call
            tmax = max((t for h in self.exec_history.values() for t in h),
                       default=0.0)
        avg = sum(hist) / len(hist)
        norm = avg / tmax if tmax > 0 else 0.0      # normalized to [0, 1]
        return 1.0 / (1.0 + norm)

    def _balance_score(self, node_id: str) -> float:
        return 1.0 / (1.0 + 2.0 * self.task_counts.get(node_id, 0))

    # --- Algorithm 1 -----------------------------------------------------------

    def score_nodes(self, nodes: List[NodeStats],
                    req: TaskRequirements) -> List[NodeScore]:
        """Score every node per Eq. 4-8, applying Alg. 1 lines 4-9 skip
        rules (offline / overloaded / high-latency / insufficient)."""
        out = []
        # the S_P normalizer is fleet-wide: compute it once per scoring
        # pass, not once per node (it scans every node's history window)
        tmax = max((t for h in self.exec_history.values() for t in h),
                   default=0.0)
        for n in nodes:
            if not n.online:
                out.append(NodeScore(n.node_id, 0, 0, 0, 0, 0, skipped="offline"))
                continue
            if n.current_load > self.load_threshold:
                out.append(NodeScore(n.node_id, 0, 0, 0, 0, 0, skipped="overloaded"))
                continue
            if n.net_latency_ms > self.latency_threshold_ms:
                out.append(NodeScore(n.node_id, 0, 0, 0, 0, 0, skipped="high-latency"))
                continue
            if n.cpu_avail < req.cpu or n.mem_avail_mb < req.mem_mb:
                out.append(NodeScore(n.node_id, 0, 0, 0, 0, 0,
                                     skipped="insufficient-resources"))
                continue
            s_r = self._resource_score(n, req)
            s_l = self._load_score(n)
            s_p = self._perf_score(n.node_id, tmax)
            s_b = self._balance_score(n.node_id)
            total = (self.weights["resource"] * min(s_r, 1.0)
                     + self.weights["load"] * s_l
                     + self.weights["perf"] * s_p
                     + self.weights["balance"] * s_b)
            out.append(NodeScore(n.node_id, s_r, s_l, s_p, s_b, total))
        return out

    def select_node(self, nodes: List[NodeStats],
                    req: Optional[TaskRequirements] = None) -> Optional[str]:
        """Pick the highest-scoring eligible node for a task (Alg. 1);
        returns None when every node is skipped. Charges the paper's 10 ms
        decision overhead and bumps the winner's queue count."""
        req = req or TaskRequirements()
        self.decisions += 1
        self.overhead_ms += SCHEDULING_OVERHEAD_MS
        best, best_score = None, 0.0
        for s in self.score_nodes(nodes, req):
            if s.skipped is not None:
                self.skip_counts[s.skipped] = self.skip_counts.get(s.skipped, 0) + 1
            elif s.total > best_score:
                best, best_score = s.node_id, s.total
        if best is not None:
            self.task_counts[best] = self.task_counts.get(best, 0) + 1
        return best

    def select_alternate(self, nodes: List[NodeStats],
                         exclude: tuple = (),
                         req: Optional[TaskRequirements] = None,
                         eligible=None) -> Optional[str]:
        """Failure-path re-score (Alg. 1 over the survivors): the
        highest-scoring node not in ``exclude`` that passes the caller's
        ``eligible`` predicate (e.g. engine-idle right now). Used by the
        fault layer (``core.faults``) to pick the target of a retry
        re-dispatch or a hedged duplicate. Charges the same 10 ms
        decision overhead and winner queue-count bump as
        :meth:`select_node` — a recovery dispatch is a scheduling
        decision like any other."""
        req = req or TaskRequirements()
        self.decisions += 1
        self.overhead_ms += SCHEDULING_OVERHEAD_MS
        best, best_score = None, 0.0
        for s in self.score_nodes(nodes, req):
            if s.skipped is not None:
                self.skip_counts[s.skipped] = (
                    self.skip_counts.get(s.skipped, 0) + 1)
                continue
            if s.node_id in exclude:
                continue
            if eligible is not None and not eligible(s.node_id):
                continue
            if s.total > best_score:
                best, best_score = s.node_id, s.total
        if best is not None:
            self.task_counts[best] = self.task_counts.get(best, 0) + 1
        return best

    def select_node_compact(self, nodes, req: Optional[TaskRequirements]
                            = None) -> Optional[str]:
        """:meth:`select_node` over *live online* ``EdgeNode`` objects —
        the fast event core's snapshot-free poll tick (paired with
        ``ResourceMonitor.poll_compact``). Every float is produced by the
        same expression on the same inputs as the ``NodeStats`` path
        (Eq. 5's availability terms are inlined from the snapshot
        properties), and every side effect (decision/overhead counters,
        skip counts in node order, the winner's queue-count bump) is
        applied identically — so a run is bit-for-bit equal whichever
        path polls. Only the intermediate ``NodeStats``/``NodeScore``
        allocations are skipped. ``nodes`` must be the online subset in
        cluster order, exactly what ``poll_compact`` returns."""
        req = req or TaskRequirements()
        self.decisions += 1
        self.overhead_ms += SCHEDULING_OVERHEAD_MS
        tmax = max((t for h in self.exec_history.values() for t in h),
                   default=0.0)
        w_r = self.weights["resource"]
        w_l = self.weights["load"]
        w_p = self.weights["perf"]
        w_b = self.weights["balance"]
        skips = self.skip_counts
        best, best_score = None, 0.0
        for node in nodes:
            load = node.current_load
            if load > self.load_threshold:
                skips["overloaded"] = skips.get("overloaded", 0) + 1
                continue
            prof = node.profile
            if prof.net_latency_ms > self.latency_threshold_ms:
                skips["high-latency"] = skips.get("high-latency", 0) + 1
                continue
            cpu_avail = prof.cpu * max(0.0, 1.0 - load)
            mem_avail = max(0.0, prof.mem_mb
                            - node.mem_used_bytes / (1024 * 1024))
            if cpu_avail < req.cpu or mem_avail < req.mem_mb:
                skips["insufficient-resources"] = (
                    skips.get("insufficient-resources", 0) + 1)
                continue
            s_r = (cpu_avail / max(req.cpu, 1e-9)
                   + mem_avail / max(req.mem_mb, 1e-9)) / 2.0
            s_l = 1.0 - load
            s_p = self._perf_score(node.node_id, tmax)
            s_b = self._balance_score(node.node_id)
            total = (w_r * min(s_r, 1.0) + w_l * s_l
                     + w_p * s_p + w_b * s_b)
            if total > best_score:
                best, best_score = node.node_id, total
        if best is not None:
            self.task_counts[best] = self.task_counts.get(best, 0) + 1
        return best

    # --- history feedback -------------------------------------------------------

    def task_completed(self, node_id: str, exec_ms: float,
                       predicted_ms: Optional[float] = None,
                       tenant: Optional[str] = None) -> None:
        """Feed one finished task back into the performance history and
        free the node's queue slot. With ``predicted_ms`` (the cost-model
        expectation for that task on that node), the observed/predicted
        ratio also feeds :meth:`perf_weight`. ``tenant`` attributes the
        served time to a tenancy-layer budget (:attr:`node_service_ms`)."""
        if tenant is not None:
            key = (tenant, node_id)
            self.node_service_ms[key] = (self.node_service_ms.get(key, 0.0)
                                         + exec_ms)
        h = self.exec_history.setdefault(node_id, [])
        h.append(exec_ms)
        if len(h) > HISTORY_LEN:
            h.pop(0)
        if predicted_ms is not None and predicted_ms > 0:
            r = self.perf_ratios.setdefault(node_id, [])
            r.append(exec_ms / predicted_ms)
            if len(r) > HISTORY_LEN:
                r.pop(0)
        # recalibrate node load: a completed task frees a slot
        if self.task_counts.get(node_id, 0) > 0:
            self.task_counts[node_id] -= 1

    def bulk_complete(self, node_id: str, exec_ms: float, count: int,
                      predicted_ms: Optional[float] = None,
                      tenant: Optional[str] = None) -> None:
        """Amortized :meth:`task_completed`: fold ``count`` completions of
        identical duration (the engine's per-stage executions since the last
        monitor poll) into one history/ratio entry plus a ``count``-sized
        queue-count release. Note the history entry is *one* sample, not
        ``count``: a node whose window mixes durations (several stages per
        node) weights each distinct duration equally rather than
        per-completion, which is fine for the S_P/perf-weight consumers
        (ratios are duration-independent) but is not a per-task-identical
        history."""
        if count <= 0:
            return
        self.task_completed(node_id, exec_ms, predicted_ms=predicted_ms,
                            tenant=tenant)
        if count > 1:
            if tenant is not None:   # remaining count-1 completions' time
                key = (tenant, node_id)
                self.node_service_ms[key] = (self.node_service_ms.get(key, 0.0)
                                             + exec_ms * (count - 1))
            if self.task_counts.get(node_id, 0) > 0:
                # task_completed released one queue slot; release the rest
                self.task_counts[node_id] = max(
                    0, self.task_counts[node_id] - (count - 1))

    def perf_weight(self, node_id: str) -> float:
        """Multiplicative capability de-rating for the partition planner:
        the inverse of the node's average observed/predicted execution
        ratio, clamped to [0.5, 1.5]. Model-normalized on purpose — a slow
        node whose slowness the cost model already captures is NOT
        penalized; only unmodeled deviation (a node running hotter than
        its profile predicts) moves the weight. 1.0 with no ratio history
        — this is the paper's historical-performance signal (S_P) reaching
        the planner instead of only per-task routing."""
        ratios = self.perf_ratios.get(node_id)
        if not ratios:
            return 1.0
        avg = sum(ratios) / len(ratios)
        if avg <= 0:
            return 1.0
        return min(1.5, max(0.5, 1.0 / avg))

    def metrics(self) -> dict:
        """Aggregate scheduler telemetry: decision count/overhead, queue
        lengths, skip reasons, and per-node average execution times."""
        return dict(
            decisions=self.decisions,
            overhead_ms=self.overhead_ms,
            avg_overhead_ms=(self.overhead_ms / self.decisions
                             if self.decisions else 0.0),
            queue_lengths={k: v for k, v in self.task_counts.items()},
            skip_counts=dict(self.skip_counts),
            avg_exec_ms={k: sum(v) / len(v)
                         for k, v in self.exec_history.items() if v},
            node_service_ms={f"{t}@{n}": round(v, 1)
                             for (t, n), v in self.node_service_ms.items()},
        )
