"""Distributed partitioned-inference pipeline + metrics (paper §IV).

Executes AMP4EC end-to-end on the simulated cluster: requests flow through
partition stages placed on heterogeneous nodes; stage timing follows the
calibrated cost model; numerics (when an executor is supplied) are real model
computation and are verified partitioned == monolithic at deploy time.

Timing semantics (discrete-event):
  stage_start(r, s) = max(activation_arrival(r, s), node_free(s))
so consecutive requests pipeline across stages, and per-request latency =
last stage end - submit time. The monolithic baseline is the same machinery
with one partition on one node (single-threaded runtime, as in the paper's
PyTorch container).

Request streams are driven by ``core.engine.PipelineEngine``: the default
configuration reproduces the seed loop's timing bit-for-bit at a fraction of
the per-request cost (precomputed stage tables, poll-granular accounting,
numpy metric columns), while ``EngineConfig(transfer="overlap",
micro_batch=k)`` unlocks DEFER-style transfer/compute overlap and
stage-level micro-batching. The seed loop itself is kept reachable as
:meth:`DistributedInference.run_legacy` — the parity oracle.
"""

from __future__ import annotations

import dataclasses
import statistics
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.adaptation import (AdaptationConfig, AdaptationController,
                                   ScenarioEvent, apply_scenario_event)
from repro_torch.core.cache import ResultCache, digest
from repro_torch.core.cluster import EdgeCluster
from repro_torch.core.cost_model import (ANALYTIC_BATCH_MODEL, BatchCostModel,
                                   execution_ms, transfer_ms)
from repro_torch.core.deployer import ModelDeployer
from repro_torch.core.monitor import ResourceMonitor
from repro_torch.core.partitioner import ModelPartitioner, PartitionPlan
from repro_torch.core.planner import (PartitionPlanner, PlannerConfig,
                                node_views_from_cluster)
from repro_torch.core.scheduler import SCHEDULING_OVERHEAD_MS, TaskScheduler
from repro_torch.core.tenancy import Tenant


@dataclass
class RequestMetrics:
    """Per-request timing: submit/finish, communication, cache hits, and
    pure service time. ``arrival_ms`` (open-loop runs) is when the request
    entered the system; None means closed-loop, where arrival == submit."""
    request_id: int
    submit_ms: float
    finish_ms: float
    comm_ms: float
    cache_hits: int
    stages: int
    service_ms: float = 0.0     # pure execution + comm time, no queueing
    arrival_ms: Optional[float] = None   # open-loop arrival (None: = submit)
    retries: int = 0            # fault-mode re-dispatch attempts consumed
    hedges: int = 0             # fault-mode hedged duplicates spawned
    status: int = 0             # 0 done / 1 shed / 2 failed (core.faults)
    exit_head: int = -1         # layer id of the early-exit head that
                                # terminated this request (-1: ran to tail)

    @property
    def latency_ms(self) -> float:
        """End-to-end latency including queueing (finish - submit)."""
        return self.finish_ms - self.submit_ms

    @property
    def sojourn_ms(self) -> float:
        """Time in system (finish - arrival): the open-loop SLO metric,
        including admission-queue wait. Equals :attr:`latency_ms` for
        closed-loop requests."""
        arrival = self.arrival_ms if self.arrival_ms is not None else self.submit_ms
        return self.finish_ms - arrival


class RequestColumns:
    """Preallocated numpy per-request metric columns.

    The seed grew a Python list of ``RequestMetrics`` objects per run —
    ~200 bytes and an allocation per request, which dominates at 100k+
    request streams. The engine writes six flat columns instead; the
    object view is materialized lazily only if a caller actually asks for
    ``RunReport.requests``.
    """

    __slots__ = ("submit_ms", "finish_ms", "comm_ms", "service_ms",
                 "cache_hits", "stages", "arrival_ms", "retries", "hedges",
                 "status", "exit_head")

    def __init__(self, n: int):
        self.submit_ms = np.zeros(n, dtype=np.float64)
        self.finish_ms = np.zeros(n, dtype=np.float64)
        self.comm_ms = np.zeros(n, dtype=np.float64)
        self.service_ms = np.zeros(n, dtype=np.float64)
        self.cache_hits = np.zeros(n, dtype=np.int64)
        self.stages = np.zeros(n, dtype=np.int64)
        self.arrival_ms = np.zeros(n, dtype=np.float64)
        # fault-lifecycle columns (core.faults); all-zero on fault-free
        # runs, so adding them cannot drift any pre-fault metric
        self.retries = np.zeros(n, dtype=np.int64)
        self.hedges = np.zeros(n, dtype=np.int64)
        self.status = np.zeros(n, dtype=np.int64)
        # early-exit head (operator DAGs): layer id the request exited at,
        # -1 when it ran to the tail — all -1 on chain plans
        self.exit_head = np.full(n, -1, dtype=np.int64)

    def __len__(self) -> int:
        return len(self.submit_ms)

    def head(self, m: int) -> "RequestColumns":
        """Column view of the first ``m`` requests — used to trim a
        cascade escalation target (its arrivals are injected by the cheap
        tenant's misses, so only a prefix of its capacity is populated)."""
        assert 0 < m <= len(self), (m, len(self))
        out = RequestColumns.__new__(RequestColumns)
        for f in self.__slots__:
            setattr(out, f, getattr(self, f)[:m])
        return out

    @property
    def sojourn_ms(self) -> np.ndarray:
        """Per-request time in system (finish - arrival), admission-queue
        wait included — the open-loop SLO column. For closed-loop runs
        arrival == submit, so this equals queueing latency."""
        return self.finish_ms - self.arrival_ms

    def deadline_met(self, deadline_ms: float) -> np.ndarray:
        """Per-request SLO flag: sojourn within ``deadline_ms`` *and*
        the request actually completed (shed/failed requests never count
        toward goodput; on fault-free runs every status is 0, keeping
        this bit-identical to the pre-fault predicate)."""
        return (self.sojourn_ms <= deadline_ms) & (self.status == 0)

    def bitwise_equal(self, other: "RequestColumns") -> bool:
        """Exact (bit-for-bit, no tolerance) equality of every column —
        the differential-parity predicate used by the engine-parity suite
        and the events-per-second benchmark to compare a fast-core run
        against the heap oracle. NaN-free by construction (columns hold
        simulated times/counters), so ``array_equal`` is exact equality."""
        if len(self) != len(other):
            return False
        return all(np.array_equal(getattr(self, f), getattr(other, f))
                   for f in self.__slots__)

    @classmethod
    def from_requests(cls, requests: Sequence[RequestMetrics]
                      ) -> "RequestColumns":
        """Column view of an existing ``RequestMetrics`` list (bridges the
        legacy loop / task-parallel constructors into the vectorized
        report path)."""
        cols = cls(len(requests))
        for i, r in enumerate(requests):
            cols.submit_ms[i] = r.submit_ms
            cols.finish_ms[i] = r.finish_ms
            cols.comm_ms[i] = r.comm_ms
            cols.service_ms[i] = r.service_ms
            cols.cache_hits[i] = r.cache_hits
            cols.stages[i] = r.stages
            cols.arrival_ms[i] = (r.arrival_ms if r.arrival_ms is not None
                                  else r.submit_ms)
            cols.retries[i] = r.retries
            cols.hedges[i] = r.hedges
            cols.status[i] = r.status
            cols.exit_head[i] = r.exit_head
        return cols

    def materialize(self) -> List[RequestMetrics]:
        """Expand the columns back into per-request objects (lazy; only on
        explicit ``RunReport.requests`` access)."""
        return [RequestMetrics(i, float(self.submit_ms[i]),
                               float(self.finish_ms[i]),
                               float(self.comm_ms[i]),
                               int(self.cache_hits[i]), int(self.stages[i]),
                               float(self.service_ms[i]),
                               float(self.arrival_ms[i]),
                               int(self.retries[i]), int(self.hedges[i]),
                               int(self.status[i]), int(self.exit_head[i]))
                for i in range(len(self.submit_ms))]


class RunReport:
    """Aggregate metrics of one request-stream run (the paper's Table I
    columns, plus adaptation events when a controller is attached).

    Backed either by preallocated :class:`RequestColumns` (the engine path;
    aggregates are vectorized numpy reductions) or by a ``RequestMetrics``
    list (the legacy loop and task-parallel constructors). Both views are
    always available: ``columns`` / ``requests`` convert lazily.
    """

    def __init__(self, name: str,
                 requests: Optional[List[RequestMetrics]] = None,
                 columns: Optional[RequestColumns] = None,
                 network_bytes: float = 0.0,
                 scheduling_overhead_ms: float = 0.0,
                 monitor_overhead_pct: float = 0.0,
                 stability: float = 0.0, mem_used_mb: float = 0.0,
                 cpu_pct: float = 0.0, cache_stats: Optional[dict] = None,
                 adaptation: Optional[dict] = None,
                 queue_depth: Optional[tuple] = None,
                 fabric_stats: Optional[dict] = None,
                 batch_hist: Optional[dict] = None,
                 fault_stats: Optional[dict] = None):
        assert requests is not None or columns is not None
        self.name = name
        self._requests = requests
        self._columns = columns
        self.network_bytes = network_bytes
        self.scheduling_overhead_ms = scheduling_overhead_ms
        self.monitor_overhead_pct = monitor_overhead_pct
        self.stability = stability
        self.mem_used_mb = mem_used_mb
        self.cpu_pct = cpu_pct
        self.cache_stats = cache_stats
        self.adaptation = adaptation   # AdaptationController.summary()
        #: (times_ms, in_system) arrays sampled at engine poll ticks —
        #: requests arrived-but-unfinished, admission queue included
        self.queue_depth = queue_depth
        self.fabric_stats = fabric_stats   # FairShareFabric.stats()
        self.batch_hist = batch_hist       # micro-batch size -> count
        #: fault-mode lifecycle counters (``core.faults``): injected
        #: fault counts, retries/hedges/shed/failed, availability —
        #: None on fault-free runs
        self.fault_stats = fault_stats

    @property
    def requests(self) -> List[RequestMetrics]:
        """Per-request metric objects (materialized lazily from the numpy
        columns on first access)."""
        if self._requests is None:
            self._requests = self._columns.materialize()
        return self._requests

    @property
    def columns(self) -> RequestColumns:
        """Numpy column view of the per-request metrics (built lazily from
        the object list for legacy-constructed reports)."""
        if self._columns is None:
            self._columns = RequestColumns.from_requests(self._requests)
        return self._columns

    @property
    def avg_latency_ms(self) -> float:
        """Mean end-to-end latency (includes queueing)."""
        c = self.columns
        return float(np.mean(c.finish_ms - c.submit_ms))

    @property
    def avg_service_ms(self) -> float:
        """Mean pure service time (execution + communication only)."""
        return float(np.mean(self.columns.service_ms))

    @property
    def p99_latency_ms(self) -> float:
        """99th-percentile end-to-end latency."""
        c = self.columns
        lats = np.sort(c.finish_ms - c.submit_ms)
        return float(lats[min(len(lats) - 1, int(0.99 * len(lats)))])

    @property
    def throughput_rps(self) -> float:
        """Requests per second over the run's makespan."""
        c = self.columns
        makespan = float(c.finish_ms.max() - c.submit_ms.min())
        return 1000.0 * len(c) / max(makespan, 1e-9)

    @property
    def steady_latency_ms(self) -> float:
        """Inverse-throughput latency (bottleneck stage in steady state)."""
        return 1000.0 / self.throughput_rps

    def tail_throughput_rps(self, skip_frac: float = 0.5) -> float:
        """Steady-state throughput: completion rate over the stream's tail,
        after the first ``skip_frac`` of finishes.

        The makespan-based :attr:`throughput_rps` includes the pipeline-fill
        ramp, which penalizes configurations that trade fill latency for
        steady-state rate (micro-batching fills k-deep before the first
        finish). This is the metric the engine's overlap/micro-batch
        comparisons are judged on. Streams too short to have a tail
        (< 3 requests) fall back to the makespan metric."""
        f = np.sort(self.columns.finish_ms)
        if len(f) < 3:
            return self.throughput_rps
        k = min(len(f) - 2, int(len(f) * skip_frac))
        span = float(f[-1] - f[k])
        return 1000.0 * (len(f) - 1 - k) / max(span, 1e-9)

    @property
    def avg_comm_ms(self) -> float:
        """Mean per-request boundary-transfer time."""
        return float(np.mean(self.columns.comm_ms))

    # --- open-loop / SLO metrics ---------------------------------------------

    @property
    def offered_load_rps(self) -> float:
        """Arrival rate actually offered to the system: requests per second
        over the arrival span. Independent of what the cluster served —
        compare against :meth:`goodput_rps` to see the overload gap."""
        a = self.columns.arrival_ms
        span = float(a.max() - a.min())
        return 1000.0 * len(a) / max(span, 1e-9)

    def sojourn_percentile_ms(self, q: float) -> float:
        """``q``-th percentile (0-100) of per-request sojourn time
        (finish - arrival, admission wait included) via the same
        sorted-index convention as :attr:`p99_latency_ms`."""
        s = np.sort(self.columns.sojourn_ms)
        return float(s[min(len(s) - 1, int(q / 100.0 * len(s)))])

    @property
    def p50_sojourn_ms(self) -> float:
        """Median sojourn time."""
        return self.sojourn_percentile_ms(50.0)

    @property
    def p99_sojourn_ms(self) -> float:
        """99th-percentile sojourn time."""
        return self.sojourn_percentile_ms(99.0)

    @property
    def p999_sojourn_ms(self) -> float:
        """99.9th-percentile sojourn time (the SLO tail the paper's
        closed-loop averages cannot see)."""
        return self.sojourn_percentile_ms(99.9)

    def deadline_hit_rate(self, deadline_ms: float) -> float:
        """Fraction of requests whose sojourn met ``deadline_ms``."""
        return float(np.mean(self.columns.deadline_met(deadline_ms)))

    def goodput_rps(self, deadline_ms: float) -> float:
        """Deadline-meeting completions per second over the whole run
        (first arrival to last finish). Under overload this saturates —
        and then *falls* as queueing pushes sojourns past the deadline —
        while :attr:`offered_load_rps` keeps climbing; the gap between the
        two curves is the open-loop knee the benchmark sweeps."""
        c = self.columns
        span = float(c.finish_ms.max() - c.arrival_ms.min())
        hits = int(c.deadline_met(deadline_ms).sum())
        return 1000.0 * hits / max(span, 1e-9)

    # --- fault-lifecycle metrics (core.faults) --------------------------------

    @property
    def done_count(self) -> int:
        """Requests that completed successfully (status 0)."""
        return int(np.count_nonzero(self.columns.status == 0))

    @property
    def shed_count(self) -> int:
        """Requests shed by deadline-aware admission control (status 1)."""
        return int(np.count_nonzero(self.columns.status == 1))

    @property
    def failed_count(self) -> int:
        """Requests that exhausted their retries (status 2);
        ``fault_stats['failed_reasons']`` breaks these down by cause."""
        return int(np.count_nonzero(self.columns.status == 2))

    @property
    def availability(self) -> float:
        """Fraction of the stream that completed successfully —
        done / (done + shed + failed). 1.0 on fault-free runs."""
        return self.done_count / max(len(self.columns), 1)

    # --- early-exit metrics (operator DAGs) -----------------------------------

    def exit_counts(self) -> Dict[int, int]:
        """Request count per termination point: ``{exit_layer_id: count}``
        plus ``{-1: tail_count}``. Chain plans report everything under -1."""
        heads, counts = np.unique(self.columns.exit_head, return_counts=True)
        return {int(h): int(c) for h, c in zip(heads, counts)}

    def goodput_by_exit(self, deadline_ms: float) -> Dict[int, float]:
        """Per-exit-head goodput (deadline-meeting completions per second
        over the whole run's span), keyed like :meth:`exit_counts` — the
        early-exit accounting: how much of the served rate each head
        (and the tail, key -1) contributes."""
        c = self.columns
        span = max(float(c.finish_ms.max() - c.arrival_ms.min()), 1e-9)
        met = c.deadline_met(deadline_ms)
        return {int(h): 1000.0 * int(met[c.exit_head == h].sum()) / span
                for h in np.unique(c.exit_head)}

    @property
    def early_exit_rate(self) -> float:
        """Fraction of requests that terminated at an exit head."""
        return float(np.mean(self.columns.exit_head >= 0))

    def row(self) -> dict:
        """Flatten the report into one benchmark-table row. Fault-mode
        runs (``fault_stats`` set) append the lifecycle columns, and
        early-exit runs (any ``exit_head`` >= 0) append the per-head
        counts; the key set of chain/fault-free rows is unchanged, so
        committed benchmark baselines stay byte-identical."""
        fs = self.fault_stats
        extra = {} if fs is None else dict(
            done=self.done_count, shed=self.shed_count,
            failed=self.failed_count,
            retries=int(self.columns.retries.sum()),
            hedges=int(self.columns.hedges.sum()),
            availability=round(self.availability, 4),
        )
        if (self.columns.exit_head >= 0).any():
            extra["early_exit_rate"] = round(self.early_exit_rate, 4)
            for h, c in sorted(self.exit_counts().items()):
                extra[f"exit[{'tail' if h < 0 else h}]"] = c
        return dict(
            config=self.name,
            latency_ms=round(self.steady_latency_ms, 2),   # paper's metric
            service_ms=round(self.avg_service_ms, 2),
            queue_latency_ms=round(self.avg_latency_ms, 2),
            p99_ms=round(self.p99_latency_ms, 2),
            throughput_rps=round(self.throughput_rps, 3),
            comm_overhead_ms=round(self.avg_comm_ms, 2),
            network_mb=round(self.network_bytes / 1e6, 2),
            sched_overhead_ms=round(self.scheduling_overhead_ms, 2),
            monitor_cpu_pct=round(self.monitor_overhead_pct, 4),
            stability=round(self.stability, 3),
            mem_mb=round(self.mem_used_mb, 3),
            cpu_pct=round(self.cpu_pct, 4),
            **extra,
        )


class DistributedInference:
    """AMP4EC runtime: plan + placement + request pipeline."""

    def __init__(self, cluster: EdgeCluster, partitioner: ModelPartitioner,
                 num_partitions: Optional[int] = None,
                 use_cache: bool = False, opt_level: str = "none",
                 weights: Optional[Sequence[float]] = None,
                 refine: bool = False, method: str = "greedy",
                 executor: Optional[Callable] = None,
                 assignment: Optional[List[str]] = None,
                 batch: int = 1, adaptive: bool = False,
                 adaptation: Optional[AdaptationConfig] = None,
                 planner: Optional[PlannerConfig] = None,
                 tenant: Optional[Tenant] = None,
                 committed_ms: Optional[Dict[str, float]] = None,
                 expected_k: int = 1,
                 batch_model: Optional[BatchCostModel] = None,
                 nodes: Optional[Sequence[str]] = None):
        self.cluster = cluster
        self.partitioner = partitioner
        # optional placement closure: when set, planning, deployment, and
        # (through the AdaptationController) every future migration are
        # restricted to this node subset. This is what makes an adaptive
        # tenant shardable — the fast core can prove two tenants can never
        # touch the same node only if their closures are disjoint.
        if nodes is not None:
            known = set(cluster.nodes)
            unknown = set(nodes) - known
            assert not unknown, f"nodes= not in cluster: {sorted(unknown)}"
            self.allowed_nodes: Optional[frozenset] = frozenset(nodes)
        else:
            self.allowed_nodes = None
        # plan/placement ownership lives on the tenant (core.tenancy): a
        # solo pipeline gets an anonymous tenant, a registry-managed one
        # is handed the registry's Tenant object
        self.tenant = tenant if tenant is not None else Tenant("default")
        self.tenant.pipeline = self
        self.monitor = ResourceMonitor(cluster)
        self.scheduler = TaskScheduler()
        self.deployer = ModelDeployer(cluster, self.monitor, self.scheduler,
                                      opt_level, tenant=self.tenant.name)
        self.cache = ResultCache() if use_cache else None
        self.executor = executor
        self.batch = batch
        # batch-aware planning: the micro-batch size deploy-time planning
        # costs stages at, and the (optionally calibrated) cost model shared
        # by the planner, engine StageTable, and adaptation controller.
        # The defaults (k=1, analytic) reproduce the k=1 planner bit-for-bit.
        self.expected_k = max(int(expected_k), 1)
        self.batch_model = (batch_model if batch_model is not None
                            else ANALYTIC_BATCH_MODEL)
        self.committed_ms = committed_ms   # other tenants' node time budgets
        self._engine = None
        if planner is None:
            self.planner_cfg = PlannerConfig(max_stages=num_partitions)
        elif num_partitions is not None and planner.max_stages is None:
            # copy: never mutate a caller's (possibly shared) config object
            self.planner_cfg = dataclasses.replace(
                planner, max_stages=num_partitions)
        else:
            self.planner_cfg = planner
        if method == "planner":
            # joint boundaries + assignment from the DP planner; the same
            # config drives rebalance() and (unless an AdaptationConfig
            # overrides it) the AdaptationController's re-planning. With
            # committed_ms (a TenantRegistry deploy) the search plans
            # around the node time budgets earlier tenants already hold.
            assert assignment is None, \
                "method='planner' chooses the assignment; don't pass one"
            res = PartitionPlanner(partitioner.graph, self.planner_cfg,
                                   batch_model=self.batch_model).plan(
                self._filter_views(
                    node_views_from_cluster(cluster, self.scheduler)),
                batch=batch, calibration=partitioner.calibration,
                speedup=self.deployer.speedup,
                committed_ms=self.committed_ms,
                weight=self.tenant.traffic.weight,
                expected_k=self.expected_k)
            if res is None:
                raise RuntimeError("planner found no node with capacity")
            self.plan = partitioner.plan_from_cuts(res.cuts)
            assignment = res.assignment
        else:
            n = num_partitions or len(cluster.online_nodes())
            self.plan = partitioner.plan(n, weights=weights,
                                         refine=refine, method=method)
        if self.allowed_nodes is not None and assignment is not None:
            outside = set(assignment) - self.allowed_nodes
            assert not outside, \
                f"assignment leaves the nodes= closure: {sorted(outside)}"
        elif self.allowed_nodes is not None:
            # the NSA auto-placement path selects fleet-wide; a closure
            # only holds when the planner (or the caller) picks the nodes
            assert method == "planner", \
                "nodes= needs method='planner' or an explicit assignment"
        self.placement = self.deployer.deploy_plan(self.plan, assignment)
        if adaptation is None and adaptive:
            adaptation = AdaptationConfig(planner=self.planner_cfg)
        self.controller: Optional[AdaptationController] = (
            AdaptationController(self, adaptation) if adaptation is not None
            else None)
        self._verified = executor is None

    def _filter_views(self, views):
        """Restrict planner node views to the ``nodes=`` closure (identity
        when no closure was declared)."""
        if self.allowed_nodes is None:
            return views
        allowed = self.allowed_nodes
        kept = [v for v in views if v.node_id in allowed]
        assert kept, "nodes= closure has no plannable node"
        return kept

    # --- tenancy: plan ownership delegates to the Tenant ----------------------

    @property
    def plan(self):
        """The partition plan currently served — owned by the tenancy
        layer (``self.tenant``), so registries and arbiters see the same
        state this pipeline routes by."""
        return self.tenant.plan

    @plan.setter
    def plan(self, value):
        self.tenant.plan = value

    @property
    def placement(self) -> Dict[int, str]:
        """The stage->node placement currently served — tenant-owned,
        like :attr:`plan`."""
        return self.tenant.placement

    @placement.setter
    def placement(self, value: Dict[int, str]):
        self.tenant.placement = value

    # --- real-numerics verification -----------------------------------------

    def verify_numerics(self, x) -> bool:
        """Run input through partitions sequentially vs. monolithic once."""
        assert self.executor is not None
        y_mono, _ = self.executor(0, len(self.partitioner.graph.layers), x, None)
        h, res = x, None
        for part in self.plan.partitions:
            h, res = self.executor(part.lo, part.hi, h, res)
        # Port adaptation: the executor hands back torch tensors, which may
        # live on the card, where np.asarray raises. torch.allclose is the
        # same test as np.allclose(h, y_mono): |h - y| <= atol + rtol |y|.
        ok = torch.allclose(h, y_mono, rtol=1e-5, atol=1e-5)
        self._verified = True
        return ok

    def infer(self, x, signature=None):
        """Execute one real request through the deployed partitions (the
        executor path), serving stage outputs from the ``ResultCache`` when
        one is attached.

        Entries store the actual ``(activation, residual)`` stage outputs,
        so a repeated input skips the executor entirely for every cached
        stage — the fix for the seed's ``put(key, True)`` placeholder that
        could never serve real activations. ``signature``: optional stable
        token for the input pattern; memoizes the input digest (see
        ``cache.digest``).
        """
        assert self.executor is not None, "infer() needs an executor"
        # the digest exists only to key the cache; don't hash without one
        sig = (digest(x, signature=signature, memo=self.cache.digest_memo)
               if self.cache is not None else None)
        h, res = x, None
        for part in self.plan.partitions:
            key = None
            if self.cache is not None:
                key = self.cache.key(self.plan.graph_name,
                                     (part.lo, part.hi), sig)
                cached = self.cache.get(key)
                if cached is not None:
                    h, res = cached
                    continue
            h, res = self.executor(part.lo, part.hi, h, res)
            if self.cache is not None:
                self.cache.put(key, (h, res),
                               transfer_bytes=part.out_bytes * self.batch)
        return h

    # --- elasticity (beyond-paper: the paper fixes boundaries after deploy) ---

    def rebalance(self, method: str = "planner") -> None:
        """Re-partition for the *current* online nodes and redeploy.

        Addresses the paper's stated limitation (§V: "partition boundaries
        are fixed after deployment"). With ``method="planner"`` (default)
        the DP planner solves boundaries and assignment jointly; the legacy
        ``optimal``/``greedy`` methods recompute capability-weighted
        boundaries and place stage-i on the i-th most capable node.
        """
        if method == "planner":
            res = PartitionPlanner(self.partitioner.graph,
                                   self.planner_cfg,
                                   batch_model=self.batch_model).plan(
                node_views_from_cluster(self.cluster, self.scheduler),
                batch=self.batch, calibration=self.partitioner.calibration,
                speedup=self.deployer.speedup,
                committed_ms=self.committed_ms,
                weight=self.tenant.traffic.weight,
                expected_k=self.expected_k)
            if res is None:
                raise RuntimeError("planner found no node with capacity")
            plan, assignment = self.partitioner.plan_from_cuts(res.cuts), \
                res.assignment
        else:
            nodes = sorted(self.cluster.online_nodes(),
                           key=lambda n: -n.profile.cpu)
            weights = [n.profile.cpu for n in nodes]
            plan = self.partitioner.plan(len(nodes), weights=weights,
                                         method=method)
            assignment = [n.node_id for n in nodes]
        for i in list(self.deployer.deployments):
            self.deployer.undeploy(i)
        self.plan = plan
        self.placement = self.deployer.deploy_plan(self.plan, assignment)

    # --- request processing ----------------------------------------------------

    def _repair_placement(self) -> None:
        """Non-adaptive fallback when a placement node dies: redeploy its
        partitions (boundaries fixed — the paper's §V limitation)."""
        for nid in set(self.placement.values()):
            if not self.cluster.nodes[nid].online:
                self.deployer.handle_node_offline(nid)
        self.placement = self.deployer.assignment()

    def run(self, num_requests: int, name: str = "amp4ec",
            repeat_rate: float = 0.0, seed: int = 0,
            concurrency: int = 32,
            scenario: Optional[Sequence[ScenarioEvent]] = None,
            engine=None, arrivals=None) -> RunReport:
        """Process a request stream through the partition pipeline via the
        event engine (``core.engine``).

        The default stream is **closed-loop** (the paper's evaluation
        mode): ``concurrency`` requests in flight (the paper's "batches of
        32 inference requests"); request r is submitted when request r-W
        finishes, so reported latency is service latency, not unbounded
        queue wait. Passing ``arrivals`` (a ``core.traffic.ArrivalProcess``
        — deterministic-rate, Poisson, bursty on/off, or trace replay)
        switches to **open-loop** traffic: the process fixes every
        request's arrival time regardless of cluster state, and
        ``concurrency`` becomes the admission window metering arrivals
        into service (queueing beyond it shows up in sojourn time, not in
        a slower arrival clock). ``repeat_rate``: fraction of requests
        repeating an earlier input pattern (drives the +Cache
        configuration, mirroring the paper's identical request batches).
        ``scenario``: timed dynamic events (node death / recovery /
        throttle / latency spike); with an AdaptationController attached
        the closed loop re-partitions in response, otherwise only dead
        placements are repaired in place. ``engine``: optional
        ``EngineConfig``; the default reproduces the seed loop's timing
        bit-for-bit (see :meth:`run_legacy`), while ``transfer="overlap"``
        / ``micro_batch=k`` / ``fabric="shared"`` / ``adaptive_batch=True``
        enable DEFER-style transfer overlap, stage-level micro-batching,
        fair-shared link bandwidth, and queue-depth-driven batch sizing.
        """
        from repro_torch.core.engine import PipelineEngine
        if self._engine is None:
            self._engine = PipelineEngine(self)
        return self._engine.run(num_requests, name=name,
                                repeat_rate=repeat_rate, seed=seed,
                                concurrency=concurrency, scenario=scenario,
                                config=engine, arrivals=arrivals)

    def run_legacy(self, num_requests: int, name: str = "amp4ec",
                   repeat_rate: float = 0.0, seed: int = 0,
                   concurrency: int = 32,
                   scenario: Optional[Sequence[ScenarioEvent]] = None
                   ) -> RunReport:
        """The seed's serial per-request loop, kept verbatim as the parity
        oracle for the event engine (``tests/test_engine.py`` asserts the
        default engine configuration reproduces these per-request latencies
        bit-for-bit). Re-derives monitor/scheduler/cost-model state per
        request — O(requests × stages × layers) — so use :meth:`run` for
        anything beyond a few thousand requests.
        """
        assert self.partitioner.graph.is_chain, \
            "run_legacy walks stages linearly — DAG plans require run()"
        if self.controller is not None:
            self.controller.reset_rates()   # same contract as the engine
        rng = np.random.default_rng(seed)
        clock = self.cluster.clock
        pattern_pool = [f"pattern-{i}" for i in range(8)]
        reqs: List[RequestMetrics] = []
        total_net_bytes = 0.0
        sched_oh = 0.0
        finishes: List[float] = []
        pending_events = sorted(scenario or [], key=lambda e: e.at_ms)

        for r in range(num_requests):
            submit = clock.now_ms
            if r >= concurrency:
                submit = max(submit, finishes[r - concurrency])
            clock.now_ms = max(clock.now_ms, submit)
            while pending_events and pending_events[0].at_ms <= submit:
                apply_scenario_event(self.cluster, pending_events.pop(0))
            # per-request admission decision by the NSA (10 ms, Table I)
            stats = self.monitor.online_stats()
            self.scheduler.select_node(stats)  # admission / routing decision
            sched_oh += SCHEDULING_OVERHEAD_MS
            if self.controller is not None:
                self.controller.maybe_adapt()   # acts only on fresh polls
            # new requests route to the current plan; in-flight requests were
            # already charged against the plan they were submitted under
            if any(not self.cluster.nodes[nid].online
                   for nid in self.placement.values()):
                if self.controller is not None:
                    # a failed dispatch is an immediate drift signal — don't
                    # wait out the poll interval
                    self.controller.maybe_adapt(force_poll=True)
                else:
                    self._repair_placement()
            plan, placement = self.plan, self.placement
            t = submit + SCHEDULING_OVERHEAD_MS

            if repeat_rate > 0 and rng.random() < repeat_rate:
                sig = rng.choice(pattern_pool)
            else:
                sig = f"unique-{r}"

            comm = 0.0
            hits = 0
            service = SCHEDULING_OVERHEAD_MS
            for part in plan.partitions:
                node = self.cluster.nodes[placement[part.index]]
                key = None
                if self.cache is not None:
                    key = self.cache.key(plan.graph_name, (part.lo, part.hi), sig)
                    if self.cache.get(key) is not None:
                        hits += 1        # get() credits the saved bytes
                        continue  # skip compute + transfer
                ws = self.partitioner.working_set(part, batch=self.batch)
                rec = node.execute(self.cluster.clock, self.cluster.next_task_id(),
                                   part.cost * self.batch / self.deployer.speedup,
                                   working_set=ws, start_ms=t)
                # observed vs cost-model-predicted feeds the planner's
                # capability de-rating (identical by construction in the
                # simulator; a real backend reports measured wall time)
                pred = execution_ms(
                    part.cost * self.batch / self.deployer.speedup,
                    node.profile, ws)
                self.scheduler.task_completed(node.node_id, rec.exec_ms,
                                              predicted_ms=pred,
                                              tenant=self.tenant.name)
                service += rec.exec_ms
                t = rec.end_ms
                if part.index < len(plan.partitions) - 1:
                    nxt = self.cluster.nodes[placement[part.index + 1]]
                    tm = transfer_ms(part.out_bytes * self.batch, nxt.profile)
                    node.send(part.out_bytes * self.batch)
                    nxt.net_rx_bytes += part.out_bytes * self.batch
                    total_net_bytes += part.out_bytes * self.batch
                    comm += tm
                    service += tm
                    t += tm
                if self.cache is not None:
                    self.cache.put(key, (part.lo, part.hi),
                                   transfer_bytes=part.out_bytes * self.batch)
            reqs.append(RequestMetrics(r, submit, t, comm, hits,
                                       len(plan.partitions), service))
            finishes.append(t)

        clock.now_ms = max(clock.now_ms, max(r.finish_ms for r in reqs))
        # scenario events the request stream never reached still take effect
        # (e.g. a recovery scheduled past the last submit) so the cluster is
        # not silently left in a partial scenario state for later runs
        for ev in pending_events:
            apply_scenario_event(self.cluster, ev)
        stats = self.monitor.poll(force=True)
        online = [s for s in stats.values() if s.online]
        mem_mb = sum(s.mem_used_mb for s in online)
        cpu_pct = statistics.fmean(s.cpu_pct for s in online) if online else 0.0
        stability = statistics.fmean(s.stability for s in online) if online else 0.0
        return RunReport(
            name=name, requests=reqs, network_bytes=total_net_bytes,
            scheduling_overhead_ms=sched_oh / max(num_requests, 1),
            monitor_overhead_pct=self.monitor.cpu_overhead_pct(),
            stability=stability, mem_used_mb=mem_mb, cpu_pct=cpu_pct,
            cache_stats=self.cache.stats() if self.cache else None,
            adaptation=(self.controller.summary()
                        if self.controller is not None else None),
        )


def run_monolithic(cluster: EdgeCluster, partitioner: ModelPartitioner,
                   num_requests: int, batch: int = 1,
                   node_id: Optional[str] = None) -> RunReport:
    """Baseline: whole model on a single node, serial, single-threaded.

    An explicit ``node_id`` routes through ``deploy_plan`` (not a placement
    override), so the deployer's memory accounting and ``assignment()``
    agree with where the model actually runs.
    """
    d = DistributedInference(cluster, partitioner, num_partitions=1,
                             batch=batch,
                             assignment=[node_id] if node_id is not None
                             else None)
    rep = d.run(num_requests, name="monolithic")
    rep.scheduling_overhead_ms = 0.0  # baseline has no scheduler in the paper
    return rep


def run_task_parallel(cluster: EdgeCluster, partitioner: ModelPartitioner,
                      num_requests: int, name: str = "amp4ec-replicated",
                      concurrency: int = 32) -> RunReport:
    """AMP4EC task-level mode: full model replicated on every node; the NSA
    routes whole requests. The right regime when the model fits node memory
    (partitioning is for when it does not — paper §I); used by the
    adaptability/scalability experiments where nodes join and leave."""
    from repro_torch.core.cost_model import working_set_bytes
    from repro_torch.core.monitor import ResourceMonitor
    from repro_torch.core.scheduler import TaskScheduler, TaskRequirements

    monitor = ResourceMonitor(cluster)
    scheduler = TaskScheduler()
    graph = partitioner.graph
    total_cost = graph.total_cost
    nlayers = len(graph.layers)
    ws = working_set_bytes(graph, 0, nlayers)
    # deploy replicas
    params_b = sum(l.params for l in graph.layers) * 4
    for node in cluster.online_nodes():
        node.receive(params_b)
        node.mem_used_bytes += params_b

    reqs: List[RequestMetrics] = []
    finishes: List[float] = []
    pending: List[tuple] = []      # (finish_ms, node_id, exec_ms) in flight
    clock = cluster.clock
    for r in range(num_requests):
        submit = clock.now_ms
        if r >= concurrency:
            submit = max(submit, finishes[r - concurrency])
        # surface completions that happened before this submit (keeps the
        # scheduler's queue/active view consistent with simulated time)
        still = []
        for fin, nid, ems in pending:
            if fin <= submit:
                scheduler.task_completed(nid, ems)
                cluster.nodes[nid].active_tasks = max(
                    0, cluster.nodes[nid].active_tasks - 1)
            else:
                still.append((fin, nid, ems))
        pending = still
        clock.now_ms = max(clock.now_ms, submit)

        stats = monitor.poll(force=True)
        node_id = scheduler.select_node(
            [s for s in stats.values() if s.online], TaskRequirements())
        if node_id is None:                      # all nodes busy/overloaded
            node_id = min((n for n in cluster.online_nodes()),
                          key=lambda n: n.busy_until_ms).node_id
        node = cluster.nodes[node_id]
        node.active_tasks += 1
        rec = node.execute(clock, cluster.next_task_id(), total_cost,
                           working_set=ws, start_ms=submit + SCHEDULING_OVERHEAD_MS)
        pending.append((rec.end_ms, node_id, rec.exec_ms))
        reqs.append(RequestMetrics(r, submit, rec.end_ms, 0.0, 0, 1,
                                   rec.exec_ms + SCHEDULING_OVERHEAD_MS))
        finishes.append(rec.end_ms)

    clock.now_ms = max(clock.now_ms, max(f.finish_ms for f in reqs))
    stats = monitor.poll(force=True)
    online = [s for s in stats.values() if s.online]
    return RunReport(
        name=name, requests=reqs,
        network_bytes=params_b * len(online),
        scheduling_overhead_ms=SCHEDULING_OVERHEAD_MS,
        monitor_overhead_pct=monitor.cpu_overhead_pct(),
        stability=(statistics.fmean(s.stability for s in online) if online else 0.0),
        mem_used_mb=sum(s.mem_used_mb for s in online),
        cpu_pct=(statistics.fmean(s.cpu_pct for s in online) if online else 0.0),
    )
