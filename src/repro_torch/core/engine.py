"""Event-driven pipeline engine: heap scheduler + per-node FIFO queues.

The seed's request loop (kept as ``DistributedInference.run_legacy``)
re-polled the monitor, re-derived O(layers) working sets, and recomputed
cost-model predictions for every request × stage — a 100k-request stream
was untestable, so the paper's throughput claims could only be validated at
toy scale. This module replaces it with a discrete-event engine built for
100k-request × 50-node streams in single-digit seconds of wall time:

* **StageTable** — a per-(plan, placement, profiles) precomputed timing
  table: partition cost, cached working set, predicted ``execution_ms`` on
  the placed node, ``transfer_ms`` per boundary. Invalidated only on
  re-deploy / migration (plan or placement identity change) or a cluster
  mutation (``EdgeCluster.subscribe`` hook fires on ``set_profile`` /
  offline / recover / join) — never re-derived per request.
* **Poll-granular accounting** — the monitor snapshot, the NSA admission
  decision, and the scheduler's completion-history feedback run once per
  monitor poll interval instead of once per request; the paper's 10 ms
  scheduling overhead is still charged to every request (Table I).
* **Numpy metric columns** — per-request metrics land in preallocated
  ``RequestColumns`` instead of a growing object list.

Transfer policies (``EngineConfig.transfer``):

``legacy``
    The seed loop's accounting: a boundary transfer delays the request's
    arrival at the next stage but occupies no resource. With
    ``micro_batch=1`` this path reproduces the legacy loop's per-request
    latencies **bit-for-bit** (asserted by ``tests/test_engine.py``): stage
    trajectories are walked eagerly at submit, in submit order, with
    identical floating-point operations in identical order.
``serial``
    The naive single-threaded runtime DEFER (Parthasarathy &
    Krishnamachari, 2022) takes as its baseline: the sending node blocks
    until the boundary activation is delivered, so compute and transfer
    serialize on every node's timeline.
``overlap``
    DEFER-style pipelining: the finished activation is handed to the
    node's asynchronous transmit link (a FIFO channel — concurrent sends
    from one node queue behind each other) and the node immediately starts
    its next queued compute. Boundary transfer overlaps the sending node's
    next compute, which is where distributed edge-inference throughput
    actually comes from.

``micro_batch=k`` additionally coalesces up to k queued same-stage requests
into one execution, amortizing the fixed per-inference overhead
(``cost_model.FIXED_OVERHEAD_MS``) and the per-message network latency —
one k-sized activation message per boundary instead of k messages.
``adaptive_batch=True`` turns the static k into a cap driven by queue depth
(``core.traffic.adaptive_k``): short queues are served in small batches,
standing backlog unlocks deeper amortization.

Link contention (``EngineConfig.fabric``):

``isolated``
    The cost model's per-message charge: every transfer sees the whole
    link, no matter how many are in flight (the seed's accounting).
``shared``
    Progress-based fair sharing (``core.fabric.FairShareFabric``):
    concurrent transfers into one receiver split its downlink bandwidth,
    re-divided on every flow start/finish. A run in which no two flows
    ever overlap on a link is bit-for-bit identical to ``isolated``.
``maxmin``
    Dual-endpoint max-min fairness: every flow is constrained by both
    its sender's uplink and its receiver's downlink
    (``FairShareFabric(shared_uplinks=True)``); the overlap mode's tx
    FIFO gating is dropped, since the uplink itself now arbitrates
    concurrent sends. Solo flows keep isolated-accounting bit parity.

**Multi-tenant streams.** The event loop is written over *streams* — one
per tenant, each carrying its own plan tables, metric columns, RNG,
cache, and admission window (``_Stream``). A single-tenant run is
exactly one stream, so the tenancy generalization costs the solo path
nothing and cannot drift it; :class:`MultiTenantEngine` runs N tenants'
streams through one shared heap, interleaving their requests on shared
per-node FIFO queues and the shared fabric (``core.tenancy`` is the
user-facing layer). At poll ticks each tenant's controller sees the
other tenants' current per-node time budgets (``committed_ms``), and an
optional cross-tenant arbiter applies only the best-net-gain migration
per tick.

Request streams are **closed-loop** by default (request r submits when
r-W finishes — the paper's evaluation mode). Passing an
``ArrivalProcess`` (``core.traffic``) to :meth:`PipelineEngine.run`
switches to **open-loop** traffic: arrival times are fixed by the process
regardless of cluster state, ``concurrency`` becomes an admission window,
and the report gains SLO metrics (sojourn percentiles, goodput vs offered
load, queue-depth time series).

In the event-driven modes, scenario events and the adaptation controller
act at their *simulated* times (heap events, poll ticks) rather than at
request submit boundaries — see ``AdaptationController.on_engine_event``.
"""

from __future__ import annotations

import heapq
import itertools
import statistics
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.adaptation import ScenarioEvent, apply_scenario_event
from repro_torch.core.cost_model import (execution_ms_cached, link_rate_bits_per_ms,
                                   transfer_ms_cached)
from repro_torch.core.fabric import FairShareFabric
from repro_torch.core.faults import FaultConfig, account_stream_deaths
from repro_torch.core.monitor import POLL_INTERVAL_MS
from repro_torch.core.pipeline import RequestColumns, RunReport
from repro_torch.core.scheduler import SCHEDULING_OVERHEAD_MS
from repro_torch.core.traffic import ArrivalProcess, adaptive_k

#: transfer resource models, cheapest-semantics first (see module docstring)
TRANSFER_MODES = ("legacy", "serial", "overlap")

#: link-contention models: isolated per-message charge, fair-shared
#: receiver downlinks, or dual-endpoint (uplink + downlink) max-min
FABRIC_MODES = ("isolated", "shared", "maxmin")

# heap-event priorities: fixed tie-break order at equal simulated time.
# _P_XFER covers both fabric bandwidth-completion and delivery events;
# _P_ARRIVAL is an open-loop request reaching the admission queue.
(_P_SCENARIO, _P_POLL, _P_CDONE, _P_XFER, _P_SDONE, _P_ARRIVE,
 _P_ARRIVAL, _P_SUBMIT) = range(8)


@dataclass(frozen=True)
class EngineConfig:
    """Execution policy of one engine run.

    ``transfer``: one of :data:`TRANSFER_MODES`. ``micro_batch``: maximum
    queued same-stage requests coalesced into one execution (1 = off; an
    ``AdaptationController`` relieving sustained arrival overload may
    raise the effective cap mid-run via ``controller.batch_cap``).
    ``fabric``: one of :data:`FABRIC_MODES` — isolated per-message link
    charge, fair sharing of each receiver's downlink, or dual-endpoint
    (sender uplink + receiver downlink) max-min fairness.
    ``adaptive_batch``: cap each batch at ``traffic.adaptive_k`` of the
    served *stage's* queued backlog instead of always taking
    ``micro_batch`` (which then acts as the upper bound).
    The default configuration (``legacy``, 1, ``isolated``) reproduces the
    seed loop's per-request timing bit-for-bit.

    ``core`` selects the event-loop implementation: ``"fast"`` (default)
    is the time-wheel core (``core.fastcore``) with fused chains and
    columnar poll ticks; ``"heap"`` is the original heap loop, kept as
    the differential oracle — the two produce bit-identical results
    (``tests/test_engine_parity.py``). ``shards="auto"`` (the default)
    lets the fast core run reachable-disjoint tenant groups on
    independent wheels: controller-less groups free-run to completion
    (sampling series merge-extended to the fleet horizon afterwards),
    groups under adaptation controllers or a capacity arbiter run
    between epoch barriers with one fleet-wide poll tick — either way
    every report field stays bit-identical to the interleaved run.
    ``shard_workers > 1`` additionally forks that many worker processes
    for free-running groups. ``shards="none"`` is a debug escape hatch
    that pins the single interleaved wheel (useful when bisecting the
    sharded merge itself); it is never required for correctness.

    ``faults`` attaches a :class:`core.faults.FaultConfig`: seeded
    fault injection (crash/restart, transfer loss, execution failures,
    stragglers) plus the retry/timeout/hedge/shed lifecycle, handled by
    the shared ``core.faults.FaultRuntime`` in both cores. Requires the
    isolated fabric (the shared-fabric flow state has no loss/requeue
    semantics yet) and disables sharding and the eager fast path.
    """
    transfer: str = "legacy"
    micro_batch: int = 1
    fabric: str = "isolated"
    adaptive_batch: bool = False
    core: str = "fast"
    shards: str = "auto"
    shard_workers: int = 0
    faults: Optional[FaultConfig] = None

    def __post_init__(self):
        assert self.transfer in TRANSFER_MODES, self.transfer
        assert self.micro_batch >= 1, self.micro_batch
        assert self.fabric in FABRIC_MODES, self.fabric
        assert self.core in ("fast", "heap"), self.core
        assert self.shards in ("none", "auto"), self.shards
        assert self.shard_workers >= 0, self.shard_workers
        assert self.faults is None or self.fabric == "isolated", \
            "fault injection requires the isolated fabric"


class StageEntry:
    """One precomputed pipeline-stage row of a :class:`StageTable`:
    resolved node, execution/transfer times, boundary bytes, and the cache
    key prefix — everything the per-request hot path needs, derived once
    per table build instead of once per request."""

    __slots__ = ("index", "node", "exec_ms", "xfer_ms", "out_bytes",
                 "recv_node", "key_prefix", "cache_value", "next_index",
                 "pending_execs", "queued", "succs", "pred_count",
                 "exit_heads", "_part", "_table", "_exec_k",
                 "_xfer_k", "_curve")

    def __init__(self, table: "StageTable", part, node, recv_node):
        self.index = part.index
        self.node = node
        self.recv_node = recv_node            # None for the last stage
        self._part = part
        self._table = table
        ws = table.partitioner.working_set(part, table.batch)
        bm = table.batch_model
        # blended calibration curve for this stage's layer span; None keeps
        # the analytic fast path (and its exact float expressions) below
        self._curve = (None if bm.is_analytic else
                       bm.partition_curve(table.partitioner.graph,
                                          part.lo, part.hi))
        if self._curve is None:
            self.exec_ms = execution_ms_cached(
                part.cost * table.batch / table.speedup, node.profile, ws)
        else:
            self.exec_ms = bm.exec_ms(
                part.cost * table.batch / table.speedup, node.profile, ws,
                k=1, curve=self._curve)
        self.out_bytes = part.out_bytes * table.batch
        self.xfer_ms = (transfer_ms_cached(self.out_bytes, recv_node.profile)
                        if recv_node is not None else 0.0)
        self.key_prefix = (table.plan.graph_name, (part.lo, part.hi))
        # simulated-path cache payload: the stage descriptor (the executor
        # path stores real activations — see DistributedInference.infer)
        self.cache_value = (part.lo, part.hi)
        self.next_index = part.index + 1 if recv_node is not None else None
        self.pending_execs = 0                # scheduler feed since last poll
        self.queued = 0                       # this stage's queued backlog
        # DAG-plan fields, overwritten by StageTable for DAG tables; the
        # chain defaults keep every chain-path handler on its original code
        self.succs: Optional[tuple] = None    # outgoing EdgeEntry fan-out
        self.pred_count = 1                   # join arity (>1 == join stage)
        self.exit_heads: Optional[tuple] = None  # ((layer_id, prob), ...)
        self._exec_k: Dict[int, float] = {}
        self._xfer_k: Dict[int, float] = {}

    def exec_for(self, k: int) -> float:
        """Execution time of a k-request micro-batch of this stage on its
        node: k× the compute cost, one fixed per-inference overhead, memory
        pressure evaluated at the k-scaled working set."""
        if k == 1:
            return self.exec_ms
        v = self._exec_k.get(k)
        if v is None:
            t = self._table
            ws = t.partitioner.working_set(self._part, t.batch * k)
            if self._curve is None:
                v = execution_ms_cached(
                    self._part.cost * (t.batch * k) / t.speedup,
                    self.node.profile, ws)
            else:
                v = t.batch_model.exec_ms(
                    self._part.cost * t.batch / t.speedup,
                    self.node.profile, ws, k=k, curve=self._curve)
            self._exec_k[k] = v
        return v

    def xfer_for(self, k: int) -> float:
        """Boundary-transfer time of a k-request coalesced activation
        message (one per-message latency, k× the payload bytes)."""
        if k == 1:
            return self.xfer_ms
        v = self._xfer_k.get(k)
        if v is None:
            v = transfer_ms_cached(self.out_bytes * k,
                                   self.recv_node.profile)
            self._xfer_k[k] = v
        return v


class EdgeEntry:
    """One outgoing stage-DAG edge of a DAG :class:`StageEntry`: the
    successor stage index, the coalesced boundary payload, the receiving
    node, and the k=1 transfer time — the per-edge analogue of the chain
    entry's ``recv_node`` / ``out_bytes`` / ``xfer_ms`` triple."""

    __slots__ = ("next_index", "out_bytes", "recv_node", "xfer_ms",
                 "_xfer_k")

    def __init__(self, next_index: int, bytes_per_req: int, batch: int,
                 recv_node):
        self.next_index = next_index
        self.out_bytes = bytes_per_req * batch
        self.recv_node = recv_node
        self.xfer_ms = transfer_ms_cached(self.out_bytes, recv_node.profile)
        self._xfer_k: Dict[int, float] = {}

    def xfer_for(self, k: int) -> float:
        """Transfer time of a k-request coalesced message on this edge
        (one per-message latency, k× the payload bytes)."""
        if k == 1:
            return self.xfer_ms
        v = self._xfer_k.get(k)
        if v is None:
            v = transfer_ms_cached(self.out_bytes * k,
                                   self.recv_node.profile)
            self._xfer_k[k] = v
        return v


class StageTable:
    """Precomputed per-plan timing table: one :class:`StageEntry` per
    pipeline stage of (plan, placement) under the nodes' current profiles.

    Identity of the source ``plan`` / ``placement`` objects plus the
    cluster-mutation epoch define validity: the engine rebuilds the table
    only when a re-deploy, migration, or cluster event occurred. In-flight
    requests keep a reference to the table they were submitted under, so
    migrations drain naturally (the engine never re-reads mutated state
    mid-request — matching the legacy loop's submit-time plan capture).
    """

    def __init__(self, pipeline, epoch: int):
        self.plan = pipeline.plan
        self.placement_src = pipeline.placement
        self.epoch = epoch
        self.stream = None          # owning _Stream, stamped by the loop
        self.partitioner = pipeline.partitioner
        self.batch = pipeline.batch
        self.speedup = pipeline.deployer.speedup
        self.batch_model = pipeline.batch_model
        nodes = pipeline.cluster.nodes
        parts = self.plan.partitions
        last = len(parts) - 1
        self.stages: List[StageEntry] = [
            StageEntry(self, part, nodes[self.placement_src[part.index]],
                       (nodes[self.placement_src[part.index + 1]]
                        if part.index < last else None))
            for part in parts]
        #: True for linear plans — the fast core fuses only chain tables,
        #: and every DAG-only handler branch keys off ``succs is not None``
        self.chain = self.plan.stage_dag is None
        if not self.chain:
            dag = self.plan.stage_dag
            for st, edges, pc, heads in zip(self.stages, dag.succs,
                                            dag.pred_counts,
                                            dag.exit_heads):
                st.succs = tuple(
                    EdgeEntry(si, eb, self.batch,
                              nodes[self.placement_src[si]])
                    for si, eb in edges)
                st.pred_count = pc
                st.exit_heads = heads if heads else None


class PipelineEngine:
    """Discrete-event request-stream engine for one ``DistributedInference``
    pipeline.

    Owns the cached :class:`StageTable` (invalidated via the cluster's
    mutation hook plus plan/placement identity checks) and dispatches each
    :meth:`run` to the fast eager-walk path (legacy transfer semantics,
    bit-for-bit parity with ``run_legacy``) or the heap-based event loop
    (serial/overlap transfers, micro-batching).
    """

    def __init__(self, pipeline):
        self.pipe = pipeline
        self._table: Optional[StageTable] = None
        self._tables: List[StageTable] = []   # tables with unflushed feedback
        self._epoch = 0
        self._alive_src = None           # placement object the flag is for
        self._alive_epoch = -1
        self._alive = True
        # the cluster outlives pipelines: the listener holds the engine
        # weakly (a strong ref would keep the engine alive forever through
        # cluster._listeners), and a finalizer unsubscribes it promptly on
        # engine collection — the in-hook fallback covers a finalizer that
        # has not run yet, so mutation-free clusters don't accumulate hooks
        self_ref = weakref.ref(self)
        cluster = pipeline.cluster

        def _hook(kind: str, node_id: str) -> None:
            engine = self_ref()
            if engine is None:
                cluster.unsubscribe(_hook)
            else:
                engine._on_cluster_event(kind, node_id)

        cluster.subscribe(_hook)
        weakref.finalize(self, cluster.unsubscribe, _hook)

    # --- invalidation ---------------------------------------------------------

    def _on_cluster_event(self, kind: str, node_id: str) -> None:
        """Cluster mutation hook (``EdgeCluster.subscribe``): any join /
        offline / recover / profile change invalidates the cached stage
        table and the placement-liveness flag."""
        self._epoch += 1

    def _current_table(self) -> StageTable:
        p = self.pipe
        t = self._table
        if (t is None or t.epoch != self._epoch or t.plan is not p.plan
                or t.placement_src is not p.placement):
            t = self._table = StageTable(p, self._epoch)
            # superseded tables stay on the flush list: in the event path,
            # batches already queued under the old plan keep accruing
            # completion feedback on the old table's entries while they drain
            self._tables.append(t)
        return t

    def _placement_alive(self) -> bool:
        p = self.pipe
        placement = p.placement
        if placement is not self._alive_src or self._alive_epoch != self._epoch:
            nodes = p.cluster.nodes
            self._alive = all(nodes[nid].online for nid in placement.values())
            self._alive_src = placement
            self._alive_epoch = self._epoch
        return self._alive

    def _ensure_placement_alive(self, event_kind: str) -> None:
        """Shared dead-placement reaction for both engine paths: a failed
        dispatch is an immediate drift signal (force-poll the controller,
        or repair in place without one); if service is still down after
        that, fail loudly — the legacy loop does too, via
        ``EdgeNode.execute``'s online assert — rather than fabricate
        results on dead nodes."""
        if self._placement_alive():
            return
        controller = self.pipe.controller
        if controller is not None:
            controller.on_engine_event(event_kind, force_poll=True)
        else:
            self.pipe._repair_placement()
        if not self._placement_alive():
            raise RuntimeError(
                "placement includes an offline node and no "
                "migration/repair restored service")

    # --- amortized scheduler feedback ----------------------------------------

    def _flush_sched(self) -> None:
        """Fold the per-stage execution counts accumulated since the last
        poll into the scheduler's completion history (one
        ``bulk_complete`` per stage — the legacy loop's per-request
        ``task_completed`` signal at poll-interval granularity). Flushes
        every table that accrued feedback, in creation order: after a
        migration, in-flight work draining on the superseded plan still
        counts."""
        sched = self.pipe.scheduler
        tenant = self.pipe.tenant.name
        for table in self._tables:
            for st in table.stages:
                if st.pending_execs:
                    sched.bulk_complete(st.node.node_id, st.exec_ms,
                                        st.pending_execs,
                                        predicted_ms=st.exec_ms,
                                        tenant=tenant)
                    st.pending_execs = 0

    # --- entry point ----------------------------------------------------------

    def run(self, num_requests: int, name: str = "amp4ec",
            repeat_rate: float = 0.0, seed: int = 0, concurrency: int = 32,
            scenario: Optional[Sequence[ScenarioEvent]] = None,
            config: Optional[EngineConfig] = None,
            arrivals: Optional[ArrivalProcess] = None) -> RunReport:
        """Process a request stream (the pipeline's ``run`` contract)
        under ``config``; defaults to closed-loop submission and the
        bit-for-bit legacy timing model. ``arrivals`` switches to
        open-loop traffic through the event path (``concurrency`` becomes
        the admission window)."""
        assert num_requests > 0, "empty request stream"
        assert concurrency >= 1, "in-flight window must be >= 1"
        cfg = config or EngineConfig()
        if (arrivals is None and cfg.transfer == "legacy"
                and cfg.micro_batch == 1 and cfg.fabric == "isolated"
                and cfg.faults is None
                and self.pipe.partitioner.graph.is_chain):
            return self._run_fast(num_requests, name, repeat_rate, seed,
                                  concurrency, scenario)
        return self._run_events(num_requests, name, repeat_rate, seed,
                                concurrency, scenario, cfg, arrivals)

    # --- shared epilogue ------------------------------------------------------

    def _report(self, name: str, cols: RequestColumns, total_net: float,
                num_requests: int,
                leftover_events: Sequence[ScenarioEvent],
                queue_depth: Optional[tuple] = None,
                fabric_stats: Optional[dict] = None,
                batch_hist: Optional[dict] = None,
                fault_stats: Optional[dict] = None) -> RunReport:
        """Common end-of-run bookkeeping: advance the clock to the last
        finish, apply scenario events the stream never reached, then the
        per-stream tail (:meth:`_stream_report`). Single-stream epilogue;
        the multi-tenant runner applies the clock/scenario part once for
        all streams and calls ``_stream_report`` per tenant."""
        p = self.pipe
        clock = p.cluster.clock
        clock.now_ms = max(clock.now_ms, float(cols.finish_ms.max()))
        for ev in leftover_events:
            apply_scenario_event(p.cluster, ev)
        return self._stream_report(name, cols, total_net, queue_depth,
                                   fabric_stats, batch_hist, fault_stats)

    def _stream_report(self, name: str, cols: RequestColumns,
                       total_net: float,
                       queue_depth: Optional[tuple] = None,
                       fabric_stats: Optional[dict] = None,
                       batch_hist: Optional[dict] = None,
                       fault_stats: Optional[dict] = None) -> RunReport:
        """Per-stream tail of the run epilogue: flush the scheduler feed,
        prune drained stage tables, take the final forced poll, and
        aggregate the cluster-level Table-I columns (exactly the legacy
        loop's tail)."""
        p = self.pipe
        self._flush_sched()
        # every request has finished, so superseded tables are fully drained
        # and cannot accrue further feedback — prune them or a long-lived
        # engine accumulates one table per migration/cluster event forever
        self._tables = [t for t in self._tables if t is self._table]
        stats = p.monitor.poll(force=True)
        online = [s for s in stats.values() if s.online]
        return RunReport(
            name=name, columns=cols, network_bytes=total_net,
            # the 10 ms NSA charge is per request, so the per-request
            # average is the constant itself (num_requests > 0 asserted)
            scheduling_overhead_ms=SCHEDULING_OVERHEAD_MS,
            monitor_overhead_pct=p.monitor.cpu_overhead_pct(),
            stability=(statistics.fmean(s.stability for s in online)
                       if online else 0.0),
            mem_used_mb=sum(s.mem_used_mb for s in online),
            cpu_pct=(statistics.fmean(s.cpu_pct for s in online)
                     if online else 0.0),
            cache_stats=p.cache.stats() if p.cache else None,
            adaptation=(p.controller.summary()
                        if p.controller is not None else None),
            queue_depth=queue_depth, fabric_stats=fabric_stats,
            batch_hist=batch_hist, fault_stats=fault_stats,
        )

    # --- fast path: legacy transfer semantics, eager per-submit walk ----------

    def _run_fast(self, num_requests: int, name: str, repeat_rate: float,
                  seed: int, concurrency: int,
                  scenario: Optional[Sequence[ScenarioEvent]]) -> RunReport:
        """Eager stage walk in submit order — the legacy loop's exact
        semantics (transfers delay the request but occupy no resource;
        control decisions at submit boundaries) with the per-request
        monitor/scheduler/cost-model re-derivation hoisted into the cached
        :class:`StageTable` and poll-granular accounting."""
        p = self.pipe
        clock = p.cluster.clock
        monitor, scheduler, controller = p.monitor, p.scheduler, p.controller
        if controller is not None:
            controller.reset_rates()   # a new stream, fresh traffic state
        cache = p.cache
        rng = np.random.default_rng(seed)
        pattern_pool = [f"pattern-{i}" for i in range(8)]
        cols = RequestColumns(num_requests)
        submit_c, finish_c = cols.submit_ms, cols.finish_ms
        comm_c, service_c = cols.comm_ms, cols.service_ms
        hits_c, stages_c = cols.cache_hits, cols.stages
        arrival_c = cols.arrival_ms       # closed loop: arrival == submit
        total_net = 0.0
        pending_events = sorted(scenario or [], key=lambda e: e.at_ms)

        for r in range(num_requests):
            submit = clock.now_ms
            if r >= concurrency:
                prev = finish_c[r - concurrency]
                if prev > submit:
                    submit = prev
            if submit > clock.now_ms:
                clock.now_ms = submit
            while pending_events and pending_events[0].at_ms <= submit:
                apply_scenario_event(p.cluster, pending_events.pop(0))
            # monitor + NSA accounting at poll-interval granularity (the
            # 10 ms decision charge below stays per-request, Table I)
            if submit - monitor.last_poll_ms >= POLL_INTERVAL_MS:
                stats = monitor.online_stats()
                scheduler.select_node(stats)   # admission / routing refresh
                self._flush_sched()
            if controller is not None:
                controller.maybe_adapt()       # acts only on fresh polls
            self._ensure_placement_alive("dispatch-failed")
            table = self._current_table()
            stages = table.stages
            t = submit + SCHEDULING_OVERHEAD_MS

            if repeat_rate > 0 and rng.random() < repeat_rate:
                sig = rng.choice(pattern_pool)
            else:
                sig = f"unique-{r}"

            comm = 0.0
            hits = 0
            service = SCHEDULING_OVERHEAD_MS
            for st in stages:
                if cache is not None:
                    key = st.key_prefix + (sig,)
                    if cache.get(key) is not None:
                        hits += 1          # get() credits the saved bytes
                        continue           # skip compute + transfer
                node = st.node
                dur = st.exec_ms
                start = node.busy_until_ms
                if t > start:
                    start = t
                end = start + dur
                node.busy_until_ms = end
                node.cpu_busy_ms += dur
                node.task_count += 1
                node.recent_exec.append(dur)
                st.pending_execs += 1
                # end - start, not dur: the legacy loop charges
                # TaskRecord.exec_ms = (start + dur) - start, which differs
                # from dur in the last float bit once start is large
                service += end - start
                t = end
                recv = st.recv_node
                if recv is not None:
                    ob = st.out_bytes
                    node.net_tx_bytes += ob
                    recv.net_rx_bytes += ob
                    total_net += ob
                    tm = st.xfer_ms
                    comm += tm
                    service += tm
                    t = t + tm
                if cache is not None:
                    cache.put(key, st.cache_value, transfer_bytes=st.out_bytes)
            submit_c[r] = submit
            arrival_c[r] = submit
            finish_c[r] = t
            comm_c[r] = comm
            service_c[r] = service
            hits_c[r] = hits
            stages_c[r] = len(stages)

        return self._report(name, cols, total_net, num_requests,
                            pending_events)

    # --- event path: heap scheduler, per-node FIFO queues ---------------------

    def _run_events(self, num_requests: int, name: str, repeat_rate: float,
                    seed: int, concurrency: int,
                    scenario: Optional[Sequence[ScenarioEvent]],
                    cfg: EngineConfig,
                    arrivals: Optional[ArrivalProcess] = None) -> RunReport:
        """Heap-driven event loop for the serial/overlap transfer models,
        micro-batching, shared-bandwidth links, and open-loop arrivals —
        one :class:`_Stream` through the shared multi-tenant loop
        (:func:`_run_event_streams`), so single-tenant and interleaved
        multi-tenant runs execute the identical code path.

        With ``arrivals`` set the stream is open-loop: every request's
        arrival time is fixed by the process up front, ``concurrency``
        becomes an admission window (at most W requests in service;
        arrivals beyond it wait in a FIFO admission queue, visible as
        sojourn time), and the controller is fed arrival-rate vs
        completion-rate observations at every poll tick (the overload
        drift trigger)."""
        stream = _Stream(self, num_requests, name, repeat_rate, seed,
                         concurrency, arrivals)
        leftover, fabric = _dispatch_streams(self.pipe.cluster, [stream],
                                             cfg, scenario)
        return self._report(
            name, stream.cols, stream.total_net, num_requests, leftover,
            queue_depth=(np.asarray(stream.qd_t, dtype=np.float64),
                         np.asarray(stream.qd_n, dtype=np.int64)),
            fabric_stats=fabric.stats() if fabric is not None else None,
            batch_hist=dict(sorted(stream.bhist.items())),
            fault_stats=stream.fstats)


class _Stream:
    """Per-tenant run state inside the shared event loop: the tenant's
    engine (stage-table cache + invalidation), metric columns, RNG,
    signature pool, admission window, and rate-observation bookkeeping.
    A single-tenant run is exactly one stream; the multi-tenant loop is
    the same code over N of them."""

    __slots__ = ("engine", "pipe", "name", "n", "repeat_rate", "concurrency",
                 "arrivals", "controller", "monitor", "scheduler", "cache",
                 "tenant_name", "seed", "rng", "pattern_pool", "cols", "comm",
                 "service", "hits", "sigs", "total_net", "done", "arrived",
                 "in_flight", "admit_q", "at_arr", "qd_t", "qd_n", "bhist",
                 "last_rate_t", "last_arr", "last_done", "fstats", "joins",
                 "escalate_to", "dynamic", "next_r")

    def __init__(self, engine: "PipelineEngine", n: int, name: str,
                 repeat_rate: float, seed: int, concurrency: int,
                 arrivals: Optional[ArrivalProcess]):
        assert n > 0, "empty request stream"
        assert concurrency >= 1, "in-flight window must be >= 1"
        self.engine = engine
        p = engine.pipe
        self.pipe = p
        self.name = name
        self.n = n
        self.repeat_rate = repeat_rate
        self.concurrency = concurrency
        self.arrivals = arrivals
        self.controller = p.controller
        self.monitor = p.monitor
        self.scheduler = p.scheduler
        self.cache = p.cache
        self.tenant_name = p.tenant.name
        self.seed = seed             # exit-head draws key off the raw seed
        self.rng = np.random.default_rng(seed)
        self.pattern_pool = [f"pattern-{i}" for i in range(8)]
        self.cols = RequestColumns(n)
        self.comm = [0.0] * n
        self.service = [0.0] * n
        self.hits = [0] * n
        self.sigs: List[Optional[str]] = [None] * n
        self.total_net = 0.0
        self.done = 0
        self.arrived = 0             # requests that entered the system
        self.in_flight = 0           # open-loop: admitted, not yet finished
        self.admit_q: deque = deque()
        self.at_arr: Optional[list] = None   # open-loop arrival times
        self.qd_t: List[float] = []  # queue-depth series (poll-tick samples)
        self.qd_n: List[int] = []
        self.bhist: Dict[int, int] = {}      # micro-batch size -> executions
        self.last_rate_t = 0.0
        self.last_arr = 0
        self.last_done = 0
        #: fault-lifecycle counters (``RunReport.fault_stats``): set by
        #: ``FaultRuntime.finalize`` in fault mode, or by the cores'
        #: death-accounting epilogue; None on fault-free clean runs
        self.fstats: Optional[dict] = None
        # DAG/cascade state: in-flight join counters keyed (stage, r); a
        # cascade source's target stream; whether this stream is itself a
        # cascade target (fed by escalation, not seeded submits) and how
        # many requests have been escalated into it so far
        self.joins: Dict[tuple, int] = {}
        self.escalate_to: Optional["_Stream"] = None
        self.dynamic = False
        self.next_r = 0


def _committed_excluding(streams: Sequence["_Stream"],
                         me: "_Stream") -> Optional[Dict[str, float]]:
    """Per-node time budget of every stream's tenant except ``me`` —
    refreshed at poll ticks so mid-run re-planning sees the other
    tenants' *current* plans rather than a deploy-time snapshot. Thin
    wrapper over the tenancy layer's shared ``committed_budgets``."""
    from repro_torch.core.tenancy import committed_budgets
    return committed_budgets([s.pipe.tenant for s in streams],
                             exclude=me.pipe.tenant) or None


#: events dispatched by the most recent heap-oracle run
#: (``_run_event_streams``); the fast core keeps its own counter in
#: ``fastcore.LAST_EVENT_COUNT``, and a parity pair of runs reports equal
#: counts — fused chain steps are counted as the heap pops they replace
LAST_EVENT_COUNT = 0


def _exit_draw(seed: int, r: int, exit_heads) -> int:
    """Seeded per-request early-exit decision: walk the stage's exit
    heads in layer order drawing one uniform per (stream seed, request,
    head layer), return the first head whose draw lands under its exit
    probability, or -1 to continue. ``SeedSequence``-keyed so the outcome
    is a pure function of identity — independent of event order, core,
    micro-batching, or sharding (the exit-rate determinism property the
    DAG suite pins)."""
    for head, prob in exit_heads:
        u = np.random.SeedSequence((seed, r, head)).generate_state(1)[0]
        if u / 4294967296.0 < prob:
            return head
    return -1


def _check_dag_streams(streams: Sequence["_Stream"], cfg) -> None:
    """Reject engine features the DAG/cascade dataflow has no semantics
    for: shared-fabric flow state and the fault lifecycle are chain-only
    (their payloads carry single-successor routing), and the per-stage
    result cache cannot short-circuit across a join. Chain streams pass
    untouched, so this never constrains an existing configuration."""
    for s in streams:
        dag = not s.pipe.partitioner.graph.is_chain
        if not (dag or s.escalate_to is not None or s.dynamic):
            continue
        what = "a DAG plan" if dag else "a cascade stream"
        if cfg.fabric != "isolated":
            raise ValueError(f"{what} requires the isolated fabric")
        if cfg.faults is not None:
            raise ValueError(f"fault injection is not supported with {what}")
        if dag and s.cache is not None:
            raise ValueError("result caching is not supported on DAG plans")


def _dag_cdone(node, st, batch: List[int], t: float, mode: str, s,
               push, finish_request, try_start) -> None:
    """Completion continuation of a DAG stage (both cores dispatch here,
    so DAG runs are core-parity by construction): draw the stage's exit
    heads per request, finish early-exiters and — on a terminal stage —
    the survivors, then forward one coalesced message per outgoing edge
    under the run's transfer model. A join target releases only once all
    predecessor messages arrive (``route``'s pred-count gate)."""
    survivors = batch
    if st.exit_heads is not None:
        survivors = []
        for r in batch:
            h = _exit_draw(s.seed, r, st.exit_heads)
            if h >= 0:
                s.cols.exit_head[r] = h
                finish_request(s, r, t)
            else:
                survivors.append(r)
    ks = len(survivors)
    if not st.succs or ks == 0:
        node.engine_busy = False
        for r in survivors:
            finish_request(s, r, t)
        try_start(node, t)
        return
    tbl = st._table
    if mode == "serial":
        # synchronous sends: the node stays blocked while each edge's
        # message is delivered back-to-back (engine_busy clears at SDONE)
        tt = t
        for e in st.succs:
            ob = e.out_bytes * ks
            tm = e.xfer_for(ks)
            node.net_tx_bytes += ob
            e.recv_node.net_rx_bytes += ob
            s.total_net += ob
            for r in survivors:
                s.comm[r] += tm
                s.service[r] += tm
            tt = tt + tm
            push(tt, _P_ARRIVE, (tbl, e.next_index, list(survivors)))
        node.busy_until_ms = tt
        push(tt, _P_SDONE, node)
        return
    node.engine_busy = False
    if mode == "overlap":
        # async tx FIFO: the branch's messages queue behind each other on
        # the sender's link while the node starts its next compute
        sx = node.tx_free_ms
        if t > sx:
            sx = t
        for e in st.succs:
            ob = e.out_bytes * ks
            tm = e.xfer_for(ks)
            node.net_tx_bytes += ob
            e.recv_node.net_rx_bytes += ob
            s.total_net += ob
            for r in survivors:
                s.comm[r] += tm
                s.service[r] += tm
            push(sx + tm, _P_ARRIVE, (tbl, e.next_index, list(survivors)))
            sx = sx + tm
        node.tx_free_ms = sx
    else:                             # legacy: latency-only transfers
        for e in st.succs:
            ob = e.out_bytes * ks
            tm = e.xfer_for(ks)
            node.net_tx_bytes += ob
            e.recv_node.net_rx_bytes += ob
            s.total_net += ob
            for r in survivors:
                s.comm[r] += tm
                s.service[r] += tm
            push(t + tm, _P_ARRIVE, (tbl, e.next_index, list(survivors)))
    try_start(node, t)


def _trim_dynamic(streams: Sequence["_Stream"]) -> None:
    """Cut every cascade target's preallocated run state down to the
    requests actually escalated into it (its ``num_requests`` is a
    capacity, not a demand): metric columns, per-request accumulators,
    and the conservation target ``n`` all shrink to ``next_r``."""
    for s in streams:
        if not s.dynamic or s.next_r == s.n:
            continue
        if s.next_r == 0:
            raise RuntimeError(
                f"cascade target stream {s.name!r} received no escalated "
                "requests — every upstream request exited early")
        s.cols = s.cols.head(s.next_r)
        s.comm = s.comm[:s.next_r]
        s.service = s.service[:s.next_r]
        s.hits = s.hits[:s.next_r]
        s.sigs = s.sigs[:s.next_r]
        s.n = s.next_r


def _dispatch_streams(cluster, streams: Sequence["_Stream"],
                      cfg: EngineConfig,
                      scenario: Optional[Sequence[ScenarioEvent]],
                      arbiter=None):
    """Route a stream set to the configured event core: the time-wheel
    fast core (default) or the heap oracle. Lazy import — ``fastcore``
    imports this module at load time."""
    if cfg.core == "fast":
        from repro_torch.core import fastcore
        return fastcore.run_fast_streams(cluster, streams, cfg, scenario,
                                         arbiter)
    return _run_event_streams(cluster, streams, cfg, scenario,
                              arbiter=arbiter)


def _run_event_streams(cluster, streams: Sequence["_Stream"],
                       cfg: EngineConfig,
                       scenario: Optional[Sequence[ScenarioEvent]],
                       arbiter=None):
    """The shared heap event loop: explicit compute / transfer events,
    per-node FIFO work queues shared by every stream, and control
    (scenario events, monitor polls, adaptation) firing at simulated
    times. One stream is a plain single-tenant event run; several streams
    interleave their requests on the shared nodes and fabric while each
    keeps its own plan tables, cache, RNG, and admission window.

    Returns ``(leftover_scenario_events, fabric)``; per-stream results
    (metric columns, queue-depth series, batch histogram, total network
    bytes) land on the stream objects. With ``arbiter`` set (multi-tenant
    adaptive runs), control ticks route through the cross-tenant arbiter
    instead of each stream's own controller."""
    clock = cluster.clock
    mode = cfg.transfer
    kmax = cfg.micro_batch
    adaptive = cfg.adaptive_batch
    fabric = (FairShareFabric(shared_uplinks=cfg.fabric == "maxmin")
              if cfg.fabric in ("shared", "maxmin") else None)
    multi = len(streams) > 1
    _check_dag_streams(streams, cfg)
    for s in streams:
        if s.controller is not None:
            # fresh per-stream traffic state; the adaptive flag lets the
            # controller derive the expected micro-batch it re-plans at
            s.controller.begin_stream(kmax, adaptive=adaptive)
    done_total = 0
    # cascade targets submit only via escalation, which grows total_n as
    # misses arrive — their capacity n is not an up-front demand
    total_n = sum(s.n for s in streams if not s.dynamic)
    t0 = clock.now_ms
    heap: list = []
    seq = itertools.count()

    def _push(at: float, lane: int, pl) -> None:
        heapq.heappush(heap, (at, lane, next(seq), pl))

    for ev in sorted(scenario or [], key=lambda e: e.at_ms):
        heapq.heappush(heap, (max(ev.at_ms, t0), _P_SCENARIO,
                              next(seq), ev))
    heapq.heappush(heap, (t0, _P_POLL, next(seq), None))
    for s in streams:
        s.last_rate_t = t0
        if s.dynamic:
            continue
        if s.arrivals is None:
            for r in range(min(s.concurrency, s.n)):
                heapq.heappush(heap, (t0, _P_SUBMIT, next(seq), (s, r)))
        else:
            offs = np.asarray(s.arrivals.offsets(s.n), dtype=np.float64)
            assert len(offs) == s.n, (
                f"arrival process produced {len(offs)} offsets for "
                f"{s.n} requests")
            assert bool(np.all(np.diff(offs) >= 0)), \
                "arrival offsets must be non-decreasing"
            s.cols.arrival_ms[:] = t0 + offs
            s.at_arr = s.cols.arrival_ms.tolist()  # python floats, heap keys
            # arrivals are chained (each event pushes its successor), so the
            # heap holds one pending arrival per stream instead of all n —
            # the event count is unchanged but the heap stays depth-O(W)
            heapq.heappush(heap, (s.at_arr[0], _P_ARRIVAL, next(seq), (s, 0)))

    # ensure engine queue/busy state is clean for the placement nodes
    for node in cluster.nodes.values():
        node.pending.clear()
        node.engine_busy = False
        if node.tx_free_ms < t0:
            node.tx_free_ms = t0

    fr = None
    if cfg.faults is not None:
        from repro_torch.core.faults import FaultRuntime

        def _fault_push(at: float, lane: int, pl) -> None:
            heapq.heappush(heap, (at, lane, next(seq), pl))

        fr = FaultRuntime(cluster, streams, cfg, _fault_push,
                          arbiter=arbiter)
        fr.begin(t0)

    def try_start(node, now: float) -> None:
        # deliberately no node.online check: queued items were admitted
        # under a plan captured at their submit, and that cohort drains
        # on it even past a death event — the legacy loop computes these
        # same executions eagerly at submit time (new submits against a
        # dead, unrepaired placement raise in the SUBMIT handler)
        if node.engine_busy or not node.pending:
            return
        q = node.pending
        st, first = q[0]
        stream = st._table.stream
        ctrl = stream.controller
        km = kmax
        if (ctrl is not None and ctrl.batch_cap is not None
                and ctrl.batch_cap > km):
            km = ctrl.batch_cap     # overload relief raised the cap mid-run
        # per-STAGE backlog target: the adaptive cap follows this stage's
        # queued count, not the whole node queue — a node hosting two
        # tenants' stages no longer inflates one stage's batch because the
        # *other* stage has backlog (head-of-batch latency stays bounded)
        kcap = adaptive_k(st.queued, km) if adaptive else km
        q.popleft()
        st.queued -= 1
        batch = [first]
        while len(batch) < kcap and q and q[0][0] is st:
            batch.append(q.popleft()[1])
            st.queued -= 1
        k = len(batch)
        stream.bhist[k] = stream.bhist.get(k, 0) + 1
        start = node.busy_until_ms
        if now > start:
            start = now
        dur = st.exec_for(k)
        end = start + dur
        node.engine_busy = True
        node.busy_until_ms = end
        node.cpu_busy_ms += dur
        node.task_count += k
        tb = node.tenant_busy_ms
        tb[stream.tenant_name] = tb.get(stream.tenant_name, 0.0) + dur
        # per-request share, not the whole batch duration: the monitor's
        # stability heuristic flags executions > 2000 ms as saturation,
        # and a k-batch taking k× longer is not saturation — recording
        # the raw batch time would degrade capability (and trigger
        # spurious migrations) merely for enabling micro-batching
        node.recent_exec.append(dur if k == 1 else dur / k)
        st.pending_execs += k
        heapq.heappush(heap, (end, _P_CDONE, next(seq),
                              (node, st, batch, dur)))

    def finish_request(s: "_Stream", r: int, t: float) -> None:
        nonlocal done_total, total_n
        s.cols.finish_ms[r] = t
        s.done += 1
        done_total += 1
        tgt = s.escalate_to
        if tgt is not None and s.cols.exit_head[r] == -1:
            # cascade miss (reached the tail, no exit head fired):
            # escalate into the expensive tenant's stream as its next
            # request, submitted at this finish time
            nr = tgt.next_r
            assert nr < tgt.n, (
                f"cascade target {tgt.name!r} capacity {tgt.n} exceeded")
            tgt.next_r = nr + 1
            total_n += 1
            heapq.heappush(heap, (t, _P_SUBMIT, next(seq), (tgt, nr)))
        if s.arrivals is None:     # closed loop: r's finish submits r+W
            if not s.dynamic:      # cascade targets submit via escalation
                nxt = r + s.concurrency
                if nxt < s.n:
                    heapq.heappush(heap, (t, _P_SUBMIT, next(seq),
                                          (s, nxt)))
        else:                      # open loop: a slot frees; admit FIFO
            s.in_flight -= 1
            if s.admit_q:
                s.in_flight += 1
                heapq.heappush(heap, (t, _P_SUBMIT, next(seq),
                                      (s, s.admit_q.popleft())))

    def route(table: StageTable, idx: int, rs: List[int],
              t: float) -> None:
        """Deliver requests to stage ``idx`` of their stream's table:
        resolve cache-hit chains per request, then enqueue the remainder
        on the stage's node."""
        s = table.stream
        if s.cache is None:            # no per-request divergence: bulk
            st = table.stages[idx]
            if st.pred_count > 1:      # join: release on last arrival
                ready = []
                for r in rs:
                    key = (idx, r)
                    c = s.joins.get(key, 0) + 1
                    if c == st.pred_count:
                        del s.joins[key]
                        ready.append(r)
                    else:
                        s.joins[key] = c
                rs = ready
                if not rs:
                    return
            pend = st.node.pending
            for r in rs:
                pend.append((st, r))
            st.queued += len(rs)
            try_start(st.node, t)
            return
        touched = []                 # nodes to start, in enqueue order
        for r in rs:
            i: Optional[int] = idx
            while i is not None:
                st = table.stages[i]
                if s.cache.get(st.key_prefix + (s.sigs[r],)) is not None:
                    s.hits[r] += 1
                    i = st.next_index
                else:
                    break
            if i is None:            # every remaining stage was cached
                finish_request(s, r, t)
                continue
            st = table.stages[i]
            st.node.pending.append((st, r))
            st.queued += 1
            if st.node not in touched:
                touched.append(st.node)
        # start after the whole event is enqueued, not per request —
        # otherwise the first request of a forwarded micro-batch starts
        # solo on an idle node and the batch splits, paying the fixed
        # overhead twice merely because a cache is attached
        for node in touched:
            try_start(node, t)

    nev = 0
    deaths = False      # scenario "offline" seen (fault-free accounting)
    while heap and (done_total if fr is None else fr.terminated) < total_n:
        t, prio, _, payload = heapq.heappop(heap)
        nev += 1
        if t > clock.now_ms:
            clock.now_ms = t

        if fr is not None and prio != _P_POLL:
            # fault mode: the shared lifecycle runtime handles every
            # request-path event (poll ticks stay per-core — the compact
            # and object paths are already parity-proven)
            fr.dispatch(prio, t, payload)
            continue

        if prio == _P_SUBMIT:
            s, r = payload
            s.cols.submit_ms[r] = t
            if s.arrivals is None:
                s.arrived += 1
                s.cols.arrival_ms[r] = t   # closed loop: arrival == submit
            if s.repeat_rate > 0 and s.rng.random() < s.repeat_rate:
                s.sigs[r] = s.rng.choice(s.pattern_pool)
            else:
                s.sigs[r] = f"unique-{r}"
            s.service[r] = SCHEDULING_OVERHEAD_MS
            s.engine._ensure_placement_alive("dispatch-failed")
            table = s.engine._current_table()
            table.stream = s
            s.cols.stages[r] = len(table.stages)
            heapq.heappush(heap, (t + SCHEDULING_OVERHEAD_MS, _P_ARRIVE,
                                  next(seq), (table, 0, [r])))

        elif prio == _P_ARRIVAL:   # open loop: request enters the system
            s, r = payload
            s.arrived += 1
            if s.arrived < s.n:        # chain the stream's next arrival
                heapq.heappush(heap, (s.at_arr[s.arrived], _P_ARRIVAL,
                                      next(seq), (s, s.arrived)))
            if s.in_flight < s.concurrency:
                s.in_flight += 1
                heapq.heappush(heap, (t, _P_SUBMIT, next(seq), (s, r)))
            else:
                s.admit_q.append(r)

        elif prio == _P_ARRIVE:
            table, idx, rs = payload
            route(table, idx, rs, t)

        elif prio == _P_CDONE:
            node, st, batch, dur = payload
            s = st._table.stream
            k = len(batch)
            for r in batch:
                s.service[r] += dur
            if s.cache is not None:
                for r in batch:
                    s.cache.put(st.key_prefix + (s.sigs[r],), st.cache_value,
                                transfer_bytes=st.out_bytes)
            if st.succs is not None:   # DAG stage: exits, fan-out, joins
                _dag_cdone(node, st, batch, t, mode, s, _push,
                           finish_request, try_start)
                continue
            recv = st.recv_node
            if recv is None:
                node.engine_busy = False
                for r in batch:
                    finish_request(s, r, t)
                try_start(node, t)
            else:
                ob = st.out_bytes * k
                tm = st.xfer_for(k)
                node.net_tx_bytes += ob
                recv.net_rx_bytes += ob
                s.total_net += ob
                tbl = st._table
                if fabric is not None:
                    # shared fabric: the message becomes a flow on the
                    # receiver's downlink (and, in maxmin mode, the
                    # sender's uplink); wire time (and the sender's
                    # unblocking, in serial mode) resolves at delivery —
                    # comm/service are charged then, with the actual
                    # (possibly shared-bandwidth-stretched) elapsed time
                    fpay = (tbl, st.next_index, batch,
                            node if mode == "serial" else None)
                    if mode == "overlap":
                        node.engine_busy = False
                        if not fabric.shared_uplinks:
                            # the sender's tx FIFO still gates when a flow
                            # *starts* (solo duration as the occupancy
                            # estimate) — dropping it would let one node
                            # transmit several flows at full rate in
                            # parallel, making "shared" MORE optimistic
                            # than the isolated charge it tightens. In
                            # maxmin mode the uplink itself arbitrates, so
                            # flows start immediately.
                            sx = node.tx_free_ms
                            if t > sx:
                                sx = t
                            node.tx_free_ms = sx + tm
                            if sx > t:   # deferred flow start at tx-free
                                heapq.heappush(
                                    heap, (sx, _P_XFER, next(seq),
                                           ("fs", recv, ob, tm, fpay)))
                                try_start(node, t)
                                continue
                    elif mode != "serial":   # legacy: no sender resource
                        node.engine_busy = False
                    ver, nxt = fabric.start(
                        recv.node_id, link_rate_bits_per_ms(recv.profile),
                        ob * 8.0, tm, recv.profile.net_latency_ms,
                        fpay, t, sender_id=node.node_id,
                        sender_rate=link_rate_bits_per_ms(node.profile))
                    heapq.heappush(heap, (nxt, _P_XFER, next(seq),
                                          ("bw", recv.node_id, ver)))
                    if mode != "serial":
                        try_start(node, t)
                    continue
                for r in batch:
                    s.comm[r] += tm
                    s.service[r] += tm
                if mode == "overlap":
                    # async tx link: node frees now, sends FIFO-queue
                    node.engine_busy = False
                    sx = node.tx_free_ms
                    if t > sx:
                        sx = t
                    node.tx_free_ms = sx + tm
                    heapq.heappush(heap, (sx + tm, _P_ARRIVE, next(seq),
                                          (tbl, st.next_index, batch)))
                    try_start(node, t)
                elif mode == "serial":
                    # synchronous send: the node is blocked until the
                    # activation is delivered (the DEFER-less baseline)
                    node.busy_until_ms = t + tm
                    heapq.heappush(heap, (t + tm, _P_SDONE, next(seq),
                                          node))
                    heapq.heappush(heap, (t + tm, _P_ARRIVE, next(seq),
                                          (tbl, st.next_index, batch)))
                else:                 # legacy: latency-only transfer
                    node.engine_busy = False
                    heapq.heappush(heap, (t + tm, _P_ARRIVE, next(seq),
                                          (tbl, st.next_index, batch)))
                    try_start(node, t)

        elif prio == _P_XFER:        # shared-fabric link events
            if payload[0] == "bw":   # a link's bandwidth completion
                _, link_id, ver = payload
                res = fabric.on_event(link_id, ver, t)
                if res is not None:  # None: membership changed since
                    delivered, nxt = res
                    for fpayload, at, elapsed in delivered:
                        heapq.heappush(heap, (at, _P_XFER, next(seq),
                                              ("dl", fpayload, elapsed)))
                    if nxt is not None:
                        heapq.heappush(heap, (nxt[1], _P_XFER, next(seq),
                                              ("bw", link_id, nxt[0])))
            elif payload[0] == "fs":  # deferred flow start (tx freed)
                _, recv, ob, tm, fpay = payload
                ver, nxt = fabric.start(
                    recv.node_id, link_rate_bits_per_ms(recv.profile),
                    ob * 8.0, tm, recv.profile.net_latency_ms, fpay, t)
                heapq.heappush(heap, (nxt, _P_XFER, next(seq),
                                      ("bw", recv.node_id, ver)))
            else:                    # "dl": activation delivery
                _, (tbl, idx, batch, blocked), elapsed = payload
                s = tbl.stream
                for r in batch:
                    s.comm[r] += elapsed
                    s.service[r] += elapsed
                if blocked is not None:   # serial: unblock the sender
                    blocked.busy_until_ms = t
                    blocked.engine_busy = False
                    try_start(blocked, t)
                route(tbl, idx, batch, t)

        elif prio == _P_SDONE:
            node = payload
            node.engine_busy = False
            try_start(node, t)

        elif prio == _P_POLL:
            for s in streams:
                if t - s.monitor.last_poll_ms >= POLL_INTERVAL_MS:
                    stats = s.monitor.online_stats()
                    s.scheduler.select_node(stats)   # admission refresh
                    s.engine._flush_sched()
                s.qd_t.append(t)
                s.qd_n.append(s.arrived - s.done)  # in system, admit q incl.
                if s.controller is not None:
                    # observed backlog feeds the controller's expected-k
                    # estimate so re-planning costs stages at the batch
                    # size the engine is actually coalescing
                    s.controller.last_queue_depth = s.arrived - s.done
                if s.arrivals is not None and s.controller is not None:
                    # arrival-rate vs completion-rate over the poll window:
                    # the open-loop overload signal (closed-loop streams
                    # can't overload — submission backs off by construction)
                    window = t - s.last_rate_t
                    if window > 0:
                        s.controller.observe_rates(
                            1000.0 * (s.arrived - s.last_arr) / window,
                            1000.0 * (s.done - s.last_done) / window)
                        s.last_rate_t, s.last_arr, s.last_done = (
                            t, s.arrived, s.done)
            if multi:
                # refresh each tenant's view of the node-time budgets the
                # other tenants' plans hold right now, so re-planning is
                # tenancy-aware whether or not an arbiter is attached
                for s in streams:
                    if s.controller is not None:
                        s.pipe.committed_ms = _committed_excluding(
                            streams, s)
            if arbiter is not None:
                arbiter.on_engine_event("poll")
            else:
                for s in streams:
                    if s.controller is not None:
                        s.controller.on_engine_event("poll")
            # re-chain the poll only while some progress-capable event
            # remains (the heap is O(window)-small, so the scan is
            # cheap). Without this check the self-rechaining poll keeps
            # the heap non-empty forever and a stranded request would
            # spin the loop instead of reaching the conservation error
            # below.
            if any(pr not in (_P_POLL, _P_SCENARIO)
                   for _, pr, _, _ in heap):
                heapq.heappush(heap, (t + POLL_INTERVAL_MS, _P_POLL,
                                      next(seq), None))

        else:                          # _P_SCENARIO
            if payload.action == "offline":
                deaths = True
            apply_scenario_event(cluster, payload)
            dead = [s for s in streams
                    if not s.engine._placement_alive()]
            for s in dead:
                if s.controller is None:
                    s.pipe._repair_placement()
            if dead:
                if arbiter is not None:
                    arbiter.on_engine_event("scenario", force_poll=True)
                else:
                    for s in dead:
                        if s.controller is not None:
                            s.controller.on_engine_event("scenario",
                                                         force_poll=True)
                # no loud failure here: in-flight work may drain and a
                # later submit (or recovery event) retries via
                # _ensure_placement_alive before routing new requests

    _trim_dynamic(streams)
    if fr is not None:
        # fault mode: stranded requests are accounted (``stranded``
        # failures) and the done/shed/failed partition is asserted
        fr.finalize(clock.now_ms)
    else:
        # conservation: every request that arrived must have completed
        # (the engine drains in-flight and admission-queued work before
        # exiting) — unless a scenario death took nodes down with work
        # queued on them, in which case the stranded requests are
        # accounted as failed instead of crashing the whole run
        for s in streams:
            if s.done < s.n:
                if not deaths:
                    raise RuntimeError(
                        f"engine drained its event heap with {s.done}/"
                        f"{s.n} completions for stream {s.name!r} — "
                        f"{s.arrived - s.done} request(s) lost in flight")
                account_stream_deaths(s, clock.now_ms)

    global LAST_EVENT_COUNT
    LAST_EVENT_COUNT = nev

    # scenario events past the stream's end still take effect (fault-mode
    # crash/restart/timeout chains also ride this lane — skip them)
    leftover = sorted((pl for _, pr, _, pl in heap
                       if pr == _P_SCENARIO
                       and isinstance(pl, ScenarioEvent)),
                      key=lambda e: e.at_ms)
    for s in streams:
        s.cols.comm_ms[:] = s.comm
        s.cols.service_ms[:] = s.service
        s.cols.cache_hits[:] = s.hits
    return leftover, fabric


class MultiTenantEngine:
    """N tenants' streams through one shared event heap.

    Requests interleave on shared per-node FIFO queues and the shared
    fabric while each tenant keeps its own plan, stage tables, cache,
    RNG, and admission window. The loop body is the very code a
    single-tenant event run executes (:func:`_run_event_streams`), so
    the 1-tenant case is bit-for-bit today's engine; the user-facing
    entry point is ``core.tenancy.TenantRegistry.run``."""

    def __init__(self, cluster, tenants: Sequence):
        self.cluster = cluster
        self.tenants = list(tenants)
        assert self.tenants, "no tenants to run"

    def run(self, scenario: Optional[Sequence[ScenarioEvent]] = None,
            config: Optional[EngineConfig] = None, arbiter=None,
            name: str = "tenants") -> Dict[str, RunReport]:
        """Serve every tenant's stream (its ``TenantTraffic``) to
        completion under one shared ``config`` (the cluster-wide resource
        model: transfer/fabric/micro-batch policy); returns
        {tenant name: RunReport}. With ``arbiter`` set, adaptation runs
        through cross-tenant arbitration (one best-net-gain migration per
        control tick) instead of independent per-tenant controllers."""
        cfg = config or EngineConfig()
        streams = []
        for t in self.tenants:
            p = t.pipeline
            if p._engine is None:
                p._engine = PipelineEngine(p)
            tr = t.traffic
            streams.append(_Stream(p._engine, tr.num_requests,
                                   f"{name}/{t.name}", tr.repeat_rate,
                                   tr.seed, tr.concurrency, tr.arrivals))
        # model cascade: a tenant naming ``escalate_to`` feeds its misses
        # (requests that reached its plan's tail without an exit head
        # firing) into the target tenant's stream; the target becomes
        # dynamic — its num_requests is a capacity, demand is escalation
        by_name = {t.name: s for t, s in zip(self.tenants, streams)}
        for t, s in zip(self.tenants, streams):
            esc = t.traffic.escalate_to
            if esc is None:
                continue
            assert esc in by_name, f"unknown cascade target tenant {esc!r}"
            tgt = by_name[esc]
            assert tgt is not s, "tenant cannot escalate to itself"
            assert tgt.arrivals is None, \
                "cascade target must be closed-loop (no arrival process)"
            s.escalate_to = tgt
            tgt.dynamic = True
        for s in streams:
            if s.escalate_to is not None and not s.dynamic:
                assert s.escalate_to.n >= s.n, (
                    f"cascade target {s.escalate_to.name!r} capacity "
                    f"{s.escalate_to.n} < source demand {s.n}")
        leftover, fabric = _dispatch_streams(self.cluster, streams, cfg,
                                             scenario, arbiter=arbiter)
        clock = self.cluster.clock
        clock.now_ms = max([clock.now_ms]
                           + [float(s.cols.finish_ms.max())
                              for s in streams])
        for ev in leftover:
            apply_scenario_event(self.cluster, ev)
        fstats = fabric.stats() if fabric is not None else None
        return {t.name: s.engine._stream_report(
                    s.name, s.cols, s.total_net,
                    queue_depth=(np.asarray(s.qd_t, dtype=np.float64),
                                 np.asarray(s.qd_n, dtype=np.int64)),
                    # per-report copy: the fabric is shared, its stats
                    # dict must not be (mutating one tenant's report
                    # would silently edit every other's)
                    fabric_stats=dict(fstats) if fstats is not None
                    else None,
                    batch_hist=dict(sorted(s.bhist.items())),
                    fault_stats=s.fstats)
                for t, s in zip(self.tenants, streams)}
