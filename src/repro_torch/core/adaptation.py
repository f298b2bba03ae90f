"""Adaptation Controller: the closed monitor -> partitioner -> deployer loop.

The paper's central claim is *adaptivity* — real-time resource monitoring
feeding dynamic partitioning and scheduling — but a plan computed once at
deploy time is static. This module closes the loop at runtime:

  1. every fresh ``ResourceMonitor`` poll the controller checks for *drift*:
     a placement node offline, a stability drop, sustained load above
     threshold, a network-latency spike, a node's live capability deviating
     from the value the current plan assumed (CPU throttle / recovery /
     join), or cost-model miscalibration beyond a configurable band;
  2. on drift it recomputes capability weights from live ``NodeStats`` and
     asks ``ModelPartitioner.plan(..., method="optimal")`` for a candidate
     plan with stage i on the i-th most capable node;
  3. it migrates through ``ModelDeployer.migrate_plan`` only when the
     predicted bottleneck improvement (amortized over a request horizon)
     exceeds the migration cost — params_bytes transfer via
     ``cost_model.transfer_ms`` plus a per-moved-partition redeploy penalty.
     A dead placement node forces migration regardless (the service is down).

In-flight requests drain on the old plan (the pipeline captures plan +
placement per request at submit); new requests route to the new plan. Every
decision is an ``AdaptationEvent`` in ``controller.events``, surfaced via
``RunReport.adaptation``.

Dynamic scenarios (mid-run node death, CPU throttle to the paper's
0.4-CPU/512MB low-resource profile, latency spike, node recovery) are
expressed as ``ScenarioEvent``s the pipeline applies at submit boundaries.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.cluster import EdgeCluster
from repro_torch.core.monitor import (LATENCY_THRESHOLD_MS, NodeStats,
                                POLL_INTERVAL_MS)
from repro_torch.core.partitioner import Partition, PartitionPlan
from repro_torch.core.planner import (PartitionPlanner, PlannerConfig,
                                bottleneck_ms, node_views_from_stats)


@dataclass
class AdaptationConfig:
    """Tuning knobs for the closed loop: drift thresholds, migration
    economics, and the re-planning search configuration."""
    load_threshold: float = 0.8         # sustained current_load trigger
    sustained_polls: int = 3            # consecutive polls above threshold
    stability_threshold: float = 0.7    # stability drop trigger
    calibration_band: float = 0.25      # |calibration/planned - 1| beyond band
    capacity_band: float = 0.25         # live capability drift vs. plan-time
    latency_threshold_ms: float = LATENCY_THRESHOLD_MS  # latency-spike trigger
    #: open-loop overload: arrival rate > ratio × completion rate for
    #: ``sustained_polls`` consecutive engine polls (fed by observe_rates)
    overload_rate_ratio: float = 1.2
    amortize_requests: int = 32         # horizon the bottleneck gain pays over
    redeploy_penalty_ms: float = 25.0   # per-moved-partition restart cost
    min_gain_ratio: float = 1.0         # gain must exceed cost * ratio
    cooldown_ms: float = POLL_INTERVAL_MS  # between voluntary migrations
    #: stage-move budget for the partial-migration candidate ("move at most
    #: k stages", cuts kept): 0 disables the cheap candidate entirely
    partial_migration_k: int = 2
    #: overload relief ceiling: on a sustained ``arrival-overload`` drift
    #: the controller first doubles the engine's micro-batch cap (up to
    #: this limit) and only migrates if the overload persists after that
    batch_cap_limit: int = 32
    planner: PlannerConfig = field(default_factory=PlannerConfig)


@dataclass
class AdaptationEvent:
    """One timestamped control-loop decision (drift, migrate, or skip),
    surfaced via ``RunReport.adaptation``."""
    t_ms: float
    kind: str                  # drift | migrate | skip
    detail: str
    data: dict = field(default_factory=dict)

    def __str__(self) -> str:
        return f"[{self.t_ms:9.1f}ms] {self.kind:<7} {self.detail}"


@dataclass
class MigrationDecision:
    """Outcome of one drift evaluation: whether to migrate, the competing
    bottleneck predictions, and the candidate (plan, assignment) if any.
    ``partial`` marks the bounded "move at most k stages" candidate having
    won over a full re-plan (``moved_stages`` counts the re-homed
    stages)."""
    migrate: bool
    reason: str
    drifts: List[str]
    current_bottleneck_ms: float
    candidate_bottleneck_ms: float
    predicted_gain_ms: float           # amortized over the request horizon
    migration_cost_ms: float
    plan: Optional[PartitionPlan] = None
    assignment: Optional[List[str]] = None
    partial: bool = False
    moved_stages: int = 0


# --- dynamic scenario events -------------------------------------------------

@dataclass(frozen=True)
class ScenarioEvent:
    """A timed cluster mutation the pipeline applies at submit boundaries
    (the paper's dynamic-environment events, §I)."""
    at_ms: float
    action: str                        # offline | recover | profile
    node_id: str
    changes: Optional[dict] = None     # NodeProfile overrides for "profile"


def node_death(at_ms: float, node_id: str) -> ScenarioEvent:
    """Schedule ``node_id`` to go offline at ``at_ms``."""
    return ScenarioEvent(at_ms, "offline", node_id)


def node_recovery(at_ms: float, node_id: str) -> ScenarioEvent:
    """Schedule a previously-offline ``node_id`` to rejoin at ``at_ms``."""
    return ScenarioEvent(at_ms, "recover", node_id)


def cpu_throttle(at_ms: float, node_id: str, cpu: float = 0.4,
                 mem_mb: float = 512.0) -> ScenarioEvent:
    """Throttle to the paper's low-resource profile (0.4 CPU / 512 MB)."""
    return ScenarioEvent(at_ms, "profile", node_id, dict(cpu=cpu, mem_mb=mem_mb))


def latency_spike(at_ms: float, node_id: str,
                  net_latency_ms: float = 80.0) -> ScenarioEvent:
    """Schedule a network-latency spike on ``node_id`` at ``at_ms``."""
    return ScenarioEvent(at_ms, "profile", node_id,
                         dict(net_latency_ms=net_latency_ms))


def jitter_events(events: Sequence[ScenarioEvent], rng,
                  max_jitter_ms: float = 100.0) -> List[ScenarioEvent]:
    """Perturb each event's firing time by a uniform ±``max_jitter_ms``
    draw from the **caller-supplied** ``numpy.random.Generator`` — the
    project-wide explicit-RNG contract: no stochastic component reads
    global seed state, so a jittered scenario is exactly as reproducible
    as its (events, generator seed) inputs.

    The *original time order is preserved*: events are jittered in
    ascending-``at_ms`` order and each result is clamped to be no earlier
    than its predecessor (and never negative). Dependent pairs — a death
    followed by its recovery — therefore stay a death followed by a
    recovery; independent jitter with a re-sort would silently swap them
    and turn a transient outage into a permanent one."""
    out: List[ScenarioEvent] = []
    floor = 0.0
    for ev in sorted(events, key=lambda e: e.at_ms):
        at = max(floor, ev.at_ms + float(rng.uniform(-max_jitter_ms,
                                                     max_jitter_ms)))
        out.append(dataclasses.replace(ev, at_ms=at))
        floor = at
    return out


def apply_scenario_event(cluster: EdgeCluster, ev: ScenarioEvent) -> None:
    """Apply one ``ScenarioEvent`` to the cluster (offline / recover /
    profile mutation)."""
    if ev.action == "offline":
        cluster.remove_node(ev.node_id)
    elif ev.action == "recover":
        cluster.restore_node(ev.node_id)
    elif ev.action == "profile":
        cluster.set_profile(ev.node_id, **(ev.changes or {}))
    else:
        raise ValueError(f"unknown scenario action: {ev.action}")


# --- the controller ----------------------------------------------------------

class AdaptationController:
    """Closes the loop for one ``DistributedInference`` pipeline."""

    def __init__(self, pipeline, config: Optional[AdaptationConfig] = None):
        self.pipeline = pipeline
        self.cfg = config or AdaptationConfig()
        self.cluster: EdgeCluster = pipeline.cluster
        self.monitor = pipeline.monitor
        self.partitioner = pipeline.partitioner
        self.deployer = pipeline.deployer
        self.planner = PartitionPlanner(self.partitioner.graph,
                                        self.cfg.planner,
                                        batch_model=pipeline.batch_model)
        self.events: List[AdaptationEvent] = []
        self.migrations = 0
        self.decisions = 0
        self.engine_events: Dict[str, int] = {}   # on_engine_event kinds
        self._last_eval_ms = -math.inf
        self._last_migration_ms = -math.inf
        self._last_skipped_drifts: Optional[tuple] = None
        self._planned_calibration = self.partitioner.calibration
        self._planned_caps: Optional[Dict[str, float]] = None
        #: (offered_rps, completed_rps) per engine poll — open-loop runs
        #: only. Sized from sustained_polls so a slow-reacting config
        #: (sustained_polls > 32) can still accumulate enough consecutive
        #: windows for the arrival-overload drift to fire.
        self._rate_obs: deque = deque(maxlen=max(32, self.cfg.sustained_polls))
        #: overload-relief micro-batch cap: None until a sustained
        #: arrival-overload drift raises it; the engine reads it every
        #: batch formation (see PipelineEngine). Reset per stream.
        self.batch_cap: Optional[int] = None
        #: the engine run's static micro_batch — the base the relief
        #: doubles from (set by begin_stream at event-run start)
        self.stream_micro_batch = 1
        #: whether the running stream forms batches adaptively
        #: (``adaptive_k`` of queue depth) rather than always at the cap
        self.stream_adaptive = False
        #: last observed in-system backlog (engine poll ticks update this);
        #: feeds :meth:`expected_k` for adaptive streams
        self.last_queue_depth = 0

    def begin_stream(self, micro_batch: int, adaptive: bool = False) -> None:
        """Engine hook at event-run start: remember the stream's static
        micro-batch cap (the base the overload relief doubles from) and
        batching mode, and reset per-stream traffic state — rate
        observations, queue-depth signal, and any raised cap from a
        previous stream."""
        self.stream_micro_batch = micro_batch
        self.stream_adaptive = adaptive
        self.batch_cap = None
        self.last_queue_depth = 0
        self.reset_rates()

    def expected_k(self) -> int:
        """The micro-batch size re-planning should cost stages at: the
        effective cap (overload relief included) for fixed-k streams, or
        ``adaptive_k`` of the last observed backlog when the stream forms
        batches adaptively. This is the k the engine's batch formation
        will actually run the candidate plan at — using it in the DP keeps
        the planner's objective and the engine's behaviour in agreement."""
        from repro_torch.core.traffic import adaptive_k
        cap = self.batch_cap or self.stream_micro_batch
        if self.stream_adaptive:
            return adaptive_k(self.last_queue_depth, cap)
        return cap

    def observe_rates(self, offered_rps: float,
                      completed_rps: float) -> None:
        """Record one poll window's arrival rate vs completion rate (the
        open-loop engine calls this every poll tick). Sustained
        ``offered > overload_rate_ratio × completed`` becomes the
        ``arrival-overload`` drift — the signal a closed-loop stream can
        never produce, because its submission backs off with the service
        rate by construction."""
        self._rate_obs.append((offered_rps, completed_rps))

    def reset_rates(self) -> None:
        """Drop accumulated rate observations. The engine calls this at
        every stream start: each run is a fresh traffic experiment, and a
        previous stream's overload window must not keep the
        ``arrival-overload`` drift alive into the next run."""
        self._rate_obs.clear()

    def _closure_stats(self, stats: Dict[str, NodeStats]
                       ) -> Dict[str, NodeStats]:
        """Restrict telemetry to the pipeline's ``nodes=`` closure.

        Every controller input — drift detection, the planner candidates,
        the capacity baseline — runs on the filtered view, so a closed
        tenant can never observe (or migrate onto) a node outside its
        declared subset. That invariant is what lets the fast core shard
        adaptive tenants: disjoint closures prove disjoint reachable node
        sets. Identity when no closure was declared."""
        allowed = getattr(self.pipeline, "allowed_nodes", None)
        if allowed is None:
            return stats
        return {nid: s for nid, s in stats.items() if nid in allowed}

    # --- telemetry -> drift ---------------------------------------------------

    def _detect_drift(self, stats: Dict[str, NodeStats]) -> List[str]:
        cfg = self.cfg
        drifts: List[str] = []
        placement_nodes = set(self.pipeline.placement.values())
        for nid in sorted(placement_nodes):
            s = stats.get(nid)
            if s is None or not s.online:
                drifts.append(f"offline:{nid}")
                continue
            if s.stability < cfg.stability_threshold:
                drifts.append(f"stability:{nid}")
            if self.monitor.sustained_overload(nid, cfg.sustained_polls,
                                               cfg.load_threshold):
                drifts.append(f"overload:{nid}")
            if s.net_latency_ms > cfg.latency_threshold_ms:
                drifts.append(f"latency:{nid}")
        if len(self._rate_obs) >= cfg.sustained_polls:
            recent = list(self._rate_obs)[-cfg.sustained_polls:]
            if all(o > cfg.overload_rate_ratio * c and o > 0.0
                   for o, c in recent):
                drifts.append("arrival-overload")
        if self.partitioner.calibration_drift(
                self._planned_calibration) > cfg.calibration_band:
            drifts.append("miscalibration")
        if self._planned_caps is not None:
            for nid, s in stats.items():
                base = self._planned_caps.get(nid, 0.0)
                cap = s.capability
                if base <= 0.0:
                    if cap > 0.0 and nid not in placement_nodes:
                        drifts.append(f"capacity-join:{nid}")
                elif abs(cap - base) / base > cfg.capacity_band:
                    drifts.append(f"capacity:{nid}")
        return drifts

    # --- prediction -----------------------------------------------------------

    def _predicted_bottleneck_ms(self, partitions: List[Partition],
                                 assignment: Dict[int, str]) -> float:
        """Steady-state period of (partitions, assignment) under the shared
        planner objective (``planner.bottleneck_ms``): slowest node-serialized
        stage set, execution plus incoming boundary transfers. Uses the
        partitioner's *current* calibration for both plans so comparisons are
        apples-to-apples even when the plan was built at another scale."""
        return bottleneck_ms(self.partitioner.graph, partitions, assignment,
                             self.cluster, batch=self.pipeline.batch,
                             calibration=self.partitioner.calibration,
                             speedup=self.deployer.speedup,
                             expected_k=self.expected_k(),
                             batch_model=self.pipeline.batch_model)

    def _predicted_migration_cost_ms(self, plan: PartitionPlan,
                                     assignment: List[str]) -> float:
        """Params transfer for every partition not already resident on its
        target plus a redeploy penalty — computed by the deployer itself, so
        prediction and the later ``migrate_plan`` charge cannot diverge."""
        return self.deployer.predicted_migration_ms(
            plan, assignment, self.cfg.redeploy_penalty_ms)

    # --- decision -------------------------------------------------------------

    def _candidate(self, stats: Dict[str, NodeStats]):
        """Best (plan, stage->node assignment) for the live capabilities.

        Delegates the joint boundary + assignment search to the
        ``PartitionPlanner``: exhaustive (every node order through the DP
        recurrence) for small clusters, the polynomial candidate-order DP
        beyond that — so re-planning stays sub-second at 50+ nodes where
        PR 1's permutation scoring was intractable. Node capabilities come
        from the live snapshots, de-rated by scheduler execution history.
        On a DAG graph the same DP runs over topological cuts (the
        planner's reach-weighted stage/edge matrices), and
        ``plan_from_cuts`` rebuilds the stage DAG — migration candidates
        are DAG stage sets with no controller-side special casing.
        """
        views = node_views_from_stats(stats, self.cluster,
                                      scheduler=self.pipeline.scheduler)
        result = self.planner.plan(views, batch=self.pipeline.batch,
                                   calibration=self.partitioner.calibration,
                                   speedup=self.deployer.speedup,
                                   committed_ms=self.pipeline.committed_ms,
                                   weight=self.pipeline.tenant.traffic.weight,
                                   expected_k=self.expected_k())
        if result is None:
            return None, None
        return self.partitioner.plan_from_cuts(result.cuts), result.assignment

    def _partial_candidate(self, stats: Dict[str, NodeStats]):
        """The bounded-migration candidate: keep the current plan's cuts,
        move at most ``cfg.partial_migration_k`` stages
        (``PartitionPlanner.plan_partial``). Returns (assignment,
        moved_stages) or (None, 0) when disabled or no move helps."""
        k = self.cfg.partial_migration_k
        plan = self.pipeline.plan
        if k <= 0 or plan is None:
            return None, 0
        views = node_views_from_stats(stats, self.cluster,
                                      scheduler=self.pipeline.scheduler)
        parts = plan.partitions
        cuts = [p.lo for p in parts] + [parts[-1].hi]
        current = [self.pipeline.placement[p.index] for p in parts]
        res = self.planner.plan_partial(
            views, cuts, current, k, batch=self.pipeline.batch,
            calibration=self.partitioner.calibration,
            speedup=self.deployer.speedup,
            committed_ms=self.pipeline.committed_ms,
            weight=self.pipeline.tenant.traffic.weight,
            expected_k=self.expected_k())
        if res is None or res.moved_stages == 0:
            return None, 0
        return res.assignment, res.moved_stages

    def evaluate(self, force_poll: bool = False) -> Optional[MigrationDecision]:
        """Run one control-loop iteration; returns the decision if drift was
        evaluated, else None. Does not apply the migration."""
        if force_poll:
            self.monitor.poll(force=True)
        else:
            self.monitor.poll()
        if self.monitor.last_poll_ms <= self._last_eval_ms and not force_poll:
            return None
        self._last_eval_ms = self.monitor.last_poll_ms
        stats = self._closure_stats(self.monitor.snapshots)
        if self._planned_caps is None:   # first observation anchors the plan
            self._planned_caps = {nid: s.capability for nid, s in stats.items()}
        drifts = self._detect_drift(stats)
        if not drifts:
            self._last_skipped_drifts = None
            return None
        # Threshold-style drifts (latency/stability/overload, incl. the
        # open-loop arrival-rate trigger) re-fire with identical labels every
        # poll once judged not actionable — silence exact repeats.
        # Baseline-anchored drifts (capacity/miscalibration/offline/join)
        # only re-appear when the signal moved again relative to the
        # re-anchored baseline, so they always warrant a fresh evaluation
        # even under the same label.
        persistent = ("stability:", "overload:", "latency:",
                      "arrival-overload")
        if (tuple(drifts) == self._last_skipped_drifts
                and all(d.startswith(persistent) for d in drifts)):
            return None
        now = self.cluster.clock.now_ms
        self.decisions += 1
        for d in drifts:
            self._log(now, "drift", d)

        service_down = any(d.startswith("offline:") for d in drifts)
        # overload relief valve: a pure arrival-overload drift (no node-
        # level signal) is first answered by raising the engine's
        # micro-batch cap — deeper amortization of the fixed per-inference
        # overhead buys completion rate without paying any transfer cost.
        # Only when the overload persists through a full fresh sustained
        # window at the capped batch size does the controller migrate.
        if (not service_down
                and drifts and all(d == "arrival-overload" for d in drifts)):
            cap = self.batch_cap or self.stream_micro_batch
            if cap < self.cfg.batch_cap_limit:
                self.batch_cap = min(self.cfg.batch_cap_limit,
                                     max(2, cap * 2))
                self.reset_rates()   # judge persistence over a fresh window
                self._log(now, "batch-cap",
                          f"arrival-overload: micro-batch cap -> "
                          f"{self.batch_cap} (migrate only if overload "
                          f"persists)")
                return MigrationDecision(False, "batch-cap-raised", drifts,
                                         math.nan, math.nan, 0.0, 0.0)

        if (not service_down
                and now - self._last_migration_ms < self.cfg.cooldown_ms):
            return MigrationDecision(False, "cooldown", drifts,
                                     math.nan, math.nan, 0.0, 0.0)

        plan, assignment = self._candidate(stats)
        if plan is None:
            self._log(now, "skip", "no online capacity for a candidate plan")
            return MigrationDecision(False, "no-capacity", drifts,
                                     math.inf, math.inf, 0.0, 0.0)

        cur = self._predicted_bottleneck_ms(
            self.pipeline.plan.partitions, self.pipeline.placement)
        cand = self._predicted_bottleneck_ms(
            plan.partitions, {i: nid for i, nid in enumerate(assignment)})
        cost = self._predicted_migration_cost_ms(plan, assignment)
        gain = ((cur - cand) * self.cfg.amortize_requests
                if math.isfinite(cur) else math.inf)
        partial, moved = False, 0
        if not service_down:
            # the cheap candidate: same cuts, at most k stages re-homed —
            # preferred when its net gain beats the full re-plan's (a full
            # re-plan re-ships most of the model; the partial ships only
            # the moved stages' parameters)
            p_assign, p_moved = self._partial_candidate(stats)
            if p_assign is not None:
                p_cand = self._predicted_bottleneck_ms(
                    self.pipeline.plan.partitions,
                    {i: nid for i, nid in enumerate(p_assign)})
                p_cost = self.deployer.predicted_migration_ms(
                    self.pipeline.plan, p_assign,
                    self.cfg.redeploy_penalty_ms)
                p_gain = ((cur - p_cand) * self.cfg.amortize_requests
                          if math.isfinite(cur) else math.inf)
                ratio = self.cfg.min_gain_ratio
                if (p_gain - p_cost * ratio) > (gain - cost * ratio):
                    plan, assignment = self.pipeline.plan, p_assign
                    cand, cost, gain = p_cand, p_cost, p_gain
                    partial, moved = True, p_moved
        migrate = service_down or gain > cost * self.cfg.min_gain_ratio
        reason = ("service-down" if service_down else
                  "gain-exceeds-cost" if migrate else "gain-below-cost")
        return MigrationDecision(migrate, reason, drifts, cur, cand,
                                 gain, cost, plan, assignment,
                                 partial=partial, moved_stages=moved)

    def apply(self, decision: MigrationDecision) -> None:
        """Live migration: deployer switches plans; the pipeline routes new
        requests to the new placement while in-flight ones drain."""
        assert decision.migrate and decision.plan is not None
        placed, transfer_cost = self.deployer.migrate_plan(
            decision.plan, decision.assignment)
        self.pipeline.plan = decision.plan
        self.pipeline.placement = placed
        now = self.cluster.clock.now_ms
        self.migrations += 1
        self._last_migration_ms = now
        # a migration changes the placement every silenced drift was judged
        # against — un-silence here (not in maybe_adapt) so the arbiter's
        # direct apply() path re-evaluates persistent drifts too
        self._last_skipped_drifts = None
        self._planned_calibration = self.partitioner.calibration
        self._planned_caps = {
            nid: s.capability
            for nid, s in self._closure_stats(self.monitor.snapshots).items()}
        kind_detail = (f"partial({decision.moved_stages} stage(s)) -> "
                       if decision.partial else
                       f"{len(decision.plan.partitions)}-way -> ")
        self._log(now, "migrate",
                  kind_detail
                  + f"{assignment_str(placed)} ({decision.reason})",
                  data=dict(
                      partial_moves=decision.moved_stages,
                      bottleneck_before_ms=round(decision.current_bottleneck_ms, 2)
                      if math.isfinite(decision.current_bottleneck_ms) else "inf",
                      bottleneck_after_ms=round(decision.candidate_bottleneck_ms, 2),
                      predicted_gain_ms=round(decision.predicted_gain_ms, 2)
                      if math.isfinite(decision.predicted_gain_ms) else "inf",
                      migration_cost_ms=round(decision.migration_cost_ms, 2),
                      transfer_charged_ms=round(transfer_cost, 2)))

    def on_engine_event(self, kind: str,
                        force_poll: bool = False) -> Optional[MigrationDecision]:
        """Control-loop entry point for the event engine: invoked at
        simulated-time engine events — monitor poll ticks, scenario
        mutations, failed dispatches — rather than at request submit
        boundaries (the legacy loop's cadence). ``kind`` names the
        triggering event (``poll`` / ``scenario`` / ``dispatch-failed``)
        and is tallied into ``engine_events`` (surfaced by
        :meth:`summary`); ``force_poll`` refreshes telemetry immediately
        for events that must not wait out the poll interval. Delegates to
        :meth:`maybe_adapt`, so the decision logic is identical on both
        cadences."""
        self.note_engine_event(kind)
        return self.maybe_adapt(force_poll=force_poll)

    def note_engine_event(self, kind: str) -> None:
        """Tally an engine event without running the control loop — the
        cross-tenant arbiter (``core.tenancy``) drives evaluate/apply
        itself but must keep the telemetry counters identical to the
        independent path."""
        self.engine_events[kind] = self.engine_events.get(kind, 0) + 1

    def note_skip(self, decision: MigrationDecision) -> None:
        """Bookkeeping for a non-applied decision: silence exact-repeat
        persistent drifts and re-anchor the capacity/calibration baselines
        so the judged-not-actionable signal doesn't re-fire every poll.
        Cooldown and batch-cap decisions are excluded — neither judged the
        drift itself. Shared by :meth:`maybe_adapt` and the arbiter (for
        tenants whose decision was migrate=False)."""
        if decision.reason in ("cooldown", "batch-cap-raised"):
            return
        self._last_skipped_drifts = tuple(decision.drifts)
        if decision.reason == "gain-below-cost":   # no-capacity logs itself
            self._log(self.cluster.clock.now_ms, "skip",
                      f"{decision.reason}: gain "
                      f"{decision.predicted_gain_ms:.1f}ms <= cost "
                      f"{decision.migration_cost_ms:.1f}ms",
                      data=dict(drifts=decision.drifts))
        # the drift was considered and judged not worth acting on; anchor
        # the baseline so the same signal doesn't re-fire every poll
        self._planned_calibration = self.partitioner.calibration
        self._planned_caps = {
            nid: s.capability
            for nid, s in self._closure_stats(self.monitor.snapshots).items()}

    def defer(self, decision: MigrationDecision, detail: str) -> None:
        """Arbitration outcome: the decision wanted to migrate but another
        tenant's migration won this control tick. Log the deferral
        *without* anchoring baselines or silencing the drift — the tenant
        re-enters the next arbitration tick with fresh telemetry (by which
        time the winner's load shift is visible)."""
        self._log(self.cluster.clock.now_ms, "skip",
                  f"{detail}: gain {decision.predicted_gain_ms:.1f}ms, "
                  f"cost {decision.migration_cost_ms:.1f}ms",
                  data=dict(drifts=decision.drifts))

    def maybe_adapt(self, force_poll: bool = False) -> Optional[MigrationDecision]:
        """One full control-loop step: evaluate drift and apply the migration
        if the decision says so. Returns the decision, or None when no fresh
        telemetry / no drift."""
        decision = self.evaluate(force_poll=force_poll)
        if decision is None:
            return None
        if decision.migrate:
            self.apply(decision)   # apply() un-silences skipped drifts
        else:
            self.note_skip(decision)
        return decision

    # --- reporting ------------------------------------------------------------

    def _log(self, t_ms: float, kind: str, detail: str, data: dict = None) -> None:
        self.events.append(AdaptationEvent(t_ms, kind, detail, data or {}))

    def summary(self) -> dict:
        """Migration/decision counters plus the rendered event log — the
        ``RunReport.adaptation`` payload."""
        return dict(
            migrations=self.migrations,
            decisions=self.decisions,
            engine_events=dict(self.engine_events),
            events=[str(e) for e in self.events],
        )


def assignment_str(placement: Dict[int, str]) -> str:
    """Render a stage->node placement map compactly for event logs."""
    return "{" + ", ".join(f"{i}:{placement[i]}" for i in sorted(placement)) + "}"
