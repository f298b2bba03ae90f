"""Multi-tenant serving core: tenants, the registry, and cross-model arbitration.

AMP4EC's scheduler and partitioner assume one model per cluster, but the
paper's target — heterogeneous edge fleets serving real workloads — means
several models contending for the same 0.4-CPU/512MB nodes (the regime
SEIFER partitions for, and the Edge-Cloud-Continuum line adapts across).
This module makes tenancy a first-class concept instead of a loop over
independent ``DistributedInference`` objects:

* **Tenant** owns what used to live on ``DistributedInference``: the
  partition plan, the stage->node placement, and a *traffic profile*
  (arrival process, request budget, SLO deadline, relative load weight).
  ``DistributedInference.plan`` / ``.placement`` are now properties
  delegating here, so every existing call site reads/writes through the
  tenancy layer.
* **TenantRegistry** tracks the tenants sharing one ``EdgeCluster`` and
  derives the cross-tenant budgets the planner and deployer need:
  per-tenant **committed memory** per node (from tagged deployments) and
  per-node **time budgets** (weighted predicted ms/request each tenant's
  resident stages charge a node — the committed load
  ``PartitionPlanner.plan(committed_ms=...)`` plans around).
* **CrossTenantArbiter** closes the loop *across* models: at each control
  tick it collects every tenant controller's migration decision
  (including the planner-aware partial candidates) and applies only the
  single best predicted-gain-minus-transfer-cost migration, deferring the
  rest — so one drift event does not stampede every tenant onto the same
  surviving node. Service-down decisions (a dead placement node) are
  never deferred.
* **MultiTenantReport** aggregates the per-tenant ``RunReport``s of one
  interleaved run (``TenantRegistry.run`` -> ``core.engine``'s shared
  event heap) into cluster-level goodput/SLO rows.

Single-tenant parity: a registry holding exactly one tenant dispatches
``run`` through the tenant's own pipeline (identical code path to a
direct ``DistributedInference.run``), and the shared multi-stream event
loop itself is the same code single-tenant event runs execute — both are
pinned bit-for-bit by ``tests/test_tenancy.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, TYPE_CHECKING

from repro_torch.core.adaptation import ScenarioEvent
from repro_torch.core.cluster import EdgeCluster
from repro_torch.core.cost_model import execution_ms, partition_cost, transfer_ms
from repro_torch.core.traffic import ArrivalProcess

if TYPE_CHECKING:   # import cycle: pipeline imports tenancy for Tenant
    from repro_torch.core.pipeline import RunReport


@dataclass
class TenantTraffic:
    """Traffic profile of one tenant's request stream.

    ``arrivals`` None means closed-loop submission (the paper's evaluation
    mode); an ``ArrivalProcess`` makes the tenant open-loop. ``weight`` is
    the tenant's relative offered load, used by the multi-tenant planner
    to scale that tenant's per-node time budget (a 2x-rate tenant loads a
    node twice as much per deployed stage). ``retry_budget`` caps this
    tenant's total fault-mode retries (``core.faults``); None defers to
    the run's ``FaultConfig.retry_budget``. ``escalate_to`` names another
    tenant as this tenant's model-cascade target: every request that
    reaches this tenant's plan tail *without* an early-exit head firing
    (a cascade miss) is escalated — re-submitted into the target tenant's
    stream at its finish time. The target's ``num_requests`` then acts as
    a capacity, not a demand: it serves exactly the escalated misses.
    """
    num_requests: int = 100
    arrivals: Optional[ArrivalProcess] = None
    concurrency: int = 32
    repeat_rate: float = 0.0
    seed: int = 0
    deadline_ms: float = 2000.0
    weight: float = 1.0
    retry_budget: Optional[int] = None
    escalate_to: Optional[str] = None


class Tenant:
    """One served model on a shared cluster: identity, the owned
    (plan, placement) pair, and the traffic profile.

    Plan ownership lives here — ``DistributedInference`` delegates its
    ``plan`` / ``placement`` attributes to its tenant, so the deployer,
    scheduler, and engine all read the same tenancy-layer state whether a
    cluster hosts one model or ten.
    """

    def __init__(self, name: str, traffic: Optional[TenantTraffic] = None):
        self.name = name
        self.traffic = traffic or TenantTraffic()
        self.plan = None                     # PartitionPlan, set at deploy
        self.placement: Dict[int, str] = {}  # stage index -> node id
        self.pipeline = None                 # DistributedInference back-ref
        self._budget_cache = None            # (key, node_time_ms result)

    def committed_mb(self) -> Dict[str, float]:
        """Per-node memory (MB) committed to this tenant's active
        deployments — read from the deployer's tenant-tagged records, so
        it cannot drift from what was actually shipped."""
        assert self.pipeline is not None, "tenant not attached to a pipeline"
        return self.pipeline.deployer.committed_mb(tenant=self.name)

    def node_time_ms(self, weighted: bool = True) -> Dict[str, float]:
        """Predicted per-request milliseconds this tenant's resident
        stages charge each node (execution plus incoming boundary
        transfer, at the current calibration) — the per-node time budget
        the multi-tenant planner treats as committed load. ``weighted``
        scales by the tenant's relative traffic weight. Batch-aware: when
        the pipeline's controller expects micro-batches of k > 1 (or a
        calibration artifact is loaded), the budget is the amortized
        per-request time at that k — the same numbers the planner's
        objective and the engine's ``exec_for(k)`` use. Memoized on
        (plan, placement, calibration, k) identity — the engine refreshes
        budgets at every poll tick, and they only move on migration,
        recalibration, or a batch-regime change."""
        p = self.pipeline
        assert p is not None, "tenant not attached to a pipeline"
        k = (p.controller.expected_k() if p.controller is not None
             else p.expected_k)
        k = max(int(k), 1)
        model = p.batch_model
        key = (self.plan, tuple(sorted(self.placement.items())),
               tuple(p.cluster.nodes[nid].profile
                     for nid in self.placement.values()),
               p.partitioner.calibration, weighted, k, id(model))
        if self._budget_cache is not None and self._budget_cache[0] == key:
            return self._budget_cache[1]
        graph = p.partitioner.graph
        scale = (p.partitioner.calibration * p.batch / p.deployer.speedup)
        w = self.traffic.weight if weighted else 1.0
        plain = k == 1 and model.is_analytic
        out: Dict[str, float] = {}
        for part in self.plan.partitions:
            node = p.cluster.nodes[self.placement[part.index]]
            if plain:
                ws = p.partitioner.working_set(part, p.batch)
                t = execution_ms(
                    partition_cost(graph, part.lo, part.hi) * scale,
                    node.profile, ws)
                if part.lo > 0:
                    t += transfer_ms(part.in_bytes * p.batch, node.profile)
            else:
                t = model.amortized_stage_ms(
                    partition_cost(graph, part.lo, part.hi) * scale,
                    p.partitioner.working_set(part, p.batch * k),
                    part.in_bytes * p.batch if part.lo > 0 else 0.0,
                    node.profile, k,
                    model.partition_curve(graph, part.lo, part.hi))
            out[node.node_id] = out.get(node.node_id, 0.0) + t * w
        self._budget_cache = (key, out)
        return out

    def __repr__(self) -> str:
        stages = len(self.plan.partitions) if self.plan is not None else 0
        return f"Tenant({self.name!r}, stages={stages})"


def committed_budgets(tenants, exclude=None) -> Dict[str, float]:
    """Aggregate per-node time budget (weighted predicted ms/request) of
    every deployed tenant except ``exclude`` (a :class:`Tenant` or its
    name) — *the* committed-load map handed to
    ``PartitionPlanner.plan(committed_ms=...)``. Single implementation
    shared by ``TenantRegistry.node_time_ms`` and the engine's per-poll
    refresh, so deploy-time and mid-run planning budgets cannot drift
    apart."""
    out: Dict[str, float] = {}
    for t in tenants:
        if t is exclude or t.name == exclude or t.plan is None:
            continue
        for nid, ms in t.node_time_ms().items():
            out[nid] = out.get(nid, 0.0) + ms
    return out


def disjoint_node_groups(node_sets) -> List[List[int]]:
    """Partition node-id sets into groups that share no node — union-find
    over shared nodes. Returns index groups, each sorted, ordered by
    smallest member. The fast event core feeds this either bare placement
    node sets (immobile tenants) or *reachable* sets (placement plus the
    ``nodes=`` migration closure of an adaptive tenant): two tenants in
    different groups can never contend for an engine, queue slot, or
    (isolated-fabric) link — not even after migrations — which is what
    lets ``core.fastcore`` run each group on an independent event wheel."""
    node_sets = list(node_sets)
    parent = list(range(len(node_sets)))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    node_owner: Dict[str, int] = {}
    for i, nodes in enumerate(node_sets):
        for nid in nodes:
            j = node_owner.get(nid)
            if j is None:
                node_owner[nid] = i
            else:
                parent[find(i)] = find(j)
    groups: Dict[int, List[int]] = {}
    for i in range(len(node_sets)):
        groups.setdefault(find(i), []).append(i)
    return [groups[k] for k in sorted(groups)]


def disjoint_placement_groups(placements) -> List[List[int]]:
    """Placement-map (stage -> node id) form of
    :func:`disjoint_node_groups`."""
    return disjoint_node_groups([set(p.values()) for p in placements])


class TenantRegistry:
    """The tenants sharing one ``EdgeCluster``, plus the cross-tenant
    budget views (committed memory, per-node time) that make joint
    planning and arbitration possible."""

    def __init__(self, cluster: EdgeCluster):
        self.cluster = cluster
        self.tenants: Dict[str, Tenant] = {}

    def add(self, name: str, partitioner,
            traffic: Optional[TenantTraffic] = None, **pipeline_kw) -> Tenant:
        """Register a new tenant and deploy its model on the shared
        cluster. ``pipeline_kw`` is forwarded to ``DistributedInference``
        (``method="planner"``, ``adaptive=True``, ...); the multi-tenant
        planner path additionally plans around the time budgets already
        committed by earlier tenants (``committed_ms``)."""
        from repro_torch.core.pipeline import DistributedInference  # cycle guard
        assert name not in self.tenants, f"duplicate tenant {name!r}"
        tenant = Tenant(name, traffic=traffic)
        committed = self.node_time_ms()
        DistributedInference(self.cluster, partitioner, tenant=tenant,
                             committed_ms=committed or None, **pipeline_kw)
        self.tenants[name] = tenant
        return tenant

    def attach(self, tenant: Tenant) -> Tenant:
        """Register an already-deployed tenant (one constructed by a
        direct ``DistributedInference(..., tenant=...)`` call)."""
        assert tenant.name not in self.tenants, \
            f"duplicate tenant {tenant.name!r}"
        assert tenant.pipeline is not None, "tenant has no pipeline"
        assert tenant.pipeline.cluster is self.cluster, \
            "tenant deployed on a different cluster"
        self.tenants[tenant.name] = tenant
        return tenant

    # --- cross-tenant budget views -------------------------------------------

    def committed_mb(self) -> Dict[str, Dict[str, float]]:
        """{tenant: {node: MB}} of active deployment memory — the
        registry's view of who holds which node's memory."""
        return {name: t.committed_mb() for name, t in self.tenants.items()}

    def node_time_ms(self, exclude: Optional[str] = None) -> Dict[str, float]:
        """Aggregate per-node time budget (weighted predicted ms/request)
        committed by every tenant except ``exclude`` — what a tenant's
        re-planning must treat as already-spent node capacity (delegates
        to the shared :func:`committed_budgets`)."""
        return committed_budgets(self.tenants.values(), exclude)

    # --- the interleaved run --------------------------------------------------

    def run(self, name: str = "tenants",
            scenario: Optional[Sequence[ScenarioEvent]] = None,
            engine=None, arbitration: bool = True) -> "MultiTenantReport":
        """Serve every tenant's stream through one shared event heap
        (``core.engine``): requests interleave on shared per-node FIFOs
        and the shared fabric, each tenant keeping its own plan, cache,
        RNG, and admission window (its ``TenantTraffic``).

        With ``arbitration`` (and adaptive tenants) a
        :class:`CrossTenantArbiter` applies only the best
        predicted-net-gain migration per control tick; without it every
        tenant's controller acts independently. A registry holding exactly
        one tenant dispatches through the tenant's own pipeline — the
        identical code path (fast parity path included) a direct
        ``DistributedInference.run`` takes, so single-tenant behavior is
        bit-for-bit unchanged by the tenancy layer.
        """
        assert self.tenants, "no tenants registered"
        tenants = list(self.tenants.values())
        assert all(t.traffic.escalate_to is None or
                   t.traffic.escalate_to in self.tenants
                   for t in tenants), "cascade target tenant not registered"
        if len(tenants) == 1 and tenants[0].traffic.escalate_to is None:
            t = tenants[0]
            tr = t.traffic
            rep = t.pipeline.run(tr.num_requests, name=f"{name}/{t.name}",
                                 repeat_rate=tr.repeat_rate, seed=tr.seed,
                                 concurrency=tr.concurrency,
                                 scenario=scenario, engine=engine,
                                 arrivals=tr.arrivals)
            return MultiTenantReport(name, {t.name: rep},
                                     {t.name: tr.deadline_ms})
        from repro_torch.core.engine import MultiTenantEngine  # cycle guard
        arbiter = (CrossTenantArbiter(tenants) if arbitration and any(
            t.pipeline.controller is not None for t in tenants) else None)
        reports = MultiTenantEngine(self.cluster, tenants).run(
            scenario=scenario, config=engine, arbiter=arbiter, name=name)
        return MultiTenantReport(
            name, reports, {t.name: t.traffic.deadline_ms for t in tenants},
            arbitration=arbiter.summary() if arbiter is not None else None)


class CrossTenantArbiter:
    """Cross-model migration arbitration.

    Independent per-tenant controllers all react to the same cluster
    drift: a throttled node makes *every* tenant's controller want to
    migrate at the same poll tick, stampeding their plans onto the same
    surviving nodes and paying every transfer cost at once. The arbiter
    collects each controller's decision first (``evaluate`` — which
    already prefers the cheaper "move at most k stages" partial candidate
    when its net gain wins) and applies only the decision with the best
    predicted-gain-minus-transfer-cost, deferring the rest to later
    ticks, by which time the applied migration's load shift is visible in
    the telemetry they re-plan from. Service-down decisions (an offline
    placement node) are applied unconditionally — availability is not
    arbitrated."""

    def __init__(self, tenants: Sequence[Tenant]):
        self.tenants = list(tenants)
        self.applied = 0
        self.deferred = 0

    def on_engine_event(self, kind: str, force_poll: bool = False) -> None:
        """One arbitration tick (the engine calls this instead of each
        tenant controller's ``on_engine_event``): evaluate every adaptive
        tenant, apply forced (service-down) migrations immediately, then
        apply only the best-net-gain voluntary migration."""
        candidates = []
        for t in self.tenants:
            c = t.pipeline.controller
            if c is None:
                continue
            c.note_engine_event(kind)
            decision = c.evaluate(force_poll=force_poll)
            if decision is None:
                continue
            if decision.migrate and decision.reason == "service-down":
                c.apply(decision)
                self.applied += 1
            elif decision.migrate:
                candidates.append((t, c, decision))
            else:
                c.note_skip(decision)
        if not candidates:
            return
        candidates.sort(key=lambda tc: -(tc[2].predicted_gain_ms
                                         - tc[2].migration_cost_ms))
        _, best_c, best_d = candidates[0]
        best_c.apply(best_d)
        self.applied += 1
        for t, c, d in candidates[1:]:
            c.defer(d, "arbitration-deferred")
            self.deferred += 1

    def summary(self) -> dict:
        """Arbitration counters for the run report."""
        return dict(applied=self.applied, deferred=self.deferred)


class MultiTenantReport:
    """Per-tenant ``RunReport``s of one interleaved run plus the
    cluster-level aggregates the multi-tenant benchmarks are judged on."""

    def __init__(self, name: str, reports: Dict[str, "RunReport"],
                 deadlines_ms: Dict[str, float],
                 arbitration: Optional[dict] = None):
        self.name = name
        self.reports = reports
        self.deadlines_ms = deadlines_ms
        self.arbitration = arbitration

    def __getitem__(self, tenant: str) -> "RunReport":
        """The named tenant's ``RunReport``."""
        return self.reports[tenant]

    @property
    def num_requests(self) -> int:
        """Total requests served across tenants."""
        return sum(len(r.columns) for r in self.reports.values())

    @property
    def makespan_ms(self) -> float:
        """First arrival to last finish across all tenants."""
        lo = min(float(r.columns.arrival_ms.min())
                 for r in self.reports.values())
        hi = max(float(r.columns.finish_ms.max())
                 for r in self.reports.values())
        return hi - lo

    def goodput_rps(self, tenant: Optional[str] = None) -> float:
        """Deadline-meeting completions per second: one tenant's (at its
        own deadline) or — with ``tenant=None`` — the cluster aggregate:
        every tenant's deadline hits over the shared makespan."""
        if tenant is not None:
            return self.reports[tenant].goodput_rps(self.deadlines_ms[tenant])
        hits = sum(int(r.columns.deadline_met(self.deadlines_ms[n]).sum())
                   for n, r in self.reports.items())
        return 1000.0 * hits / max(self.makespan_ms, 1e-9)

    def migrations(self) -> int:
        """Total migrations applied across tenant controllers."""
        total = 0
        for r in self.reports.values():
            if r.adaptation is not None:
                total += r.adaptation["migrations"]
        return total

    def row(self) -> dict:
        """Flatten into one benchmark-table row (aggregate + per-tenant
        goodput)."""
        agg = dict(
            config=self.name,
            tenants=len(self.reports),
            num_requests=self.num_requests,
            aggregate_goodput_rps=round(self.goodput_rps(), 4),
            makespan_s=round(self.makespan_ms / 1e3, 2),
            migrations=self.migrations(),
        )
        for tname in sorted(self.reports):
            agg[f"goodput_rps[{tname}]"] = round(self.goodput_rps(tname), 4)
            agg[f"p99_sojourn_ms[{tname}]"] = round(
                self.reports[tname].p99_sojourn_ms, 2)
        if self.arbitration is not None:
            agg["arbitration_applied"] = self.arbitration["applied"]
            agg["arbitration_deferred"] = self.arbitration["deferred"]
        return agg
