"""Model Deployer (paper §III-D).

Places partitions on nodes (via the Task Scheduler), charges the one-time
model-transfer cost, applies the optimization level (the paper's
TorchScript/quantization step becomes a dtype policy here), maintains
deployment records, supports undeploy, and — the paper's §I motivation —
redeploys partitions when a node goes offline or rebalances when one joins.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.cluster import EdgeCluster
from repro_torch.core.cost_model import transfer_ms
from repro_torch.core.monitor import ResourceMonitor
from repro_torch.core.partitioner import Partition, PartitionPlan
from repro_torch.core.scheduler import TaskRequirements, TaskScheduler

#: optimization levels: compute speedup factor, bytes shrink factor
OPT_LEVELS = {
    "none": (1.0, 1.0),
    "script": (1.15, 1.0),      # TorchScript-style graph optimization
    "bf16": (1.25, 0.5),
    "int8": (1.6, 0.25),
}


@dataclass
class Deployment:
    """One partition resident on one node, with its shipping cost and the
    owning tenant's tag (the tenancy layer's committed-memory unit)."""
    partition: Partition
    node_id: str
    opt_level: str
    transfer_ms: float
    active: bool = True
    tenant: str = ""


class ModelDeployer:
    """Paper §III-D: places partitions (via the NSA), charges model
    transfer, applies the optimization level, and handles redeploys and
    live migration. Every deployment is tagged with the owning tenant so
    the tenancy layer (``core.tenancy``) can attribute committed node
    memory per model."""

    def __init__(self, cluster: EdgeCluster, monitor: ResourceMonitor,
                 scheduler: TaskScheduler, opt_level: str = "none",
                 tenant: str = ""):
        assert opt_level in OPT_LEVELS
        self.cluster = cluster
        self.monitor = monitor
        self.scheduler = scheduler
        self.opt_level = opt_level
        self.tenant = tenant               # tag stamped on every deployment
        self.deployments: Dict[int, Deployment] = {}
        self.redeploy_events: List[str] = []

    def committed_mb(self, tenant: Optional[str] = None,
                     node_id: Optional[str] = None) -> Dict[str, float]:
        """Active deployment memory ({node_id: MB}), filterable by tenant
        tag and node — the registry's per-tenant committed-memory view,
        derived from the same records the migration economics use."""
        shrink = OPT_LEVELS[self.opt_level][1]
        out: Dict[str, float] = {}
        for d in self.deployments.values():
            if not d.active:
                continue
            if tenant is not None and d.tenant != tenant:
                continue
            if node_id is not None and d.node_id != node_id:
                continue
            mb = d.partition.params_bytes * shrink / (1024 * 1024)
            out[d.node_id] = out.get(d.node_id, 0.0) + mb
        return out

    @property
    def speedup(self) -> float:
        """Compute speedup factor of the active optimization level."""
        return OPT_LEVELS[self.opt_level][0]

    def _mem_req_mb(self, part: Partition) -> float:
        shrink = OPT_LEVELS[self.opt_level][1]
        return part.params_bytes * shrink / (1024 * 1024) + 32.0  # + runtime

    def deploy_plan(self, plan: PartitionPlan,
                    assignment: Optional[List[str]] = None) -> Dict[int, str]:
        """Deploy every partition; returns {partition_index: node_id}.

        Without an explicit assignment, each partition is placed by the NSA
        (heaviest partitions first, so capable nodes take costly stages).
        """
        placed: Dict[int, str] = {}
        order = sorted(plan.partitions, key=lambda p: -p.cost)
        for part in order:
            if assignment is not None:
                node_id = assignment[part.index]
            else:
                stats = self.monitor.online_stats()
                req = TaskRequirements(cpu=0.1, mem_mb=self._mem_req_mb(part))
                node_id = self.scheduler.select_node(stats, req)
                if node_id is None:
                    raise RuntimeError(
                        f"no eligible node for partition {part.index} "
                        f"(mem req {self._mem_req_mb(part):.0f} MB)")
            node = self.cluster.nodes[node_id]
            shrink = OPT_LEVELS[self.opt_level][1]
            t_ms = node.receive(part.params_bytes * shrink)
            node.mem_used_bytes += part.params_bytes * shrink
            self.deployments[part.index] = Deployment(
                part, node_id, self.opt_level, t_ms, tenant=self.tenant)
            placed[part.index] = node_id
        return placed

    def undeploy(self, part_index: int) -> None:
        """Deactivate a deployment and release its node memory."""
        d = self.deployments.get(part_index)
        if d and d.active:
            node = self.cluster.nodes[d.node_id]
            shrink = OPT_LEVELS[self.opt_level][1]
            node.mem_used_bytes = max(0.0, node.mem_used_bytes
                                      - d.partition.params_bytes * shrink)
            d.active = False

    def assignment(self) -> Dict[int, str]:
        """Current {partition_index: node_id} for active deployments."""
        return {i: d.node_id for i, d in self.deployments.items() if d.active}

    # --- live migration (Adaptation Controller) ------------------------------

    def nonresident_partitions(self, plan: PartitionPlan,
                               assignment: List[str]) -> List[Partition]:
        """Partitions of ``plan`` that would have to be shipped: their layer
        range is not already resident on the assigned node. Shared by the
        actual migration below and the controller's cost prediction, so the
        economics the migrate/skip decision is based on match what a
        migration then charges, by construction."""
        resident = {(d.partition.lo, d.partition.hi, d.node_id)
                    for d in self.deployments.values() if d.active}
        return [p for p in plan.partitions
                if (p.lo, p.hi, assignment[p.index]) not in resident]

    def predicted_migration_ms(self, plan: PartitionPlan, assignment: List[str],
                               penalty_ms: float = 0.0) -> float:
        """Transfer time a migrate_plan() call would charge, plus an optional
        per-moved-partition redeploy penalty."""
        shrink = OPT_LEVELS[self.opt_level][1]
        cost = 0.0
        for part in self.nonresident_partitions(plan, assignment):
            profile = self.cluster.nodes[assignment[part.index]].profile
            cost += transfer_ms(part.params_bytes * shrink, profile) + penalty_ms
        return cost

    def migrate_plan(self, plan: PartitionPlan,
                     assignment: List[str]) -> "tuple[Dict[int, str], float]":
        """Switch to ``plan`` with an explicit stage->node assignment.

        Partitions whose layer range is already resident on their target node
        are reused without re-transfer; everything else is undeployed and
        shipped (params_bytes * dtype shrink) to its new home. Returns the new
        placement and the total transfer time charged — the migration cost the
        controller weighed against the predicted bottleneck gain.
        """
        shrink = OPT_LEVELS[self.opt_level][1]
        to_ship = self.nonresident_partitions(plan, assignment)
        ship_idx = {p.index for p in to_ship}
        new_deps: Dict[int, Deployment] = {}
        placed: Dict[int, str] = {}
        reused_keys = set()
        for part in plan.partitions:
            node_id = assignment[part.index]
            placed[part.index] = node_id
            if part.index not in ship_idx:
                new_deps[part.index] = Deployment(part, node_id,
                                                  self.opt_level, 0.0,
                                                  tenant=self.tenant)
                reused_keys.add((part.lo, part.hi, node_id))
        for d in self.deployments.values():   # old partitions not carried over
            key = (d.partition.lo, d.partition.hi, d.node_id)
            if d.active and key not in reused_keys:
                node = self.cluster.nodes[d.node_id]
                node.mem_used_bytes = max(
                    0.0, node.mem_used_bytes - d.partition.params_bytes * shrink)
                d.active = False
        cost_ms = 0.0
        now = self.cluster.clock.now_ms
        for part in to_ship:
            node = self.cluster.nodes[placed[part.index]]
            t = node.receive(part.params_bytes * shrink)
            node.mem_used_bytes += part.params_bytes * shrink
            # the shipment occupies the target's downlink/runtime: its first
            # new-plan request queues behind it (migration downtime is paid
            # in simulated time, not just in the controller's economics)
            node.busy_until_ms = max(node.busy_until_ms, now) + t
            new_deps[part.index] = Deployment(part, placed[part.index],
                                              self.opt_level, t,
                                              tenant=self.tenant)
            cost_ms += t
            self.redeploy_events.append(
                f"partition {part.index} -> {placed[part.index]} (migrate)")
        self.deployments = new_deps
        return placed, cost_ms

    # --- failure recovery / elasticity --------------------------------------

    def handle_node_offline(self, node_id: str) -> List[int]:
        """Redeploy partitions that lived on a now-offline node.

        The replacement is the most *capable* online node with memory
        headroom (``NodeStats.capability`` — the same live signal the
        planner ranks by), not an NSA ``select_node`` call: the NSA's
        balance/history terms drift with how often request accounting has
        ticked, which would make mid-run failure recovery depend on the
        caller's bookkeeping cadence instead of on cluster state. Memory
        committed to earlier redeploys in this same recovery is tracked
        explicitly (the monitor snapshot is from before the loop), so a
        multi-partition node death cannot overcommit one survivor.
        """
        self.monitor.poll(force=True)   # don't route on a stale snapshot
        moved = []
        committed_mb: Dict[str, float] = {}
        for i, d in list(self.deployments.items()):
            if d.active and d.node_id == node_id:
                stats = self.monitor.online_stats()
                mem_req = self._mem_req_mb(d.partition)
                eligible = [
                    s for s in stats
                    if s.mem_avail_mb - committed_mb.get(s.node_id, 0.0)
                    >= mem_req and s.cpu_avail > 0]
                if not eligible:
                    # raise BEFORE undeploying: the record must survive a
                    # failed repair so a later attempt (e.g. after a node
                    # restart) still sees the partition — dropping it
                    # first left the deployer with a permanently
                    # incomplete assignment
                    raise RuntimeError("no capacity to redeploy partition %d" % i)
                self.undeploy(i)
                new_node = max(eligible,
                               key=lambda s: (s.capability, s.node_id)).node_id
                committed_mb[new_node] = (committed_mb.get(new_node, 0.0)
                                          + mem_req)
                node = self.cluster.nodes[new_node]
                shrink = OPT_LEVELS[self.opt_level][1]
                t = node.receive(d.partition.params_bytes * shrink)
                node.mem_used_bytes += d.partition.params_bytes * shrink
                node.busy_until_ms = max(node.busy_until_ms,
                                         self.cluster.clock.now_ms) + t
                self.deployments[i] = Deployment(d.partition, new_node,
                                                 self.opt_level, t,
                                                 tenant=d.tenant)
                moved.append(i)
                self.redeploy_events.append(
                    f"partition {i}: {node_id} -> {new_node}")
        return moved
