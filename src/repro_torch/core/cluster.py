"""Simulated heterogeneous edge cluster (the Docker testbed, without Docker).

Deterministic discrete-event simulation: a shared ``SimClock`` plus
``EdgeNode`` objects whose capacity profiles mirror the paper's cgroup
limits. Supports the dynamic events the paper motivates in §I: node join
("new device added") and node offline ("device offline"), with the
framework redistributing work in response.

Real numerics (model forwards) are run by the pipeline; *time* is charged via
``core.cost_model`` so results are bit-reproducible on any host.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.cost_model import NodeProfile, PROFILES, execution_ms, transfer_ms

#: how many recent execution durations each node retains for the monitor's
#: stability score (mirrors the seed's ``history[-8:]`` window without
#: requiring unbounded ``TaskRecord`` growth on the engine's hot path).
RECENT_EXEC_WINDOW = 8


class SimClock:
    """Shared simulated wall clock (milliseconds)."""

    def __init__(self):
        self.now_ms: float = 0.0

    def advance(self, ms: float) -> None:
        """Move simulated time forward by ``ms`` (never backwards)."""
        assert ms >= 0
        self.now_ms += ms


@dataclass
class TaskRecord:
    """One executed task on one node: identity, timing window, and cost."""
    task_id: int
    node_id: str
    start_ms: float
    end_ms: float
    cost: float

    @property
    def exec_ms(self) -> float:
        """Execution duration (end minus start)."""
        return self.end_ms - self.start_ms


class EdgeNode:
    """One simulated edge device."""

    def __init__(self, node_id: str, profile: NodeProfile):
        self.node_id = node_id
        self.profile = profile
        self.online = True
        self.busy_until_ms = 0.0
        self.task_count = 0            # tasks currently assigned / completed window
        self.active_tasks = 0
        self.mem_used_bytes = 0.0      # deployed partitions
        self.history: List[TaskRecord] = []
        self.recent_exec: deque = deque(maxlen=RECENT_EXEC_WINDOW)
        self.net_rx_bytes = 0.0
        self.net_tx_bytes = 0.0
        self.cpu_busy_ms = 0.0         # integral of busy time (for CPU%)
        # engine state: per-node FIFO of queued stage work, the busy flag of
        # the in-progress execution, and the async transmit-link availability
        # (core.engine's overlap transfer channel)
        self.pending: deque = deque()
        self.engine_busy = False
        self.tx_free_ms = 0.0
        # fault layer (core.faults): bumped on every transient crash; an
        # execution started under an older epoch is killed — its
        # completion event must not touch node state
        self.crash_epoch = 0
        # tenancy: cumulative execution time charged per tenant (the
        # engine attributes every execution to the owning tenant, so a
        # shared node's capacity split across models is observable)
        self.tenant_busy_ms: Dict[str, float] = {}

    # --- telemetry (consumed by the Resource Monitor) ---

    @property
    def current_load(self) -> float:
        """Active tasks normalized by a nominal per-node concurrency of 2."""
        return min(1.0, self.active_tasks / 2.0)

    @property
    def queue_depth(self) -> int:
        """Engine backlog on this node: queued stage items plus the
        in-progress execution — the per-node counterpart of the
        cluster-wide queue-depth series on ``RunReport`` (the engine's
        adaptive micro-batch cap applies ``core.traffic.adaptive_k`` to
        the waiting portion of this backlog)."""
        return len(self.pending) + (1 if self.engine_busy else 0)

    def mem_pct(self) -> float:
        """Deployed-partition memory as a percentage of the node limit."""
        return 100.0 * self.mem_used_bytes / self.profile.mem_bytes

    def cpu_pct(self, window_ms: float) -> float:
        """CPU utilization over the poll window (busy time / window)."""
        if window_ms <= 0:
            return 0.0
        return min(100.0, 100.0 * self.cpu_busy_ms / window_ms)

    # --- execution ---

    def execute(self, clock: SimClock, task_id: int, cost: float,
                working_set: float = 0.0, start_ms: Optional[float] = None) -> TaskRecord:
        """Run a task; returns its record. Queues behind this node's backlog."""
        assert self.online, f"{self.node_id} is offline"
        start = max(start_ms if start_ms is not None else clock.now_ms,
                    self.busy_until_ms)
        dur = execution_ms(cost, self.profile, working_set)
        rec = TaskRecord(task_id, self.node_id, start, start + dur, cost)
        self.busy_until_ms = rec.end_ms
        self.cpu_busy_ms += dur
        self.history.append(rec)
        self.recent_exec.append(dur)
        self.task_count += 1
        return rec

    def receive(self, num_bytes: float) -> float:
        """Account inbound bytes; returns the link transfer time."""
        self.net_rx_bytes += num_bytes
        return transfer_ms(num_bytes, self.profile)

    def send(self, num_bytes: float) -> float:
        """Account outbound bytes; returns the link transfer time."""
        self.net_tx_bytes += num_bytes
        return transfer_ms(num_bytes, self.profile)


class EdgeCluster:
    """Node registry + dynamic membership events."""

    def __init__(self):
        self.clock = SimClock()
        self.nodes: Dict[str, EdgeNode] = {}
        self._task_ids = itertools.count()
        self.events: List[str] = []
        self._listeners: List[Callable[[str, str], None]] = []

    # --- event hooks ------------------------------------------------------

    def subscribe(self, listener: Callable[[str, str], None]) -> None:
        """Register a ``listener(kind, node_id)`` called on every cluster
        mutation (``join`` / ``offline`` / ``recover`` / ``profile``) — the
        invalidation hook the pipeline engine uses to drop cached per-plan
        timing tables the instant the hardware they describe changes."""
        self._listeners.append(listener)

    def unsubscribe(self, listener: Callable[[str, str], None]) -> None:
        """Remove a listener registered with :meth:`subscribe` (no-op when
        absent, so teardown paths can call it unconditionally)."""
        if listener in self._listeners:
            self._listeners.remove(listener)

    def _notify(self, kind: str, node_id: str) -> None:
        for fn in list(self._listeners):
            fn(kind, node_id)

    # --- membership -------------------------------------------------------

    def add_node(self, node_id: str, profile: NodeProfile | str) -> EdgeNode:
        """Register a device (the paper's "new device added" event);
        ``profile`` may be a ``PROFILES`` name or an explicit profile."""
        if isinstance(profile, str):
            profile = PROFILES[profile]
        node = EdgeNode(node_id, profile)
        self.nodes[node_id] = node
        self.events.append(f"[{self.clock.now_ms:9.1f}ms] join   {node_id} "
                           f"(cpu={profile.cpu}, mem={profile.mem_mb}MB)")
        self._notify("join", node_id)
        return node

    def remove_node(self, node_id: str) -> None:
        """Mark a device offline (the paper's "device offline" event)."""
        node = self.nodes[node_id]
        node.online = False
        self.events.append(f"[{self.clock.now_ms:9.1f}ms] offline {node_id}")
        self._notify("offline", node_id)

    def restore_node(self, node_id: str) -> EdgeNode:
        """Bring a previously-offline node back (the paper's recovery event)."""
        node = self.nodes[node_id]
        node.online = True
        node.busy_until_ms = max(node.busy_until_ms, self.clock.now_ms)
        self.events.append(f"[{self.clock.now_ms:9.1f}ms] recover {node_id}")
        self._notify("recover", node_id)
        return node

    def set_profile(self, node_id: str, **changes) -> EdgeNode:
        """Change a node's resource profile in place (cgroup re-limit: CPU
        throttle, memory squeeze, or a network-latency spike)."""
        node = self.nodes[node_id]
        node.profile = dataclasses.replace(node.profile, **changes)
        desc = ", ".join(f"{k}={v}" for k, v in changes.items())
        self.events.append(f"[{self.clock.now_ms:9.1f}ms] profile {node_id} ({desc})")
        self._notify("profile", node_id)
        return node

    def online_nodes(self) -> List[EdgeNode]:
        """Currently-online nodes, in registration order."""
        return [n for n in self.nodes.values() if n.online]

    def next_task_id(self) -> int:
        """Cluster-unique monotonically increasing task id."""
        return next(self._task_ids)


def make_paper_cluster(profiles=("high", "medium", "low")) -> EdgeCluster:
    """The paper's 3-node heterogeneous testbed (§IV-B)."""
    c = EdgeCluster()
    for i, p in enumerate(profiles):
        c.add_node(f"edge-{i}-{p}", p)
    return c


def make_synthetic_cluster(n: int, seed: int = 0, high_fraction: float = 0.5,
                           jitter: float = 0.15) -> EdgeCluster:
    """A deterministic n-node heterogeneous edge cluster for the scale
    experiments (the regime of *Partitioning and Deployment of DNNs on Edge
    Clusters* / *SEIFER*, where tens of devices cooperate).

    Each node draws one of the paper's two capacity classes —
    ``high_fraction`` get the 1.0-CPU/1024MB profile, the rest the
    0.4-CPU/512MB low-resource profile (§IV-A) — with a +-``jitter``
    relative CPU/memory perturbation so no two devices are identical, as
    in a real fleet. Reproducible for a given ``seed``.
    """
    rnd = random.Random(seed)
    c = EdgeCluster()
    for i in range(n):
        if rnd.random() < high_fraction:
            base, name = PROFILES["high"], "high"
        else:
            base, name = PROFILES["low"], "low"
        j = 1.0 + rnd.uniform(-jitter, jitter)
        profile = NodeProfile(cpu=round(base.cpu * j, 3),
                              mem_mb=round(base.mem_mb * j, 1),
                              net_latency_ms=base.net_latency_ms,
                              net_bw_mbps=base.net_bw_mbps)
        c.add_node(f"edge-{i}-{name}", profile)
    return c
