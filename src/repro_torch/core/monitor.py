"""Resource Monitor (paper §III-A).

Tracks CPU utilization, memory usage (MB and %), and network I/O per node —
the same metric set the paper polls from the Docker stats API at 1 Hz — and
exposes snapshots to the Model Partitioner and Task Scheduler. Offline nodes
are detected and excluded (the paper's "device offline" scenario).

Monitoring itself costs resources; we charge ``MONITOR_COST_PER_POLL`` per
node per poll and report the overhead (paper: <= 1% CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.cluster import EdgeCluster, EdgeNode

POLL_INTERVAL_MS = 1000.0          # 1 Hz, as in the paper
MONITOR_COST_MS_PER_POLL = 0.08    # simulated cost of one stats query
HISTORY_WINDOW = 64
#: single source for the paper's 50 ms network-latency threshold: the NSA
#: skip rule (scheduler), the capability discount (below), and the adaptation
#: drift trigger all derive from this constant.
LATENCY_THRESHOLD_MS = 50.0


@dataclass
class NodeStats:
    """One node's telemetry snapshot (the paper's Docker-stats metric
    set) plus derived availability and capability scores."""
    node_id: str
    online: bool
    cpu: float                  # provisioned CPU fraction
    cpu_pct: float              # utilization %
    mem_limit_mb: float
    mem_used_mb: float
    mem_pct: float
    net_rx_bytes: float
    net_tx_bytes: float
    current_load: float
    net_latency_ms: float
    stability: float            # 0-1 score

    @property
    def cpu_avail(self) -> float:
        """CPU share not consumed by current load (Eq. 5 numerator)."""
        return self.cpu * max(0.0, 1.0 - self.current_load)

    @property
    def mem_avail_mb(self) -> float:
        """Free memory under the node limit (Eq. 5 numerator)."""
        return max(0.0, self.mem_limit_mb - self.mem_used_mb)

    @property
    def capability(self) -> float:
        """Live capability weight for re-partitioning: provisioned CPU scaled
        by headroom, stability, and a high-latency discount. Offline -> 0."""
        if not self.online:
            return 0.0
        cap = max(self.cpu * (1.0 - self.current_load), 0.1 * self.cpu)
        cap *= max(self.stability, 0.25)
        if self.net_latency_ms > LATENCY_THRESHOLD_MS:
            cap *= LATENCY_THRESHOLD_MS / self.net_latency_ms
        return cap


class ResourceMonitor:
    """Paper §III-A: 1 Hz polling of per-node CPU/memory/network stats,
    with history windows and the monitoring-overhead accounting."""

    def __init__(self, cluster: EdgeCluster):
        self.cluster = cluster
        self.last_poll_ms: float = -1e30
        self.snapshots: Dict[str, NodeStats] = {}
        self.history: Dict[str, List[NodeStats]] = {}
        self.polls = 0
        self.overhead_ms = 0.0
        self._offline_seen: set = set()

    def poll(self, force: bool = False) -> Dict[str, NodeStats]:
        """Refresh snapshots if the poll interval elapsed (or ``force``)."""
        now = self.cluster.clock.now_ms
        if not force and now - self.last_poll_ms < POLL_INTERVAL_MS:
            return self.snapshots
        window = max(now - self.last_poll_ms, POLL_INTERVAL_MS)
        self.last_poll_ms = now
        self.polls += 1
        snaps: Dict[str, NodeStats] = {}
        for node in self.cluster.nodes.values():
            self.overhead_ms += MONITOR_COST_MS_PER_POLL
            stat = self._stat(node, window)
            snaps[node.node_id] = stat
            self.history.setdefault(node.node_id, []).append(stat)
            if len(self.history[node.node_id]) > HISTORY_WINDOW:
                self.history[node.node_id].pop(0)
            if not node.online and node.node_id not in self._offline_seen:
                self._offline_seen.add(node.node_id)
        self.snapshots = snaps
        return snaps

    def _stat(self, node: EdgeNode, window_ms: float) -> NodeStats:
        prof = node.profile
        # stability: penalize recent saturation and offline flaps. Reads the
        # node's bounded recent-execution window (fed by both EdgeNode.execute
        # and the pipeline engine's fast path) rather than the unbounded
        # TaskRecord history, so 100k-request streams stay memory-flat.
        recent = node.recent_exec
        stab = 1.0
        if recent:
            over = sum(1 for dur in recent if dur > 2000.0)
            stab = max(0.0, 1.0 - 0.05 * over)
        if not node.online:
            stab = 0.0
        node.cpu_busy_ms = 0.0  # reset utilization integrator per window
        return NodeStats(
            node_id=node.node_id,
            online=node.online,
            cpu=prof.cpu,
            cpu_pct=node.cpu_pct(window_ms),
            mem_limit_mb=prof.mem_mb,
            mem_used_mb=node.mem_used_bytes / (1024 * 1024),
            mem_pct=node.mem_pct(),
            net_rx_bytes=node.net_rx_bytes,
            net_tx_bytes=node.net_tx_bytes,
            current_load=node.current_load,
            net_latency_ms=prof.net_latency_ms,
            stability=stab,
        )

    def poll_compact(self) -> List[EdgeNode]:
        """Snapshot-free poll tick for the fast event core
        (``core.fastcore``), used only for streams with no adaptation
        controller — the only consumers of :class:`NodeStats` snapshots
        and history are adaptation triggers and forced repair polls (which
        re-poll with ``force=True`` and so rebuild identical snapshots
        from the identical node state).

        Side effects are bit-identical to :meth:`poll`: the poll stamp and
        counter, the per-node overhead charge in node order, the per-node
        ``cpu_busy_ms`` window reset, and offline detection. What is
        skipped is only the *allocation* — ~N ``NodeStats`` objects and
        history appends per simulated second that nobody would read.
        Returns the online nodes (same order as ``online_stats``) for
        ``TaskScheduler.select_node_compact``. Caller owns the interval
        gate, exactly like the engine's poll handler."""
        self.last_poll_ms = self.cluster.clock.now_ms
        self.polls += 1
        online: List[EdgeNode] = []
        seen = self._offline_seen
        for node in self.cluster.nodes.values():
            self.overhead_ms += MONITOR_COST_MS_PER_POLL
            node.cpu_busy_ms = 0.0
            if node.online:
                online.append(node)
            elif node.node_id not in seen:
                seen.add(node.node_id)
        return online

    def online_stats(self) -> List[NodeStats]:
        """Fresh-enough snapshots of the currently-online nodes."""
        self.poll()
        return [s for s in self.snapshots.values() if s.online]

    def poll_closure(self, allowed) -> List[NodeStats]:
        """Closure-local poll tick for the fast event core's epoch-barrier
        coordinator: builds ``NodeStats`` snapshots and history only for
        the ``allowed`` node closure of a stream's declared ``nodes=``
        subset — the only stats its adaptation controller and planner can
        ever read (``AdaptationController._closure_stats`` filters every
        consumer through the same set, and the scheduler/decision counters
        the rest of a fleet-wide poll would feed are not part of the
        engine's parity surface). Fleet-wide side effects stay bit-exact
        with :meth:`poll`: the per-node overhead charge in node order
        (``monitor_overhead_pct`` is compared bit-for-bit against the heap
        oracle), the ``cpu_busy_ms`` window resets, and offline detection.
        Caller owns the interval gate. Returns the closure's online stats
        (the shape ``TaskScheduler.select_node`` takes)."""
        now = self.cluster.clock.now_ms
        window = max(now - self.last_poll_ms, POLL_INTERVAL_MS)
        self.last_poll_ms = now
        self.polls += 1
        snaps: Dict[str, NodeStats] = {}
        seen = self._offline_seen
        for node in self.cluster.nodes.values():
            self.overhead_ms += MONITOR_COST_MS_PER_POLL
            if node.node_id in allowed:
                stat = self._stat(node, window)   # resets cpu_busy_ms
                snaps[node.node_id] = stat
                h = self.history.setdefault(node.node_id, [])
                h.append(stat)
                if len(h) > HISTORY_WINDOW:
                    h.pop(0)
            else:
                node.cpu_busy_ms = 0.0
            if not node.online and node.node_id not in seen:
                seen.add(node.node_id)
        self.snapshots = snaps
        return [s for s in snaps.values() if s.online]

    def sustained_overload(self, node_id: str, polls: int,
                           threshold: float) -> bool:
        """True when the node's last ``polls`` snapshots all exceeded the load
        threshold — the Adaptation Controller's hotspot-drift trigger."""
        h = self.history.get(node_id, [])
        if len(h) < polls:
            return False
        return all(s.current_load > threshold for s in h[-polls:])

    def cpu_overhead_pct(self) -> float:
        """Monitor CPU overhead relative to elapsed simulated time."""
        elapsed = max(self.cluster.clock.now_ms, 1.0)
        return 100.0 * self.overhead_ms / elapsed
