"""AMP4EC edge-node timing model (paper §III-B2, Eq. 1/2/9), the part the
serving slice reads.

Turns partition costs into simulated execution times on heterogeneous edge
nodes. Calibration: Table II of the paper gives per-profile inference times
that are exactly proportional to 1/CPU (234.56 * 1.0 ≈ 389.27 * 0.6 ≈
583.91 * 0.4 ≈ 233.6 cpu·ms). The simulator's base throughput is anchored so
that one balanced 3-way MobileNetV2 partition on a 1.0-CPU node takes
234.56 ms. The batch-aware model and the layer-graph costing stay in
``repro.core.cost_model`` until the control plane is copied whole.
"""

from __future__ import annotations

from dataclasses import dataclass

# --- edge-node hardware model ----------------------------------------------

#: cost-units processed per millisecond per 1.0 CPU. Calibrated (see module
#: docstring): the average 3-way MobileNetV2 partition (44,049,952 / 3 =
#: 14,683,317 cost units) takes 234.56 ms on a 1.0-CPU node (Table II),
#: net of the fixed per-inference overhead.
BASE_THROUGHPUT = 14_683_317.33 / (234.56 - 2.0)  # ~63,138 cost-units/ms/cpu

#: memory-pressure exponent: working sets above the node's memory limit slow
#: execution superlinearly (swap/thrash) — the paper's own observation that
#: "reduced memory had a more significant impact ... than CPU".
MEM_PRESSURE_ALPHA = 1.5

#: fixed per-inference overhead (interpreter, dispatch), ms
FIXED_OVERHEAD_MS = 2.0


@dataclass(frozen=True)
class NodeProfile:
    """Provisioned resources of one edge device (the paper's cgroup
    limits plus bridge-network link parameters)."""
    cpu: float           # CPU fraction (1.0 == one core)
    mem_mb: float
    net_latency_ms: float = 1.0
    net_bw_mbps: float = 800.0    # bridge-network bandwidth

    @property
    def mem_bytes(self) -> float:
        """Memory limit in bytes."""
        return self.mem_mb * 1024 * 1024


# paper resource profiles (§IV-A)
PROFILES = {
    "high": NodeProfile(cpu=1.0, mem_mb=1024),
    "medium": NodeProfile(cpu=0.6, mem_mb=512),
    "low": NodeProfile(cpu=0.4, mem_mb=512),
    "monolithic": NodeProfile(cpu=2.0, mem_mb=2048),
}


def execution_ms(cost: float, profile: NodeProfile, working_set_bytes: float = 0.0,
                 *, threads: float = 1.0) -> float:
    """Simulated execution time of ``cost`` units on a node.

    ``threads``: effective parallelism of the runtime on this node (the
    paper's PyTorch inference is effectively single-threaded per request, so
    callers use min(cpu, 1.0) unless modeling batch-parallel runtimes).
    """
    eff_cpu = min(profile.cpu, threads)
    t = cost / (BASE_THROUGHPUT * eff_cpu) + FIXED_OVERHEAD_MS
    if working_set_bytes > profile.mem_bytes:
        t *= (working_set_bytes / profile.mem_bytes) ** MEM_PRESSURE_ALPHA
    return t


def transfer_ms(num_bytes: float, profile: NodeProfile) -> float:
    """Network transfer time for a partition boundary activation."""
    if num_bytes <= 0:
        return 0.0
    return profile.net_latency_ms + num_bytes * 8.0 / (profile.net_bw_mbps * 1e3)


def link_rate_bits_per_ms(profile: NodeProfile) -> float:
    """Link drain rate in bits per millisecond — the denominator of
    :func:`transfer_ms`'s bandwidth term, exposed as the capacity the
    shared fabric (``core.fabric``) divides among concurrent flows. Using
    the identical expression keeps the fluid model's solo-flow progress
    consistent with the isolated per-message charge."""
    return profile.net_bw_mbps * 1e3
