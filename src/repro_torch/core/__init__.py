"""AMP4EC control plane, the part the serving slice runs: the simulated
cluster, the Resource Monitor and the Task Scheduler (NSA), copied from
``repro.core`` so that the port imports without JAX."""

from repro_torch.core.cluster import (EdgeCluster, EdgeNode, make_paper_cluster,
                                      make_synthetic_cluster)
from repro_torch.core.cost_model import NodeProfile, PROFILES
from repro_torch.core.monitor import NodeStats, ResourceMonitor
from repro_torch.core.scheduler import TaskRequirements, TaskScheduler

__all__ = [
    "EdgeCluster", "EdgeNode", "make_paper_cluster", "make_synthetic_cluster",
    "NodeProfile", "PROFILES", "NodeStats", "ResourceMonitor",
    "TaskRequirements", "TaskScheduler",
]
