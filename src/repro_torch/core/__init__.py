"""AMP4EC core: the paper's contribution as a composable library.

Components (paper §III):
  A. ResourceMonitor       — repro_torch.core.monitor
  B. ModelPartitioner      — repro_torch.core.partitioner
  C. TaskScheduler (NSA)   — repro_torch.core.scheduler
  D. ModelDeployer (+cache)— repro_torch.core.deployer / repro_torch.core.cache
  E. AdaptationController  — repro_torch.core.adaptation (closed monitor ->
     partitioner -> deployer loop: live re-partitioning on drift)

plus the simulated heterogeneous cluster (repro_torch.core.cluster), the
calibrated cost/timing model (repro_torch.core.cost_model), the end-to-end
pipeline runtime (repro_torch.core.pipeline), the event-driven request
engine (repro_torch.core.engine: overlapped transfers, micro-batching, 100k+
request streams), and the multi-tenant serving core (repro_torch.core.tenancy:
tenants sharing one cluster, cross-model arbitration, partial
migrations).

A numpy copy of ``repro.core``, so that the port imports without JAX.
"""

from repro_torch.core.adaptation import (AdaptationConfig, AdaptationController,
                                   ScenarioEvent, cpu_throttle, jitter_events,
                                   latency_spike, node_death, node_recovery)
from repro_torch.core.cache import ResultCache
from repro_torch.core.cluster import (EdgeCluster, EdgeNode, make_paper_cluster,
                                make_synthetic_cluster)
from repro_torch.core.cost_model import NodeProfile, PROFILES
from repro_torch.core.deployer import ModelDeployer
from repro_torch.core.engine import (EngineConfig, MultiTenantEngine,
                               PipelineEngine)
from repro_torch.core.fabric import FairShareFabric, maxmin_rates
from repro_torch.core.monitor import NodeStats, ResourceMonitor
from repro_torch.core.partitioner import ModelPartitioner, Partition, PartitionPlan
from repro_torch.core.pipeline import DistributedInference, RunReport, run_monolithic
from repro_torch.core.planner import (NodeView, PartitionPlanner, PlannerConfig,
                                PlanResult, TenantPlanSpec,
                                node_views_from_cluster,
                                node_views_from_stats, plan_tenants)
from repro_torch.core.scheduler import TaskRequirements, TaskScheduler
from repro_torch.core.tenancy import (CrossTenantArbiter, MultiTenantReport,
                                Tenant, TenantRegistry, TenantTraffic)
from repro_torch.core.traffic import (ArrivalProcess, BurstyArrivals,
                                DeterministicArrivals, PoissonArrivals,
                                TraceArrivals, adaptive_k)

__all__ = [
    "AdaptationConfig", "AdaptationController", "ScenarioEvent",
    "cpu_throttle", "jitter_events", "latency_spike", "node_death",
    "node_recovery",
    "ResultCache", "EdgeCluster", "EdgeNode", "make_paper_cluster",
    "make_synthetic_cluster", "NodeProfile", "PROFILES", "ModelDeployer",
    "EngineConfig", "MultiTenantEngine", "PipelineEngine",
    "FairShareFabric", "maxmin_rates",
    "NodeStats", "ResourceMonitor", "ModelPartitioner", "Partition",
    "PartitionPlan", "DistributedInference", "RunReport", "run_monolithic",
    "NodeView", "PartitionPlanner", "PlannerConfig", "PlanResult",
    "TenantPlanSpec", "node_views_from_cluster", "node_views_from_stats",
    "plan_tenants",
    "TaskRequirements", "TaskScheduler",
    "CrossTenantArbiter", "MultiTenantReport", "Tenant", "TenantRegistry",
    "TenantTraffic",
    "ArrivalProcess", "BurstyArrivals", "DeterministicArrivals",
    "PoissonArrivals", "TraceArrivals", "adaptive_k",
]
