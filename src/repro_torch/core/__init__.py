"""The scheduling brain: copies of the reference's ``core`` modules that the
serving path needs (policies, simulator, cost model, coordinator)."""
from repro_torch.core.backend import ExecutionBackend, SimBackend
from repro_torch.core.cluster import ClusterConfig, ClusterIndex, build_replicas
from repro_torch.core.coordinator import CoordinatorConfig, RoleCoordinator
from repro_torch.core.costmodel import ExecutionModel, ReplicaSpec
from repro_torch.core.metrics import MetricsAccumulator, summarize
from repro_torch.core.request import Phase, Request
from repro_torch.core.schedulers import POLICY_NAMES, BasePolicy, make_policy
from repro_torch.core.simulator import Simulator, Work
