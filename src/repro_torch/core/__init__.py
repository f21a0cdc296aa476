from repro_torch.core.arrivals import ARRIVAL_PROCESSES, make_arrivals
from repro_torch.core.backend import ExecutionBackend, SimBackend
from repro_torch.core.cluster import ClusterConfig, ClusterIndex, build_replicas
from repro_torch.core.coordinator import CoordinatorConfig, RoleCoordinator
from repro_torch.core.costmodel import ExecutionModel, ReplicaSpec
from repro_torch.core.metrics import MetricsAccumulator, summarize
from repro_torch.core.predictor import (PREDICTOR_NAMES, AdversarialPredictor,
                                  BucketedNoisyPredictor, OraclePredictor,
                                  Predictor, TraceHistoryPredictor,
                                  make_predictor)
from repro_torch.core.request import Phase, Request
from repro_torch.core.scenarios import SCENARIOS, get_scenario, list_scenarios
from repro_torch.core.schedulers import (POLICY_NAMES, BasePolicy, FIFOPolicy,
                                   PecSchedCachePolicy, PecSchedPolicy,
                                   PredSJFPolicy, PriorityPolicy,
                                   ReservationPolicy, TailAwarePolicy,
                                   make_policy)
from repro_torch.core.simulator import EventHeap, Simulator, Work
from repro_torch.core.trace import (TraceConfig, generate_trace, load_trace_csv,
                              save_trace_csv, trace_stats)
from repro_torch.core.workload import (calibrate_short_capacity, experiment_trace,
                                 paper_cluster)
