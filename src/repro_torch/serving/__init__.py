"""Real-execution serving stack on PyTorch: `PagedKVCache` is the one KV
storage path; every `ReplicaEngine` owns one as its pool."""
from repro_torch.serving.backend import EngineBackend
from repro_torch.serving.cluster import MiniCluster, ServeRequest
from repro_torch.serving.engine import PrefillState, ReplicaEngine, SlotsFull
from repro_torch.serving.kvcache import PagedKVCache
