"""Sequence parallelism (paper §5.3): the LSE merge and the single-controller
`GangMesh`, ring attention, the inner a2a / all-gather layouts, the hybrid
fast SP, distributed decode, the gang-SP prefill runner and the strategy
planner."""
from repro_torch.sp.common import GangMesh, finalize, merge_partials
from repro_torch.sp.decode import distributed_decode_attention
from repro_torch.sp.gang import (GangPrefillState, GangSPRunner, gang_degree,
                                 make_gang_mesh, plan_for_gang)
from repro_torch.sp.hybrid import fast_sp_attention, fast_sp_attention_local
from repro_torch.sp.inner import a2a_attention, allgather_attention
from repro_torch.sp.planner import (A100_40G, TPU_V5E, HardwareSpec, SPPlan,
                                    plan_fast_sp, ring_hop_time, stage_costs)
from repro_torch.sp.ring import ring_attention_local
