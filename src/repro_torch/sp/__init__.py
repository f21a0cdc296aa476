"""Sequence parallelism.  Only the §5.3 strategy planner is ported so far;
the gang-SP runner waits for ROADMAP Queue A7."""
from repro_torch.sp.planner import (A100_40G, TPU_V5E, HardwareSpec, SPPlan,
                                    plan_fast_sp)
