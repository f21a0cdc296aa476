"""Execution backends: one scheduling brain, two execution worlds.

Policies (core/schedulers.py) never execute anything themselves — they issue
abstract commands against an `ExecutionBackend`:

    backend.submit(work)   start a unit of Work; the backend decides when
                           (and, for real engines, how) it completes
    backend.cancel(work)   revoke an in-flight Work (preemption §5.1)

and they learn about the world only through the event hooks the shared
`Simulator` driver calls (`on_arrival`, `on_done`, `dispatch`).  Two
backends implement the protocol:

* `SimBackend` (here): the analytic world.  A Work's completion is
  scheduled at ``start + duration`` where ``duration`` is the policy's
  roofline estimate (costmodel.ExecutionModel).  This is the original
  discrete-event simulator behaviour, preserved verbatim — it carries the
  100 K-request benchmark and every paper-claim test.

* `EngineBackend` (repro/serving/backend.py): the real world.  Each
  replica id maps to a `ReplicaEngine` running genuine JAX compute;
  prefill runs layer-granular quanta (preemptible, §5.1), short KV
  migrates to the decode replica via `admit` (§5.2), and the virtual
  clock advances by *measured* compute time.  It also offers an
  ``analytic`` clock mode that keeps the Sim timeline (so decisions are
  bit-identical across backends — the parity harness in
  tests/test_backends.py relies on this) while still executing every
  command on real engines.

Work protocol: every Work carries, beyond its `kind` (short_prefill,
short_prefill_coloc, short_decode[_inplace], short_full, long_prefill,
long_decode, long_full), the `sp_mode` the policy planned it with —
"local", "ring", or "fastsp".  SimBackend ignores it (the mode is already
priced into `duration`); EngineBackend gang-schedules a multi-replica
``long_prefill`` with sp_mode="fastsp" onto a real shard_map SP mesh
(§5.3) and runs everything else single-replica.

The split means every `make_policy` name and every `get_scenario` workload
runs on both worlds with zero per-policy glue.

Work lifecycle, end to end:

    1. policy builds ``Work(wid, kind, replica_ids, requests, start,
       duration, ...)`` — `duration` is its cost-model estimate, `sp_mode`
       the sequence-parallel plan ("local"|"ring"|"fastsp"), and
       `token_budget` (decode works) the per-round token allowance the
       policy granted
    2. ``backend.submit(work)`` — SimBackend schedules DONE at
       ``start + duration``; EngineBackend starts real quanta
    3. the Simulator pops the completion and calls ``policy.on_done`` —
       or the policy preempts first via ``backend.cancel(work)`` and the
       pending completion never fires
    4. under churn, ``backend.reclaim_replica`` parks any KV physically
       resident on a dying replica so migrated requests can resume on a
       survivor

Worked example — replay a small scenario under FIFO on the analytic
backend (the default), then the same decisions on real engines::

    from repro_torch.core import Simulator, get_scenario, make_policy
    from repro_torch.core.workload import paper_cluster

    cc, em = paper_cluster("mistral_7b")
    reqs = get_scenario("azure_default", n_requests=100, seed=0,
                        arrival_rps=2.0)
    res = Simulator(make_policy("fifo", cc, em)).run(reqs)   # SimBackend
    res["short_qd_pct"]["99"]          # paper Fig 2/3 headline metric

    # same policy, real JAX engines (see repro/serving/backend.py):
    #   Simulator(policy, backend=EngineBackend(cfg, params,
    #                                           clock="analytic"))
"""
from __future__ import annotations

from repro_torch.core.spans import Tracer


class ExecutionBackend:
    """Protocol base.  A backend owns the *execution* semantics of Work;
    the Simulator owns the event loop; the policy owns the decisions."""

    #: True if the driver must call `finish(t, work)` right before the
    #: policy's on_done (backends that execute lazily at completion time).
    needs_finish = False

    def __init__(self):
        #: spans and counters of everything run through this backend; the
        #: Simulator times its policy decisions on it too (core/spans.py)
        self.tracer = Tracer()

    def bind(self, sim) -> None:
        self.sim = sim

    # -- commands issued by policies -----------------------------------
    def submit(self, work) -> None:
        """Schedule `work`; the backend decides its completion time."""
        raise NotImplementedError

    def cancel(self, work) -> bool:
        """Revoke a pending completion (preemption). O(1)."""
        return self.sim.cancel(work)

    def decode_inline(self, work) -> None:
        """The policy finished `work`'s requests with decode modeled inline
        (the /Dis colocated path) — no separate decode Work will follow.
        Analytic backends need no action; real backends run the decode now
        so generations complete and parked KV is released."""

    def role_change(self, t: float, rid: int, old_role: str,
                    new_role: str) -> None:
        """The coordinator flipped replica `rid`'s serving role (§5.2
        load-adaptive coordination).  For analytic backends the flip is
        pure scheduling state — nothing to do.  Real backends verify the
        safe point actually held on the hardware: the engine must be
        drained (no live decode slots, no resident gang KV) before its
        replica may serve under a different role."""

    def reclaim_replica(self, t: float, rid: int) -> dict:
        """Replica `rid` is being reclaimed (spot eviction): park any KV
        physically resident on it so migrated requests can resume
        elsewhere, and drop its prefix cache.  The policy has already
        evacuated its *scheduling* state via `on_reclaim`.  Analytic
        backends hold no physical state — the cost model priced the
        migration — so the base answer is an empty summary."""
        return {}

    # -- driver hooks ---------------------------------------------------
    def on_event(self, t: float, kind: str, payload) -> None:
        """Handle a backend-internal event kind (e.g. an engine quantum)."""
        raise ValueError(f"backend got unknown event kind {kind!r}")

    def finish(self, t: float, work) -> None:
        """Called before policy.on_done when `needs_finish` is True."""

    def reset(self) -> None:
        """Clear per-run state so the backend can drive a fresh policy."""

    def prefix_cache_stats(self) -> dict:
        """Prefix-cache counters of the execution substrate (block-hash
        lookups, hits, blocks shared, copy-on-write forks).  The analytic
        backend has no physical cache — routing-level counters live on the
        policy (`prefix_stats`) — so the base answer is empty; the engine
        backend aggregates its paged pools' real counters."""
        return {}


class SimBackend(ExecutionBackend):
    """Analytic execution: completion fires at ``start + duration`` where
    duration is the policy's cost-model estimate.  No real compute."""

    def submit(self, work) -> None:
        self.sim.push(work.start + work.duration, "DONE", work)
