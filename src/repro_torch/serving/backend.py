"""EngineBackend: the real-execution half of the ExecutionBackend split, on
PyTorch `ReplicaEngine`s (the port of the reference's ``serving/backend.py``).

Every abstract command a policy issues (core/schedulers.py) is carried out
on genuine engines:

* ``short_prefill`` / ``short_full`` / ``long_full`` / ``*_decode`` run to
  completion the moment they are submitted (no policy preempts them), and
  the measured compute time becomes the Work's duration.  A short's fresh
  prefill runs every layer in one timed call: on the card one replay of the
  bucket's captured graph (`engine.PrefillGraphs`), which `warmup` captures.
* ``long_prefill`` and ``long_decode`` are *preemptible*: they advance one
  quantum at a time through backend-internal ``ENGINE_STEP`` events
  (layers_per_quantum layers per step for prefill — the §5.1 suspension
  state — one decode iteration per step for decode), so a policy can pause
  them mid-flight and resume exactly from the saved `PrefillState` / slot.
* Short-request KV migrates to the decode replica through `admit` (§5.2);
  decode is slot-chunked, so a burst larger than `max_slots` waits for
  evictions instead of crashing (`SlotsFull`).

Gang-scheduled fast SP (§5.3, the paper's third technique): when a policy
starts a multi-replica ``long_prefill`` with ``sp_mode="fastsp"``, the
backend *gangs* the group — it maps the claimed replicas onto a (ring, sp)
`GangMesh` over `sp_devices` (`sp/gang.py`), runs the hybrid SP attention
(outer ring, inner a2a/allgather per the planner's `SPPlan.inner_impl`, B1
as every hop's local attention on the card) quantum by quantum with
preemption points in between, and on completion scatters the sequence-
sharded KV back into the home replica's paged pool (`scatter_kv`), where
decode picks it up.  A gang quantum covers ``layers_per_quantum x degree``
layers, so the prefill completes in ~degree x fewer engine quanta.
Per-degree measured seconds per layer accumulate in ``sp_timings`` and
feed `calibrate_costmodel`.  `gang_degree` clips a claim to the count of
`sp_devices` — by default every visible card on CUDA and one CPU device
on the CPU — so on a one-card host the long runs the single-replica path,
as the reference does on a one-device host; ``sp_mode="ring"`` (the /FSP
ablation and all baselines) always does.

Two virtual-clock modes:

* ``clock="measured"`` (default): completion times are the measured compute
  seconds, synchronised with the card before the clock is read.
* ``clock="analytic"``: completion times come from the policy's cost-model
  estimate, exactly like SimBackend, while every command still executes on
  real engines — the cross-backend decision-parity mode.

Unless a `token_provider` supplies actual prompts (the MiniCluster path),
prompts are synthesised deterministically per rid with a log-scaled,
bucketed length, as the reference does.
"""
from __future__ import annotations

import math
import time
from collections import Counter, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import ExecutionBackend
from repro_torch.core.request import Request
from repro_torch.core.simulator import Work
from repro_torch.hardware import H100_SXM, resolve_device
from repro_torch.serving.engine import (PrefillGraphs, PrefillState,
                                        ReplicaEngine, SlotsFull)
from repro_torch.sp.gang import (GangPrefillState, GangSPRunner, gang_degree,
                                 make_gang_mesh, plan_for_gang)
from repro_torch.sp.planner import HardwareSpec

# kinds that no policy ever cancels: execute eagerly at submit time
# (`pred_decode` rounds end at their own preemption point)
_EAGER_KINDS = ("short_prefill", "short_prefill_coloc", "short_decode",
                "short_decode_inplace", "short_full", "long_full",
                "pred_decode")
_PREEMPTIBLE_KINDS = ("long_prefill", "long_decode")

# synthesized-prompt length buckets (bounded set of shapes per engine)
_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Park KV in host memory as numpy (bf16, which numpy lacks, widens to
    f32 exactly and narrows back exactly in `_from_host`)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class EngineBackend(ExecutionBackend):
    """Drive any `make_policy` policy over real PyTorch ReplicaEngines."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 128,
                 layers_per_quantum: int = 2, max_slots: int = 8,
                 clock: str = "measured", max_new_cap: int = 4,
                 token_provider: Optional[Callable[[Request],
                                                   Optional[np.ndarray]]] = None,
                 seed: int = 0, enable_sp: bool = True,
                 sp_degree_cap: int = 0, device="cuda",
                 sp_devices: Optional[Sequence] = None,
                 hw: HardwareSpec = H100_SXM):
        assert clock in ("measured", "analytic"), clock
        super().__init__()
        self.device = resolve_device(device)
        #: the devices a gang's ranks run on (several ranks may share one);
        #: by default every visible card on CUDA, one CPU device on the CPU
        if sp_devices is None:
            sp_devices = ([torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
                          if self.device.type == "cuda" else ["cpu"])
        self.sp_devices = [resolve_device(d) for d in sp_devices]
        #: the hardware the gang planner prices its strategies on
        self.hw = hw
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.lpq = layers_per_quantum
        self.max_slots = max_slots
        self.clock = clock
        self.max_new_cap = max_new_cap
        self.token_provider = token_provider
        self.seed = seed
        self.enable_sp = enable_sp
        self.sp_degree_cap = sp_degree_cap
        self.needs_finish = clock == "analytic"
        self.max_prompt = max(4, max_len - min(max_new_cap, 32) - 1)
        self._buckets = [b for b in _BUCKETS if b <= self.max_prompt]
        self._engines: Dict[int, ReplicaEngine] = {}      # replica rid -> engine
        self._tokens: Dict[int, np.ndarray] = {}          # request rid -> prompt
        # prefix-group token streams (shared leading tokens per group)
        self._group_streams: Dict[int, np.ndarray] = {}
        self._psessions: Dict[int, PrefillState] = {}     # in-flight prefills
        self._gangs: Dict[int, GangPrefillState] = {}     # in-flight gang SP
        self._dsessions: Dict[int, Dict] = {}             # in-flight long decodes
        self._kv: Dict[int, PrefillState] = {}            # prefilled, not decoded
        self._resident: Dict[int, int] = {}               # rid -> home replica
        self._parked_scatter: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # decode-lane preemption (sjf_pred/tail_aware): host-side parked KV
        # of evicted decode lanes, and cluster-token decode progress per rid
        self._parked_decode: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._pdone: Dict[int, int] = {}
        self._gang_runners: Dict[Tuple[int, str], GangSPRunner] = {}
        #: the whole-stack prefill graphs every engine shares (an engine
        #: replays them on the card only)
        self.graphs = PrefillGraphs(cfg, params, device=self.device,
                                    max_len=max_len, tracer=self.tracer)
        #: moe: the experts' tally the graphs and every engine share
        self.tally = self.graphs.tally
        self.generated: Dict[int, List[int]] = {}         # request rid -> tokens
        #: counters and span totals (`tracer.stats`, core/spans.py): a span
        #: ``name`` keeps ``name:n``, ``name:ns``, ``name:self_ns`` and
        #: ``name:wait_ns``
        self.stats = self.tracer.stats
        self.measured_s = 0.0
        #: measured seconds spent in decode iterations (decode tokens/s)
        self.decode_s = 0.0
        #: degree -> measured seconds per layer (1 = single-replica path)
        self.sp_timings: Dict[int, List[float]] = {}

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Clear per-run state; engines, gang runners and sp_timings
        survive."""
        for eng in self._engines.values():
            eng.clear()
        self._tokens.clear()
        self._psessions.clear()
        self._gangs.clear()
        self._dsessions.clear()
        self._kv.clear()
        self._resident.clear()
        self._parked_scatter.clear()
        self._parked_decode.clear()
        self._pdone.clear()
        self.generated.clear()
        self.tracer.reset()
        if self.tally is not None:
            self.tally.reset()
        self.measured_s = 0.0
        self.decode_s = 0.0

    def prompt_len(self, req: Request) -> int:
        """Engine-side prompt length this request will execute with."""
        if self.token_provider is not None:
            toks = self.token_provider(req)
            if toks is not None:
                return int(np.asarray(toks).shape[0])
        return self._scale_len(req.input_len)

    def warmup(self, lengths, replica_ids) -> None:
        """Build the kernels and run one prefill + decode per prompt length
        on the given replicas, and on the card capture the whole-stack
        prefill graph of every bucket a prompt runs at, so kernel builds,
        captures and first-call costs stay off the measured clock."""
        for rid in replica_ids:
            eng = self._engine(rid)
            for n in sorted(set(lengths)):
                st = eng.start_prefill(-1, torch.zeros((1, int(n)),
                                                       dtype=torch.long))
                done = False
                while not done:
                    st, done = eng.prefill_quantum(st)
                eng.prefill_logits(st)
                slot = eng.admit(-1, st)
                eng.decode_iteration({slot: 0})
                eng.evict(slot)
            if eng.graphs is not None:      # one set: captured once
                eng.graphs.warm(self.max_prompt)
        self._sync()

    def warmup_gang(self, lengths, degrees, *,
                    cluster_input_len: int = 300_000) -> None:
        """Run each gang shape once per prompt length (embed, every quantum,
        logits), with the inner strategy the planner picks at
        `cluster_input_len` — the gang counterpart of `warmup`, keeping
        first-call costs off the measured clock and out of the `sp_timings`
        calibration samples."""
        for requested in sorted(set(degrees)):
            degree = gang_degree(requested, n_devices=len(self.sp_devices),
                                 cap=self.sp_degree_cap)
            if degree < 2:
                continue
            mesh = make_gang_mesh(degree, self.cfg.num_heads, self.sp_devices)
            plan = plan_for_gang(self.cfg, cluster_input_len, mesh, self.hw)
            runner = self._runner_for(degree, plan.inner_impl)
            for n in sorted(set(lengths)):
                st = runner.start(-1, np.zeros(int(n), np.int32), plan)
                done = False
                while not done:
                    st, done = runner.quantum(st, self.lpq * degree)
                runner.logits(st)
        self._sync()

    def _engine(self, rid: int) -> ReplicaEngine:
        eng = self._engines.get(rid)
        if eng is None:
            eng = ReplicaEngine(self.cfg, self.params, max_slots=self.max_slots,
                                max_len=self.max_len,
                                layers_per_quantum=self.lpq, device=self.device,
                                tracer=self.tracer, graphs=self.graphs)
            self._engines[rid] = eng
        return eng

    def _from_host(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device, getattr(torch, self.cfg.dtype))

    # ---- prompt synthesis / scaling ----------------------------------
    def _scale_len(self, n: int) -> int:
        raw = 8.0 * math.log2(1.0 + n / 256.0)
        for b in self._buckets:
            if raw <= b:
                return b
        return self.max_prompt

    def _group_stream(self, group: int) -> np.ndarray:
        s = self._group_streams.get(group)
        if s is None:
            rng = np.random.default_rng((self.seed, 0x9E3779B9,
                                         group & 0x7FFFFFFF))
            s = rng.integers(0, self.cfg.vocab_size,
                             self.max_prompt).astype(np.int32)
            self._group_streams[group] = s
        return s

    def _prompt(self, req: Request) -> np.ndarray:
        toks = self._tokens.get(req.rid)
        if toks is None:
            if self.token_provider is not None:
                toks = self.token_provider(req)
            if toks is None:
                n = self._scale_len(req.input_len)
                rng = np.random.default_rng((self.seed,
                                             req.rid & 0x7FFFFFFF))
                toks = rng.integers(0, self.cfg.vocab_size, n)
                if req.prefix_group is not None and req.prefix_len > 0:
                    p = min(self._scale_len(req.prefix_len), n)
                    toks = np.asarray(toks)
                    toks[:p] = self._group_stream(req.prefix_group)[:p]
            toks = np.asarray(toks, np.int32)
            if toks.shape[0] > self.max_len - 1:
                raise ValueError(
                    f"prompt of {toks.shape[0]} tokens exceeds engine "
                    f"max_len {self.max_len}")
            self._tokens[req.rid] = toks
        return toks

    def _target_new(self, req: Request) -> int:
        return max(1, min(self.max_new_cap, req.output_len))

    # ---- timed execution primitives ----------------------------------
    def _sync(self) -> None:
        for dev in {self.device, *self.sp_devices}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _timed(self, name: str, fn, *args):
        """Run fn and charge its wall time, synchronised with the card so the
        clock reads finished work, not enqueued work.  `name` is its span;
        the synchronise is the ``wait`` span ``<name>.sync``."""
        tr = self.tracer
        with tr.span(name):
            t0 = time.perf_counter()
            out = fn(*args)
            with tr.span(name + ".sync", wait=True):
                self._sync()
            dt = time.perf_counter() - t0
        self.measured_s += dt
        return out, dt

    def _first_token(self, logits: torch.Tensor) -> int:
        """A prefill's first token: a readback, after the timed call's
        synchronise, so its ``wait`` span reads ~0 (moe: with the experts'
        tally in the same copy)."""
        with self.tracer.span("backend.first_token", wait=True):
            if self.tally is None:
                return int(logits[0].argmax())
            return self.tally.read(logits[0].argmax(), self.tracer)[0]

    def _decode_iter(self, eng: ReplicaEngine, active: Dict[int, int]):
        """One timed decode iteration; counts its tokens and seconds."""
        out, d = self._timed("backend.decode_iteration",
                             eng.decode_iteration, active)
        self.decode_s += d
        self.stats["decode_iters"] += 1
        self.stats["decode_tokens"] += len(out)
        return out, d

    def _start_prefill(self, eng: ReplicaEngine, req: Request) -> PrefillState:
        prompt = self._prompt(req)
        host = tuple(int(t) for t in prompt)
        pk = pv = None
        if req.prefix_group is not None:
            # probe this engine's block-hash index: a hit turns the prefill
            # into a suffix-only one
            hit, pk, pv = eng.lookup_cached_prefix(host)
            self.stats["prefix_lookups"] += 1
            if hit.n_tokens:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += hit.n_tokens
        st, _ = self._timed(
            "backend.start_prefill", lambda: eng.start_prefill(
                req.rid, torch.as_tensor(prompt[None], dtype=torch.long),
                prefix_k=pk, prefix_v=pv, host_tokens=host))
        return st

    def _prefill_quanta(self, eng: ReplicaEngine, st: PrefillState,
                        target_layer: int, record: bool = False) -> float:
        dt = 0.0
        while st.layer < target_layer:
            lo = st.layer
            (_, _done), d = self._timed("backend.prefill_quantum",
                                        eng.prefill_quantum, st)
            dt += d
            self.stats["prefill_quanta"] += 1
            # degree-1 timings feed the SP calibration only for LONG prefills
            if record and st.layer > lo:
                self.sp_timings.setdefault(1, []).append(d / (st.layer - lo))
        return dt

    def _complete_prefill(self, eng: ReplicaEngine, req: Request) -> float:
        """Run remaining layers + first-token logits; park KV for decode.
        A fresh prefill that feeds no calibration (a short: nothing preempts
        it) asks for its whole stack in one timed call, which the engine runs
        as one graph replay on the card unless it reuses a prefix."""
        st = self._psessions.pop(req.rid, None)
        if st is None:
            st = self._start_prefill(eng, req)
            st.whole = not req.is_long
        dt = self._prefill_quanta(eng, st, self.cfg.num_layers,
                                  record=req.is_long)
        logits, d = self._timed("backend.prefill_logits",
                                eng.prefill_logits, st)
        dt += d
        self.generated[req.rid] = [self._first_token(logits)]
        self._kv[req.rid] = st
        if req.prefix_group is not None and st.host_tokens is not None:
            # park the full prompt KV in THIS engine's prefix cache so the
            # group's next request routed here skips the shared blocks
            # (bookkeeping copy, off the virtual clock)
            k, v = st.full_kv()
            eng.cache_prompt(0x40000000 ^ req.rid, k, v, st.host_tokens)
        return dt

    # ---- gang-scheduled SP prefill (§5.3) ----------------------------
    def _gang_degree_for(self, work: Work) -> int:
        if not self.enable_sp or work.sp_mode != "fastsp":
            return 1
        return gang_degree(len(work.replica_ids),
                           n_devices=len(self.sp_devices),
                           cap=self.sp_degree_cap)

    def _runner_for(self, degree: int, strategy: str) -> GangSPRunner:
        key = (degree, strategy)
        r = self._gang_runners.get(key)
        if r is None:
            mesh = make_gang_mesh(degree, self.cfg.num_heads, self.sp_devices)
            r = GangSPRunner(self.cfg, self.params, mesh, strategy)
            self._gang_runners[key] = r
        return r

    def _start_gang(self, req: Request, degree: int) -> GangPrefillState:
        mesh = make_gang_mesh(degree, self.cfg.num_heads, self.sp_devices)
        # strategy choice reflects the CLUSTER-scale request length — the
        # planner's four-combination search (§5.3), not the scale prompt
        plan = plan_for_gang(self.cfg, req.input_len, mesh, self.hw)
        runner = self._runner_for(degree, plan.inner_impl)
        st, _ = self._timed("backend.gang_start", runner.start, req.rid,
                            self._prompt(req), plan)
        self.stats["gang_prefills"] += 1
        return st

    def _gang_quantum(self, st: GangPrefillState) -> Tuple[bool, float]:
        """One SP quantum: lpq x degree layers at equal per-device compute."""
        runner = self._runner_for(st.degree, st.plan.inner_impl)
        lo = st.layer
        (_, done), d = self._timed("backend.gang_quantum", runner.quantum, st,
                                   self.lpq * st.degree)
        self.stats["sp_prefill_quanta"] += 1
        if st.layer > lo:
            self.sp_timings.setdefault(st.degree, []).append(
                d / (st.layer - lo))
        return done, d

    def _finish_gang(self, work: Work) -> float:
        """Remaining gang quanta + first-token logits + KV scatter back to
        the home replica's paged pool (parked host-side when the pool is
        momentarily full: the scatter retries when the decode binds)."""
        req = work.requests[0]
        st = self._gangs[req.rid]
        runner = self._runner_for(st.degree, st.plan.inner_impl)
        dt = 0.0
        while st.layer < self.cfg.num_layers:
            _, d = self._gang_quantum(st)
            dt += d
        logits, d = self._timed("backend.gang_logits", runner.logits, st)
        dt += d
        self.generated[req.rid] = [self._first_token(logits)]
        k, v = runner.gather_kv(st, self.device)
        del self._gangs[req.rid]
        home = work.replica_ids[0]
        try:
            self._engine(home).scatter_kv(req.rid, k, v)
            self._resident[req.rid] = home
            self.stats["gang_scatters"] += 1
        except SlotsFull:
            self._parked_scatter[req.rid] = (_to_host(k), _to_host(v))
            self.stats["gang_scatter_deferred"] += 1
        return dt

    def prefix_cache_stats(self) -> Dict[str, int]:
        """Pool-level prefix-cache counters summed across engines, plus the
        backend's own lookup tallies."""
        out = Counter()
        for eng in self._engines.values():
            out.update(eng.kvpool.stats)
        out["backend_lookups"] = int(self.stats.get("prefix_lookups", 0))
        out["backend_hits"] = int(self.stats.get("prefix_hits", 0))
        out["backend_hit_tokens"] = int(
            self.stats.get("prefix_hit_tokens", 0))
        return dict(out)

    def sp_per_layer_s(self) -> Dict[int, float]:
        """Median measured seconds/layer per SP degree (1 = no gang)."""
        return {d: float(np.median(v))
                for d, v in sorted(self.sp_timings.items()) if v}

    def calibrate_costmodel(self, em) -> Dict[int, float]:
        """Feed measured per-degree timings into the analytic model
        (`ExecutionModel.calibrate_sp`)."""
        m = self.sp_per_layer_s()
        if m:
            em.calibrate_sp(m)
        return m

    # ---- decode -------------------------------------------------------
    def _decode_batch(self, eng: ReplicaEngine, reqs: List[Request]) -> float:
        """Admit each request's parked KV and decode to its target length,
        chunked by free slots: a burst larger than the slot count waits for
        evictions inside the batch instead of raising through the loop."""
        dt = 0.0
        pending = deque(reqs)
        while pending:
            admitted: Dict[int, Request] = {}
            toks: Dict[int, int] = {}
            remaining: Dict[int, int] = {}
            while pending and eng.free_slots():
                r = pending.popleft()
                if r.rid not in self._kv:
                    # already decoded before churn canceled and restarted it
                    self.stats["churn_redecode_skips"] += 1
                    continue
                try:
                    slot = eng.admit(r.rid, self._kv[r.rid])
                except SlotsFull:           # lost a race with a long's slot
                    pending.appendleft(r)
                    break
                self.stats["kv_migrations"] += 1
                del self._kv[r.rid]
                admitted[slot] = r
                toks[slot] = self.generated[r.rid][-1]
                remaining[slot] = self._target_new(r) - 1
            if not admitted:
                if not pending:             # everything was a churn skip
                    break
                raise SlotsFull(
                    "decode pool wedged: no slot frees up for "
                    f"{len(pending)} pending requests")
            while True:
                active = {s: toks[s] for s, n in remaining.items() if n > 0}
                if not active:
                    break
                out, d = self._decode_iter(eng, active)
                dt += d
                for s, tok in out.items():
                    self.generated[admitted[s].rid].append(tok)
                    toks[s] = tok
                    remaining[s] -= 1
            for s in admitted:
                eng.evict(s)
        return dt

    def _pred_decode_round(self, eng: ReplicaEngine, work: Work) -> float:
        """One budgeted decode-lane round for the prediction-aware policies
        (see the reference's docstring): cluster-token progress maps onto
        the engine's capped token target proportionally, the FINAL round
        always decodes to the full target, and a non-final round parks the
        lane's KV host-side and releases its blocks."""
        req = work.requests[0]
        rid = req.rid
        budget = int(work.token_budget or 0)
        done = self._pdone.get(rid, 1)          # prefill emitted token 1
        done_after = done + budget
        final = done_after >= req.output_len
        T = self._target_new(req)
        goal = T if final else min(
            T - 1, 1 + int((T - 1) * done_after / max(req.output_len, 1)))
        if rid in self._kv:
            slot = eng.admit(rid, self._kv[rid])
            del self._kv[rid]
            self.stats["kv_migrations"] += 1
        elif rid in self._parked_decode:
            k, v = self._parked_decode.pop(rid)
            eng.scatter_kv(rid, self._from_host(k), self._from_host(v))
            slot = eng.bind_slot(rid)
            self.stats["decode_readmits"] += 1
        else:
            # the final round already ran before churn re-queued the request
            self.stats["churn_redecode_skips"] += 1
            return 0.0
        dt = 0.0
        last = self.generated[rid][-1]
        for _ in range(max(goal - len(self.generated[rid]), 0)):
            out, d = self._decode_iter(eng, {slot: last})
            dt += d
            last = out[slot]
            self.generated[rid].append(last)
        if final:
            eng.evict(slot)
            self._pdone.pop(rid, None)
        else:
            # decode-lane preemption at a step boundary: park host-side,
            # release the blocks for the lane's next tenant
            k, v = eng.kvpool.gather(rid)
            self._parked_decode[rid] = (_to_host(k), _to_host(v))
            eng.evict(slot)
            self._pdone[rid] = done_after
            self.stats["decode_preemptions"] += 1
        return dt

    def _bind_long_decode(self, req: Request, work_rid: int) -> None:
        """Install the long's decode session from whichever KV path its
        prefill took: a parked PrefillState, pool-resident blocks, or a
        host-side parked copy.  State is consumed only AFTER the step that
        needs it succeeds, so a SlotsFull here leaves everything in place
        for a retried submit."""
        if req.rid in self._kv:
            eng = self._engine(work_rid)
            slot = eng.admit(req.rid, self._kv[req.rid])
            del self._kv[req.rid]
            self.stats["kv_migrations"] += 1
            home = work_rid
        else:
            if req.rid in self._parked_scatter:
                k, v = self._parked_scatter[req.rid]
                eng = self._engine(work_rid)
                eng.scatter_kv(req.rid, self._from_host(k), self._from_host(v))
                del self._parked_scatter[req.rid]
                self._resident[req.rid] = work_rid
            if req.rid not in self._resident:
                return                       # prefill never ran (defensive)
            home = self._resident[req.rid]
            slot = self._engine(home).bind_slot(req.rid)
            del self._resident[req.rid]
        self._dsessions[req.rid] = {
            "slot": slot, "home": home,
            "last": self.generated[req.rid][-1],
            "remaining": max(
                self._target_new(req) - len(self.generated[req.rid]), 0)}

    # ---- eager kinds --------------------------------------------------
    def _execute(self, work: Work) -> float:
        eng = self._engine(work.replica_ids[0])
        kind = work.kind
        dt = 0.0
        if kind in ("short_prefill", "short_prefill_coloc"):
            for r in work.requests:
                dt += self._complete_prefill(eng, r)
        elif kind in ("short_decode", "short_decode_inplace"):
            dt += self._decode_batch(eng, work.requests)
        elif kind in ("short_full", "long_full"):
            for r in work.requests:
                dt += self._complete_prefill(eng, r)
            dt += self._decode_batch(eng, work.requests)
        elif kind == "pred_decode":
            dt += self._pred_decode_round(eng, work)
        else:                               # pragma: no cover - guarded by submit
            raise ValueError(kind)
        self.stats[kind] += 1
        return dt

    # ------------------------------------------------------------------
    # ExecutionBackend interface
    # ------------------------------------------------------------------
    # Each entry point that runs engine work is a span of its own (a Work's
    # named by its kind), so the simulator's ``sched.decide`` self time
    # leaves the engines out.
    def submit(self, work: Work) -> None:
        with self.tracer.span("backend.submit." + work.kind):
            self._submit(work)

    def _submit(self, work: Work) -> None:
        t = work.start
        if work.kind in _EAGER_KINDS:
            measured = self._execute(work)
            if self.clock == "measured":
                work.duration = measured
            self.sim.push(t + work.duration, "DONE", work)
            return
        if work.kind not in _PREEMPTIBLE_KINDS:
            raise ValueError(f"unknown work kind {work.kind!r}")
        req = work.requests[0]
        eng = self._engine(work.replica_ids[0])
        if work.kind == "long_prefill":
            degree = self._gang_degree_for(work)
            started = (req.rid in self._psessions or req.rid in self._gangs
                       or req.rid in self._kv or req.rid in self._resident
                       or req.rid in self._parked_scatter)
            if not started:
                if degree >= 2:
                    self._gangs[req.rid] = self._start_gang(req, degree)
                else:
                    self._psessions[req.rid] = self._start_prefill(eng, req)
        else:                               # long_decode
            if req.rid not in self._dsessions:
                self._bind_long_decode(req, work.replica_ids[0])
        if self.clock == "analytic":
            self.sim.push(t + work.duration, "DONE", work)
        else:
            self.sim.push(t, "ENGINE_STEP", work)

    def decode_inline(self, work: Work) -> None:
        """/Dis colocated shorts finish with decode modelled inline by the
        policy; run that decode for real so generations complete and the
        parked KV is released (off the virtual clock)."""
        with self.tracer.span("backend.decode_inline"):
            self._decode_batch(self._engine(work.replica_ids[0]),
                               work.requests)

    def role_change(self, t: float, rid: int, old_role: str,
                    new_role: str) -> None:
        """Verify a coordinator role flip against the real engine: a live
        decode slot or resident (gang-scattered) KV on the flipping engine
        means the policy flipped mid-work — fail loudly."""
        eng = self._engines.get(rid)
        if eng is not None:
            live = [r for r in eng.slot_rid if r is not None]
            resident = [req_rid for req_rid, home in self._resident.items()
                        if home == rid]
            if live or resident:
                raise RuntimeError(
                    f"unsafe role flip {old_role}->{new_role} on replica "
                    f"{rid}: live decode slots {live}, resident KV "
                    f"{resident}")
        self.stats["role_flips"] += 1

    def reclaim_replica(self, t: float, rid: int) -> Dict[str, int]:
        """Spot eviction of replica `rid`: park every piece of KV physically
        resident on its engine host-side so migrated requests resume
        elsewhere (`_bind_long_decode` re-scatters it), then clear the
        engine (blocks, slots, prefix cache).  In-flight prefill sessions
        (`_psessions`, `_gangs`) hold no pool blocks and parked prefills
        (`_kv`) are engine-agnostic: both move for free at their next use."""
        eng = self._engines.get(rid)
        if eng is None:
            return {}
        with self.tracer.span("backend.reclaim"):
            return self._reclaim(rid, eng)

    def _reclaim(self, rid: int, eng: ReplicaEngine) -> Dict[str, int]:
        parked = blocks = 0
        # live long-decode sessions homed here: park mid-generation
        for req_rid in [r for r, s in self._dsessions.items()
                        if s["home"] == rid]:
            blocks += len(eng.kvpool.tables.get(req_rid, ()))
            k, v = eng.kvpool.gather(req_rid)
            self._parked_scatter[req_rid] = (_to_host(k), _to_host(v))
            del self._dsessions[req_rid]
            parked += 1
        # gang-scattered KV awaiting its decode bind
        for req_rid in [r for r, home in self._resident.items()
                        if home == rid]:
            blocks += len(eng.kvpool.tables.get(req_rid, ()))
            k, v = eng.kvpool.gather(req_rid)
            self._parked_scatter[req_rid] = (_to_host(k), _to_host(v))
            del self._resident[req_rid]
            parked += 1
        eng.clear()
        self.stats["reclaims"] += 1
        self.stats["evacuated_sessions"] += parked
        self.stats["evacuated_blocks"] += blocks
        return {"parked_sessions": parked, "evacuated_blocks": blocks}

    def cancel(self, work: Work) -> bool:
        ok = self.sim.cancel(work)
        if ok and self.clock == "analytic":
            # analytic clock executes lazily; materialise the progress this
            # Work made up to the preemption point so the resumed session
            # continues from a genuine §5.1 suspension state
            frac = 0.0
            if work.duration > 0:
                frac = min(max((self.sim.now - work.start) / work.duration,
                               0.0), 1.0)
            req = work.requests[0]
            eng = self._engine(work.replica_ids[0])
            if work.kind == "long_prefill":
                st = self._psessions.get(req.rid)
                gst = self._gangs.get(req.rid)
                if st is not None:
                    left = self.cfg.num_layers - st.layer
                    self._prefill_quanta(eng, st,
                                         st.layer + int(frac * left),
                                         record=True)
                elif gst is not None:
                    left = self.cfg.num_layers - gst.layer
                    target = gst.layer + int(frac * left)
                    while gst.layer < target:
                        self._gang_quantum(gst)
            elif work.kind == "long_decode":
                sess = self._dsessions.get(req.rid)
                if sess is not None:
                    self._decode_steps(self._engine(sess["home"]), req, sess,
                                       int(frac * sess["remaining"]))
        return ok

    def _decode_steps(self, eng: ReplicaEngine, req: Request, sess: Dict,
                      n: int) -> float:
        dt = 0.0
        for _ in range(min(n, sess["remaining"])):
            out, d = self._decode_iter(eng, {sess["slot"]: sess["last"]})
            dt += d
            tok = out[sess["slot"]]
            self.generated[req.rid].append(tok)
            sess["last"] = tok
            sess["remaining"] -= 1
        return dt

    # ---- measured clock: quantum events ------------------------------
    def on_event(self, t: float, kind: str, work: Work) -> None:
        assert kind == "ENGINE_STEP", kind
        with self.tracer.span("backend.step." + work.kind):
            self._step(t, work)

    def _step(self, t: float, work: Work) -> None:
        req = work.requests[0]
        eng = self._engine(work.replica_ids[0])
        if work.kind == "long_prefill":
            gst = self._gangs.get(req.rid)
            if gst is not None:
                done, d = ((True, 0.0) if gst.layer >= self.cfg.num_layers
                           else self._gang_quantum(gst))
                if not done:
                    self.sim.push(t + d, "ENGINE_STEP", work)
                    return
                d += self._finish_gang(work)
                work.duration = t + d - work.start
                self.sim.push(t + d, "DONE", work)
                return
            st = self._psessions.get(req.rid)
            if st is None:                  # finished before a late preemption
                work.duration = max(t - work.start, 0.0)
                self.sim.push(t, "DONE", work)
                return
            if st.layer < self.cfg.num_layers:
                lo = st.layer
                (_, done), d = self._timed("backend.prefill_quantum",
                                           eng.prefill_quantum, st)
                self.stats["prefill_quanta"] += 1
                if st.layer > lo:          # a long on the single-replica path
                    self.sp_timings.setdefault(1, []).append(
                        d / (st.layer - lo))
            else:
                done, d = True, 0.0
            if not done:
                self.sim.push(t + d, "ENGINE_STEP", work)
                return
            logits, d2 = self._timed("backend.prefill_logits",
                                     eng.prefill_logits, st)
            self.generated[req.rid] = [self._first_token(logits)]
            self._kv[req.rid] = self._psessions.pop(req.rid)
            work.duration = t + d + d2 - work.start
            self.sim.push(t + d + d2, "DONE", work)
        else:                               # long_decode
            sess = self._dsessions.get(req.rid)
            if sess is None or sess["remaining"] <= 0:
                if sess is not None:
                    self._engine(sess["home"]).evict(sess["slot"])
                    del self._dsessions[req.rid]
                work.duration = max(t - work.start, 0.0)
                self.sim.push(t, "DONE", work)
                return
            eng = self._engine(sess["home"])
            d = self._decode_steps(eng, req, sess, 1)
            if sess["remaining"] <= 0:
                eng.evict(sess["slot"])
                del self._dsessions[req.rid]
                work.duration = t + d - work.start
                self.sim.push(t + d, "DONE", work)
            else:
                self.sim.push(t + d, "ENGINE_STEP", work)

    # ---- analytic clock: lazy completion ------------------------------
    def finish(self, t: float, work: Work) -> None:
        with self.tracer.span("backend.finish"):
            self._finish(work)

    def _finish(self, work: Work) -> None:
        if work.kind == "long_prefill":
            req = work.requests[0]
            if req.rid in self._gangs:
                self._finish_gang(work)
            elif (req.rid not in self._kv and req.rid not in self._resident
                    and req.rid not in self._parked_scatter):
                # run whatever layers remain on the single-replica path
                self._complete_prefill(self._engine(work.replica_ids[0]), req)
        elif work.kind == "long_decode":
            req = work.requests[0]
            sess = self._dsessions.pop(req.rid, None)
            if sess is not None:
                eng = self._engine(sess["home"])
                self._decode_steps(eng, req, sess, sess["remaining"])
                eng.evict(sess["slot"])
