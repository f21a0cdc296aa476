"""Replica engine: real PyTorch execution with LAYER-GRANULAR preemptible
prefill (the port of the reference's ``serving/engine.py``).

PecSched's §5.1 preemption state ("KV of completed layers + one layer's
intermediate data") is exactly what PrefillState holds; a preempted prefill
resumes from its layer index with bit-identical results.

KV storage is block-granular: every resident request's KV lives in the
replica's `PagedKVCache`.  Decode slots are thin identities over the pool: a
slot binds a rid into the batched decode step; the dense (L, slots, KV,
S_max, hd) view the decode step consumes is gathered from the pool after a
rebinding and then updated in place by decode itself, and each new token's
KV is appended back to the pool block-granularly.

Attention runs through ``ops.attention`` / ``ops.decode_attention`` with
``impl="auto"``: the hand CUDA kernels on the card (the reference hard-codes
its plain ``"xla"`` path here), their plain versions on the CPU.

Spans (core/spans.py): each of `start_prefill`, `prefill_quantum`,
`prefill_logits`, `admit`, `evict` and `decode_iteration` is a span
``engine.<method>``, its parts ``engine.<method>.<part>``, and each copy
that waits for the card a ``wait`` span.  Only these go on a profiler's
timeline (ranges carrying request ids and shapes, which the tracer's hook
`_profiler_range` opens while a profiler is active), and every one is
named ``engine.``: a device trace reader counts device events of any other
name as work.

A prefill asked to run its whole layer stack in one call
(`PrefillState.whole`: a short, which runs to its end at submit and which
nothing preempts) runs every layer in that call, and on the card, where it
reuses no prefix and fits a bucket, as one replay of a CUDA graph
(`PrefillGraphs`): the host issues one launch in place of ~64 operations a
layer.

The engine serves the dense and moe families.  A moe layer's experts give
no rows to what is not a token (a bucket's pad rows, idle decode lanes),
and an `ExpertTally` on the card counts the experts each layer run
touched; the host counts the layer runs and rows (``moe_layer_runs.<kind>``,
``moe_rows``).
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.spans import Tracer
from repro_torch.hardware import resolve_device
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_grouped_gemm import moe_grouped_gemm
from repro_torch.models import layers as L
from repro_torch.models import model as mdl
from repro_torch.models import moe as MOE
from repro_torch.serving.kvcache import PagedKVCache, PrefixHit


def _profiler_range(name: str, args):
    """The engine tracer's `ranges` hook: while a `torch.profiler` session is
    active, a range `name` whose trace args are what `args()` returns (kept
    where the profiler records inputs, ``record_shapes=True``); else None,
    with `args` not called.  The public `record_function` drops its args
    string from the trace, so the range comes from the profiler's own fast
    binding where it exists."""
    if not torch.autograd._profiler_enabled():
        return None
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        return torch.profiler.record_function(name)
    attrs = args() if args is not None else {}
    return fast(name, (), {k: str(v) for k, v in attrs.items()})


class SlotsFull(RuntimeError):
    """A ReplicaEngine cannot admit another resident request: no free decode
    slot, or not enough free KV blocks in the paged pool.  Callers catch it
    and wait for an eviction."""


@dataclass
class PrefillState:
    """Suspension state of a paused prefill (paper §5.1).

    A prefix-cache hit makes this a SUFFIX prefill: `x` covers only the
    uncached suffix while `prefix_k`/`prefix_v` carry the reused KV gathered
    from the pool; `tokens` stays the FULL prompt."""
    rid: int
    tokens: torch.Tensor                  # (1, S) — ALWAYS the full prompt
    x: torch.Tensor                       # (1, S_suffix, d) — intermediate
    layer: int                            # next layer to execute
    kv_k: List[torch.Tensor] = field(default_factory=list)  # per layer (1,KV,S,hd)
    kv_v: List[torch.Tensor] = field(default_factory=list)
    prefix_k: Optional[torch.Tensor] = None   # (L, KV, P, hd) reused KV
    prefix_v: Optional[torch.Tensor] = None
    host_tokens: Optional[Tuple[int, ...]] = None  # full prompt, host ints
    #: run every layer in the next `prefill_quantum` call: a prefill that
    #: nothing preempts (a suffix prefill after a prefix hit keeps its
    #: per-layer quanta; on the card, one replay of a `PrefillGraphs` graph)
    whole: bool = False

    @property
    def prefix_len(self) -> int:
        return 0 if self.prefix_k is None else self.prefix_k.shape[2]

    def intermediate_bytes(self) -> int:
        return self.x.numel() * self.x.element_size()

    def kv_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.kv_k) * 2

    def full_kv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The finished prefill's full-sequence KV, (L, KV, S, hd) each."""
        k = torch.stack(self.kv_k, 0)[:, 0]
        v = torch.stack(self.kv_v, 0)[:, 0]
        if self.prefix_k is not None:        # re-assemble FULL-sequence KV
            k = torch.cat([self.prefix_k.to(k.dtype), k], dim=2)
            v = torch.cat([self.prefix_v.to(v.dtype), v], dim=2)
        return k, v


#: decode lane counts an `ExpertTally` tells apart
TALLY_LANES = 64


class ExpertTally:
    """How many experts each moe layer run gave rows to, summed on the card
    by kind of run (`moe.tally_into`), so a graph's replay counts as an
    eager run does: one int64 for prefill, then one per count of active
    decode lanes (1..TALLY_LANES).  `read` folds what was added since the
    last read into a tracer's ``moe_experts_touched.<kind>`` counters, and
    B4's launches into ``moe_grouped_gemm_launches``, on a readback the
    engine makes anyway (a token's): it adds no copy and no synchronise."""

    def __init__(self, device):
        self.t = torch.zeros(1 + TALLY_LANES, dtype=torch.long, device=device)
        self.reset()

    @staticmethod
    def kind(lanes: int) -> str:
        """The kind of a run of `lanes` decode lanes (0: a prefill)."""
        return f"decode_{lanes}" if lanes else "prefill"

    def slot(self, lanes: int) -> torch.Tensor:
        if lanes > TALLY_LANES:
            raise ValueError(f"{lanes} decode lanes: the tally holds "
                             f"{TALLY_LANES}")
        return self.t[lanes]

    def reset(self) -> None:
        """Forget every run so far (a backend's reset: the warm-up's)."""
        self.t.zero_()
        self.seen = [0] * self.t.numel()
        self.launches = moe_grouped_gemm.launches

    def read(self, head: torch.Tensor, tracer: Tracer) -> List[int]:
        """`head`'s values (int64 on the card), read in one copy with the
        tallies, which go to `tracer`."""
        n = head.numel()
        vals = torch.cat([head.reshape(n), self.t]).tolist()
        now = vals[n:]
        if now != self.seen:
            for i, (a, b) in enumerate(zip(now, self.seen)):
                if a != b:
                    tracer.count("moe_experts_touched." + self.kind(i), a - b)
            self.seen = now
        launches = moe_grouped_gemm.launches
        if launches != self.launches:
            tracer.count("moe_grouped_gemm_launches", launches - self.launches)
            self.launches = launches
        return vals[:n]


def layer_slice(cfg: ModelConfig, params, x: torch.Tensor, lo: int, hi: int,
                live: Optional[torch.Tensor] = None):
    """Layers [lo, hi) of a prefill from position 0, each with its own
    window and RoPE (`model.serve_layer`): (x, each layer's KVCache (B, KV,
    S, hd)).  live (B, S): the rows that are tokens (moe)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    kvs = []
    for li in range(lo, hi):
        x, kv = mdl.serve_layer(cfg, params, li, x, positions, live=live)
        kvs.append(kv)
    return x, kvs


#: prompt lengths a whole-stack prefill graph is captured at: geometric
#: below 1024 tokens, where a layer is bound by reading its weights and
#: padding costs little; steps of 256-512 above, where padding costs device
#: time (over the paper's length mix, 11.5 % more tokens than the prompts)
BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072,
           3584, 4096)


class PrefillGraphs:
    """The whole layer stack of one model's prefill, one CUDA graph per
    prompt-length bucket, shared by every engine serving these weights on
    this device.

    A prompt of S tokens runs at the smallest bucket b >= S: its embedded
    rows are copied into a static (1, b_max, d) input whose rows [S, b) are
    zeroed (finite K/V for the masked keys, so no 0 x NaN reaches a real
    row; causal masking, a sliding window included, keeps every real row
    independent of them), positions run 0..b-1, and each layer's
    `layer_slice` writes its K/V into one static (L, KV, b_max, hd) pair
    shared by every bucket.  `run` clones the real rows out, so nothing a
    later call reads aliases a static buffer or the graphs' memory pool.
    Replays are sequential on the caller's stream.  A capture launches B1
    (and B4) without running them, so it takes their launches off the
    kernels' counts and each replay adds them back.  moe: the count of real
    rows lies in a static scalar that `_stage` fills, so the pad rows take
    no expert, and the experts' tally (`tally`, which the engines sharing
    these graphs share) is added to inside the graph."""

    #: the hand kernels whose launches a graph holds
    KERNELS = (flash_attention, moe_grouped_gemm)

    def __init__(self, cfg: ModelConfig, params, *, device, max_len: int,
                 tracer: Tracer):
        self.cfg, self.params, self.tracer = cfg, params, tracer
        self.device = resolve_device(device)
        self.buckets = tuple(b for b in BUCKETS if b <= max_len)
        self.graphs: Dict[int, "torch.cuda.CUDAGraph"] = {}
        #: each graph's launches of each of `KERNELS`
        self._launches: Dict[int, Tuple[int, ...]] = {}
        self._bufs: Optional[Tuple[torch.Tensor, ...]] = None
        self._stream = self._pool = None
        self.tally = (ExpertTally(self.device) if cfg.family == "moe"
                      else None)

    def bucket(self, S: int) -> Optional[int]:
        """The bucket a prompt of S tokens runs at; None above the last."""
        i = bisect.bisect_left(self.buckets, S)
        return self.buckets[i] if i < len(self.buckets) else None

    def _buffers(self) -> Tuple[torch.Tensor, ...]:
        if self._bufs is None:
            cfg, b = self.cfg, self.buckets[-1]
            kw = dict(dtype=getattr(torch, cfg.dtype), device=self.device)
            kv = (cfg.num_layers, cfg.num_kv_heads, b, cfg.head_dim)
            self._bufs = (torch.zeros((1, b, cfg.d_model), **kw),
                          torch.zeros((1, b, cfg.d_model), **kw),
                          torch.zeros(kv, **kw), torch.zeros(kv, **kw),
                          torch.zeros((), dtype=torch.int32,
                                      device=self.device))
        return self._bufs

    def _body(self, b: int) -> None:
        """The captured work at bucket b: `layer_slice` a layer at a time
        over the static input's first b rows (so the pool holds one layer's
        K/V, not the stack's), each layer's K/V and the last x into the
        static outputs (moe: the rows below the staged count live, the
        experts tallied)."""
        x_in, x_out, k_out, v_out, n_live = self._buffers()
        x = x_in[:, :b]
        live = (torch.arange(b, device=x.device) < n_live)[None] \
            if self.tally is not None else None
        with MOE.tally_into(None if self.tally is None else self.tally.slot(0)):
            for i in range(self.cfg.num_layers):
                x, (kv,) = layer_slice(self.cfg, self.params, x, i, i + 1,
                                       live=live)
                k_out[i, :, :b].copy_(kv.k[0])
                v_out[i, :, :b].copy_(kv.v[0])
        x_out[:, :b].copy_(x)

    def capture(self, b: int) -> None:
        """Capture bucket b's graph."""
        if b in self.graphs:
            return
        self._buffers()
        main = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
            # a first run on the capture stream, outside any capture, sets
            # up what the stream's first kernels allocate (cuBLAS workspace)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                self._body(self.buckets[0])
        graph = torch.cuda.CUDAGraph()
        self._stream.wait_stream(main)
        before = [k.launches for k in self.KERNELS]
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                self._body(b)
            finally:
                graph.capture_end()
        main.wait_stream(self._stream)
        self._launches[b] = tuple(k.launches - n
                                  for k, n in zip(self.KERNELS, before))
        for k, n in zip(self.KERNELS, self._launches[b]):
            _build.count_launch(k, -n)
        self.graphs[b] = graph
        self.tracer.count("prefill_graph_captures")

    def warm(self, max_prompt: int) -> None:
        """Capture every bucket a prompt of up to `max_prompt` tokens runs
        at, so no capture lands on a measured clock: the largest first, so
        each smaller capture finds the blocks it needs among those the
        larger ones left in the shared pool."""
        last = self.bucket(max_prompt) or self.buckets[-1]
        for b in reversed(self.buckets[:self.buckets.index(last) + 1]):
            self.capture(b)

    def _stage(self, x: torch.Tensor) -> int:
        """Copy x (1, S, d) into the static input, its pad rows up to the
        bucket zeroed; the bucket."""
        S = x.shape[1]
        b = self.bucket(S)
        x_in, *_, n_live = self._buffers()
        x_in[:, :S].copy_(x)
        x_in[:, S:b].zero_()
        if self.tally is not None:
            n_live.fill_(S)
        return b

    def _real_rows(self, S: int):
        """Clones of the static outputs' first S rows: (x, K, V)."""
        _, x_out, k_out, v_out, _ = self._buffers()
        return (x_out[:, :S].clone(), k_out[:, :, :S].clone(),
                v_out[:, :, :S].clone())

    def run(self, x: torch.Tensor):
        """Every layer over x (1, S, d), S <= the last bucket, as one replay:
        the real rows' (x (1, S, d), K (L, KV, S, hd), V), fresh tensors."""
        b = self._stage(x)
        self.capture(b)                 # lazily, where no warm-up ran
        self.graphs[b].replay()
        for k, n in zip(self.KERNELS, self._launches[b]):
            _build.count_launch(k, n)
        return self._real_rows(x.shape[1])


class ReplicaEngine:
    """One model replica: preemptible prefill + slot-batched decode over a
    paged KV pool, on `device` (CUDA unless the caller passes "cpu")."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 max_len: int = 512, layers_per_quantum: int = 2,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 device="cuda", tracer: Optional[Tracer] = None,
                 graphs: Optional[PrefillGraphs] = None):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError("the engine serves the dense and moe "
                                      "families; the others run through the "
                                      "model API (launch/quickstart.py)")
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else Tracer()
        self.tracer.ranges = _profiler_range
        self.cfg = cfg
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.lpq = layers_per_quantum
        KV, hd, nl = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
        self.dtype = getattr(torch, cfg.dtype)
        self.block_size = block_size
        self.blocks_per_seq = -(-max_len // block_size)
        # Pool invariant: a BOUND slot reserves its full max_len block budget
        # at admission, so decode-time appends never run out of blocks;
        # default sizing = every slot's budget + one spare sequence for a
        # slotless resident awaiting its decode slot.
        self.kvpool = PagedKVCache.create(
            nl, n_blocks if n_blocks is not None
            else (max_slots + 1) * self.blocks_per_seq, KV, block_size,
            hd, self.dtype, device=self.device, tracer=self.tracer)
        self.slot_rid: List[Optional[int]] = [None] * max_slots
        self._view: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        #: the whole-stack prefill graphs the caller shares, used on the card
        #: only (None: every prefill runs eagerly)
        self.graphs = graphs if self.device.type == "cuda" else None
        #: moe: the experts' tally, the graphs' where the caller shares some
        self.tally = (None if cfg.family != "moe" else graphs.tally
                      if graphs is not None else ExpertTally(self.device))

    # ---- model pieces -------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.params["embed"][tokens].to(self.dtype)

    def _suffix_slice(self, x: torch.Tensor, pk: torch.Tensor,
                      pv: torch.Tensor, lo: int, hi: int):
        """Layer slice for a SUFFIX prefill: x covers only the uncached
        suffix; pk/pv ((hi-lo), KV, P, hd) is the reused prefix KV.  The
        model's own layer (`model.serve_layer`) at positions P..P+S-1, its
        core attention over [prefix ‖ suffix] at query offset P."""
        B, S, _ = x.shape
        P = pk.shape[2]
        positions = torch.arange(P, P + S, device=x.device)[None].expand(B, S)
        kvs = []
        for i, li in enumerate(range(lo, hi)):
            def attn_fn(qh, kh, vh, *, causal, sliding_window, i=i):
                k_all = torch.cat([pk[i][None].to(kh.dtype), kh], dim=2)
                v_all = torch.cat([pv[i][None].to(vh.dtype), vh], dim=2)
                return ops.attention(qh, k_all, v_all, causal=causal,
                                     sliding_window=sliding_window,
                                     q_offset=P, impl="auto")
            x, kv = mdl.serve_layer(self.cfg, self.params, li, x, positions,
                                    attn_fn=attn_fn)
            kvs.append(kv)
        return x, kvs

    def _finalize(self, x: torch.Tensor) -> torch.Tensor:
        # like the reference's _finalize_fn: no padded-vocab mask here
        x = L.rms_norm(x, self.params["final_norm"], self.cfg.norm_eps)
        return torch.matmul(x, self.params["lm_head"].to(x.dtype))[:, -1]

    # ---- prefill (preemptible) ---------------------------------------------
    def start_prefill(self, rid: int, tokens: torch.Tensor,
                      *, prefix_k: Optional[torch.Tensor] = None,
                      prefix_v: Optional[torch.Tensor] = None,
                      host_tokens: Optional[Tuple[int, ...]] = None
                      ) -> PrefillState:
        """Begin a (preemptible) prefill of tokens (1, S).  With
        `prefix_k`/`prefix_v` ((L, KV, P, hd), e.g. from
        `lookup_cached_prefix`) only the suffix beyond P is computed."""
        tr = self.tracer
        P = 0 if prefix_k is None else prefix_k.shape[2]
        with tr.span("engine.start_prefill", record=True, args=lambda: dict(
                rid=rid, S=tokens.shape[1], P=P)):
            # from pageable host memory: waits for the stream to drain
            with tr.span("engine.start_prefill.upload", wait=True,
                         record=True):
                tokens = tokens.to(self.device)
            return PrefillState(rid=rid, tokens=tokens,
                                x=self._embed(tokens[:, P:]), layer=0,
                                prefix_k=prefix_k, prefix_v=prefix_v,
                                host_tokens=host_tokens)

    def prefill_quantum(self, st: PrefillState) -> Tuple[PrefillState, bool]:
        """Run up to layers_per_quantum layers (every layer left where
        `st.whole` and no prefix is reused); returns (state, done)."""
        nl = self.cfg.num_layers
        lo = st.layer
        whole = st.whole and st.prefix_k is None
        hi = nl if whole else min(lo + self.lpq, nl)
        # one replay: the whole stack from layer 0 on the card, S in a bucket
        b = (self.graphs.bucket(st.x.shape[1])
             if whole and not lo and self.graphs is not None else None)
        tr = self.tracer
        with tr.span("engine.prefill_quantum", record=True, args=lambda: dict(
                rid=st.rid, S=st.x.shape[1], P=st.prefix_len,
                layers=f"{lo}-{hi}")):
            if b is not None:
                S = st.x.shape[1]
                with tr.span("engine.prefill_quantum.graph", record=True):
                    st.x, k, v = self.graphs.run(st.x)
                st.kv_k.extend(k[i:i + 1] for i in range(nl))
                st.kv_v.extend(v[i:i + 1] for i in range(nl))
                tr.count("prefill_graph_layers", nl)
                tr.count("prefill_graph_tokens", S)
                tr.count("prefill_graph_pad_tokens", b - S)
            else:
                with tr.span("engine.prefill_quantum.layers", record=True), \
                        MOE.tally_into(self._tally_slot(0)):
                    if st.prefix_k is not None:
                        x, kvs = self._suffix_slice(
                            st.x, st.prefix_k[lo:hi], st.prefix_v[lo:hi],
                            lo, hi)
                    else:
                        x, kvs = layer_slice(self.cfg, self.params,
                                             st.x, lo, hi)
                st.x = x
                for kv in kvs:
                    st.kv_k.append(kv.k)
                    st.kv_v.append(kv.v)
            st.layer = hi
            tr.count("prefill_layers", hi - lo)
            self._count_moe(0, st.x.shape[1], hi - lo)
            return st, hi == nl

    def _tally_slot(self, lanes: int) -> Optional[torch.Tensor]:
        return None if self.tally is None else self.tally.slot(lanes)

    def _count_moe(self, lanes: int, tokens: int, layers: int) -> None:
        """moe: `layers` layer runs of `tokens` tokens (a prefill's, or
        `lanes` decode lanes')."""
        if self.tally is not None:
            tr = self.tracer
            tr.count("moe_layer_runs." + ExpertTally.kind(lanes), layers)
            tr.count("moe_rows", tokens * self.cfg.experts_per_token * layers)

    def read_tokens(self, t: torch.Tensor) -> List[int]:
        """Token ids on the card (int64), read back: with the experts'
        tally in the same copy where the model is moe."""
        if self.tally is None:
            return t.tolist()
        return self.tally.read(t, self.tracer)

    def prefill_logits(self, st: PrefillState) -> torch.Tensor:
        assert st.layer == self.cfg.num_layers
        with self.tracer.span("engine.prefill_logits", record=True,
                              args=lambda: dict(rid=st.rid)):
            return self._finalize(st.x)

    # ---- resident KV (paged pool) ------------------------------------------
    def resident(self, rid: int) -> bool:
        return rid in self.kvpool.tables

    def scatter_kv(self, rid: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Install a request's KV (L, KV, S, hd) block-granularly without
        binding a decode slot (the re-admission path of parked KV)."""
        S = k.shape[2]
        if S > self.max_len:
            raise ValueError("sequence longer than engine max_len")
        if not self.kvpool.can_admit(S):
            raise SlotsFull(
                f"KV pool of replica cannot hold {S} tokens for request "
                f"{rid}: {len(self.kvpool.free)} of {self.kvpool.n_blocks} "
                f"blocks free")
        self.kvpool.admit(rid, k.to(self.device), v.to(self.device))

    def release_kv(self, rid: int) -> None:
        """Drop a resident request's blocks; invalidates the dense decode
        view so the next iteration sees the pool without them."""
        if rid in self.kvpool.tables:
            self.kvpool.release(rid)
            self._invalidate_view()

    def clear(self) -> None:
        """Evict every slot, release every resident request AND forget the
        prefix cache — a cleared engine behaves like a fresh one."""
        self.slot_rid = [None] * self.max_slots
        self._invalidate_view()
        for rid in list(self.kvpool.tables):
            self.kvpool.release(rid)
        self.kvpool.drop_cache()

    # ---- prefix cache --------------------------------------------------
    def lookup_cached_prefix(self, host_tokens: Sequence[int]
                             ) -> Tuple[PrefixHit, Optional[torch.Tensor],
                                        Optional[torch.Tensor]]:
        """Probe the pool's block-hash index for a resident prefix of
        `host_tokens` and gather its KV.  Only FULL-block matches feed the
        suffix prefill; partial-tail hits still count in the pool's stats.
        Returns (hit, prefix_k, prefix_v) — tensors are None on a miss."""
        hit = self.kvpool.lookup_prefix(host_tokens)
        # never reuse the WHOLE prompt: at least one suffix token must run
        while hit.blocks and hit.n_tokens >= len(host_tokens):
            hit.blocks.pop()
            hit.n_tokens -= self.block_size
        if not hit.blocks:
            return hit, None, None
        pk, pv = self.kvpool.gather_prefix(
            PrefixHit(blocks=hit.blocks, n_tokens=hit.n_tokens))
        return hit, pk, pv

    def cache_prompt(self, rid: int, k: torch.Tensor, v: torch.Tensor,
                     host_tokens: Sequence[int]) -> None:
        """Park a completed prompt's KV in the prefix cache (admit registers
        the blocks, the immediate release moves them to the cached list)."""
        if rid in self.kvpool.tables:
            return
        if not self.kvpool.can_admit(k.shape[2]):
            return                      # pool too tight to cache; skip
        self.kvpool.admit(rid, k, v, tokens=host_tokens)
        self.kvpool.release(rid)

    # ---- decode slots -------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_rid) if r is None]

    def bind_slot(self, rid: int) -> int:
        """Bind an already-resident request into a decode slot, reserving its
        full decode block budget."""
        if not self.resident(rid):
            raise KeyError(f"request {rid} has no KV in the pool")
        free = self.free_slots()
        if not free:
            raise SlotsFull(
                f"engine has no free decode slot for request {rid} "
                f"({self.max_slots} occupied)")
        try:
            self.kvpool.reserve(rid, self.max_len)
        except MemoryError as e:
            raise SlotsFull(str(e)) from e
        slot = free[0]
        self.slot_rid[slot] = rid
        self._invalidate_view()
        return slot

    def admit(self, rid: int, st: PrefillState) -> int:
        """Install a finished prefill's KV into the pool and bind a decode
        slot (the §5.2 KV migration).  Raises `SlotsFull` when every slot is
        occupied OR the pool lacks the block budget."""
        tr = self.tracer
        S = st.tokens.shape[1]
        with tr.span("engine.admit", record=True,
                     args=lambda: dict(rid=rid, S=S)):
            free = self.free_slots()
            if not free:
                raise SlotsFull(
                    f"engine has no free decode slot for request {rid} "
                    f"({self.max_slots} occupied)")
            if S > self.max_len:
                raise ValueError("sequence longer than engine max_len")
            if (len(self.kvpool.free) + len(self.kvpool.cached)
                    < self.blocks_per_seq):
                raise SlotsFull(
                    f"KV pool cannot reserve a decode lane for request {rid}: "
                    f"{len(self.kvpool.free)} of {self.kvpool.n_blocks} "
                    f"blocks free, {self.blocks_per_seq} needed")
            k, v = st.full_kv()
            with tr.span("engine.admit.pool", record=True):
                self.kvpool.admit(rid, k.to(self.device), v.to(self.device),
                                  tokens=st.host_tokens)
                self.kvpool.reserve(rid, self.max_len)
            slot = free[0]
            self.slot_rid[slot] = rid
            self._invalidate_view()
            return slot

    def evict(self, slot: int) -> None:
        rid = self.slot_rid[slot]
        with self.tracer.span("engine.evict", record=True,
                              args=lambda: dict(rid=rid)):
            self.slot_rid[slot] = None
            if rid is not None:
                self.release_kv(rid)

    def slot_lengths(self) -> List[int]:
        return [self.kvpool.lengths.get(rid, 0) if rid is not None else 0
                for rid in self.slot_rid]

    # ---- decode -------------------------------------------------------------
    def _invalidate_view(self) -> None:
        self._view = None

    def _dense_view(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The slot-batched dense cache (L, slots, KV, max_len, hd) the
        decode step consumes, gathered from the pool.  Kept between
        iterations: decode writes each new token into it in place, so it is
        rebuilt only after admit/bind/evict/clear."""
        if self._view is not None:
            return self._view
        cfg = self.cfg
        shape = (cfg.num_layers, self.max_slots, cfg.num_kv_heads,
                 self.max_len, cfg.head_dim)
        ck = torch.zeros(shape, dtype=self.dtype, device=self.device)
        cv = torch.zeros(shape, dtype=self.dtype, device=self.device)
        for s, rid in enumerate(self.slot_rid):
            if rid is None or not self.resident(rid):
                continue
            k, v = self.kvpool.gather(rid)
            ck[:, s, :, :k.shape[2]] = k
            cv[:, s, :, :v.shape[2]] = v
        self._view = (ck, cv)
        return self._view

    def decode_iteration(self, tokens: Dict[int, int]) -> Dict[int, int]:
        """One continuous-batching iteration over the active slots.
        tokens: slot -> last token id.  Returns slot -> next token id."""
        tr = self.tracer
        lens = self.slot_lengths()
        # each lane's request id and cached length (B2's cache length)
        with tr.span("engine.decode_iteration", record=True,
                     args=lambda: dict(lanes=[(self.slot_rid[s], lens[s])
                                              for s in tokens])):
            # moe: an idle lane's token is -1 (its experts none), on the
            # copy the step makes anyway
            tok = [0 if self.tally is None else -1] * self.max_slots
            for s, t in tokens.items():
                tok[s] = int(t)
            if self._view is None:
                with tr.span("engine.decode_iteration.view", record=True):
                    self._dense_view()
            cache_k, cache_v = self._view
            for s in tokens:
                if lens[s] >= self.max_len:
                    raise ValueError("decode past engine max_len")
            # a full inactive slot writes its ignored token at the last row
            # instead of out of bounds (its lane cannot decode again)
            step_lens = [min(n, self.max_len - 1) for n in lens]
            # copies from pageable host memory: each waits for the stream
            with tr.span("engine.decode_iteration.upload_lens", wait=True,
                         record=True):
                lens_t = torch.tensor(step_lens, dtype=torch.int32,
                                      device=self.device)
            with tr.span("engine.decode_iteration.upload_tokens", wait=True,
                         record=True):
                tok_t = torch.tensor(tok, dtype=torch.long,
                                     device=self.device)
            cache = {"len": lens_t, "k": cache_k, "v": cache_v}
            # the step writes every slot's new K/V into the view in place
            # (inactive slots write at masked positions, as in the reference)
            with tr.span("engine.decode_iteration.step", record=True), \
                    MOE.tally_into(self._tally_slot(len(tokens))):
                active = None
                if self.tally is not None:
                    active = tok_t >= 0
                    tok_t = tok_t.clamp_min(0)
                logits, _ = mdl.decode_step(self.cfg, self.params, cache,
                                            tok_t, impl="auto", active=active)
            self._count_moe(len(tokens), len(tokens), self.cfg.num_layers)
            # append the new token's KV back to the pool — active slots
            # only; slots reserved their full budget at admission, so this
            # never allocates and cannot fail mid-iteration
            with tr.span("engine.decode_iteration.append", record=True):
                for s in tokens:
                    pos = lens[s]
                    self.kvpool.append_token(self.slot_rid[s],
                                             cache_k[:, s, :, pos],
                                             cache_v[:, s, :, pos])
            with tr.span("engine.decode_iteration.readback", wait=True,
                         record=True):
                nxt = self.read_tokens(logits.argmax(-1))
            return {s: nxt[s] for s in tokens}
