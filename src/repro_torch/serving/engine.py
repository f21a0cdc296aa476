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
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.hardware import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as mdl
from repro_torch.serving.kvcache import PagedKVCache, PrefixHit


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


class ReplicaEngine:
    """One model replica: preemptible prefill + slot-batched decode over a
    paged KV pool, on `device` (CUDA unless the caller passes "cpu")."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int = 8,
                 max_len: int = 512, layers_per_quantum: int = 2,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError("the engine serves the dense family "
                                      "(other families: ROADMAP Queue A8)")
        self.device = resolve_device(device)
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
            hd, self.dtype, device=self.device)
        self.slot_rid: List[Optional[int]] = [None] * max_slots
        self._view: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    # ---- model pieces -------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.params["embed"][tokens].to(self.dtype)

    def _layer_slice(self, x: torch.Tensor, lo: int, hi: int):
        cfg = self.cfg
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        kvs = []
        for pl in self.params["layers"][lo:hi]:
            x, kv = mdl._dense_layer(cfg, pl, x, positions,
                                     sliding_window=cfg.sliding_window,
                                     impl="auto", write_cache=True)
            kvs.append(kv)
        return x, kvs

    def _suffix_slice(self, x: torch.Tensor, pk: torch.Tensor,
                      pv: torch.Tensor, lo: int, hi: int):
        """Layer slice for a SUFFIX prefill: x covers only the uncached
        suffix; pk/pv ((hi-lo), KV, P, hd) is the reused prefix KV.  Mirrors
        `_dense_layer` with attention over [prefix ‖ suffix] at query
        offset P."""
        cfg = self.cfg
        B, S, _ = x.shape
        P = pk.shape[2]
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        positions = torch.arange(P, P + S, device=x.device)[None].expand(B, S)
        kvs = []
        for i, pl in enumerate(self.params["layers"][lo:hi]):
            attn = pl["attn"]
            h = L.rms_norm(x, pl["ln1"], cfg.norm_eps)
            q = L.linear(h, attn["wq"], attn.get("bq")).reshape(B, S, H, hd)
            k = L.linear(h, attn["wk"], attn.get("bk")).reshape(B, S, KV, hd)
            v = L.linear(h, attn["wv"], attn.get("bv")).reshape(B, S, KV, hd)
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
            qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            k_all = torch.cat([pk[i][None].to(kh.dtype), kh], dim=2)
            v_all = torch.cat([pv[i][None].to(vh.dtype), vh], dim=2)
            o = ops.attention(qh, k_all, v_all, causal=True,
                              sliding_window=cfg.sliding_window,
                              q_offset=P, impl="auto")
            o = o.transpose(1, 2).reshape(B, S, H * hd)
            x = x + L.linear(o, attn["wo"])
            x = x + L.swiglu(L.rms_norm(x, pl["ln2"], cfg.norm_eps), pl["mlp"])
            kvs.append(L.KVCache(k=kh, v=vh))
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
        tokens = tokens.to(self.device)
        if prefix_k is not None:
            P = prefix_k.shape[2]
            return PrefillState(rid=rid, tokens=tokens,
                                x=self._embed(tokens[:, P:]), layer=0,
                                prefix_k=prefix_k, prefix_v=prefix_v,
                                host_tokens=host_tokens)
        return PrefillState(rid=rid, tokens=tokens, x=self._embed(tokens),
                            layer=0, host_tokens=host_tokens)

    def prefill_quantum(self, st: PrefillState) -> Tuple[PrefillState, bool]:
        """Run up to layers_per_quantum layers; returns (state, done)."""
        lo = st.layer
        hi = min(lo + self.lpq, self.cfg.num_layers)
        if st.prefix_k is not None:
            x, kvs = self._suffix_slice(st.x, st.prefix_k[lo:hi],
                                        st.prefix_v[lo:hi], lo, hi)
        else:
            x, kvs = self._layer_slice(st.x, lo, hi)
        st.x = x
        for kv in kvs:
            st.kv_k.append(kv.k)
            st.kv_v.append(kv.v)
        st.layer = hi
        return st, hi == self.cfg.num_layers

    def prefill_logits(self, st: PrefillState) -> torch.Tensor:
        assert st.layer == self.cfg.num_layers
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
        free = self.free_slots()
        if not free:
            raise SlotsFull(
                f"engine has no free decode slot for request {rid} "
                f"({self.max_slots} occupied)")
        S = st.tokens.shape[1]
        if S > self.max_len:
            raise ValueError("sequence longer than engine max_len")
        if (len(self.kvpool.free) + len(self.kvpool.cached)
                < self.blocks_per_seq):
            raise SlotsFull(
                f"KV pool cannot reserve a decode lane for request {rid}: "
                f"{len(self.kvpool.free)} of {self.kvpool.n_blocks} "
                f"blocks free, {self.blocks_per_seq} needed")
        k, v = st.full_kv()
        self.kvpool.admit(rid, k.to(self.device), v.to(self.device),
                          tokens=st.host_tokens)
        self.kvpool.reserve(rid, self.max_len)
        slot = free[0]
        self.slot_rid[slot] = rid
        self._invalidate_view()
        return slot

    def evict(self, slot: int) -> None:
        rid = self.slot_rid[slot]
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
        tok = [0] * self.max_slots
        for s, t in tokens.items():
            tok[s] = int(t)
        cache_k, cache_v = self._dense_view()
        lens = self.slot_lengths()
        for s in tokens:
            if lens[s] >= self.max_len:
                raise ValueError("decode past engine max_len")
        # a full inactive slot writes its ignored token at the last row
        # instead of out of bounds (its lane cannot decode again)
        step_lens = [min(n, self.max_len - 1) for n in lens]
        cache = {"len": torch.tensor(step_lens, dtype=torch.int32,
                                     device=self.device),
                 "k": cache_k, "v": cache_v}
        # the step writes every slot's new K/V into the view in place
        # (inactive slots write at masked positions, as in the reference)
        logits, _ = mdl.decode_step(
            self.cfg, self.params, cache,
            torch.tensor(tok, dtype=torch.long, device=self.device), impl="auto")
        # append the new token's KV back to the pool — active slots only;
        # slots reserved their full budget at admission, so this never
        # allocates and cannot fail mid-iteration
        for s in tokens:
            pos = lens[s]
            self.kvpool.append_token(self.slot_rid[s], cache_k[:, s, :, pos],
                                     cache_v[:, s, :, pos])
        nxt = logits.argmax(-1).tolist()
        return {s: nxt[s] for s in tokens}
