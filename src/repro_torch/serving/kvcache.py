"""Paged KV cache (PagedAttention-style): a fixed pool of fixed-size blocks
plus per-request block tables, with block-hash prefix reuse.

The pool is a pair of torch tensors (L, n_blocks, KV, block_size, hd) on the
engine's device; admit, append and copy-on-write update it IN PLACE with
``index_copy_`` and indexed writes (the reference rebuilds immutable arrays),
and gathers use ``index_select``.  The host-side metadata — chain hash,
refcounts, the ``cached`` LRU list, COW tails, ``reserve``, ``stats`` and the
accounting — is the reference's (``serving/kvcache.py``) line for line, so
both pools make the same decisions on the same operation sequence.

Prefix reuse (vLLM-v1-style): full blocks are indexed by a chain hash over
their token content (h_i = hash((h_{i-1}, block_tokens))); an admit whose
prompt shares a cached prefix links the resident blocks into its own table
(refcount++) instead of re-writing them.  Blocks whose refcount drops to zero
but that carry a registered hash park on the ``cached`` list (data retained,
LRU-evicted only when an allocation needs room).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.spans import Tracer


def _chain_hash(parent: Optional[int], tokens: Tuple[int, ...]) -> int:
    """Prefix-chain hash: identifies block CONTENT + everything before it.
    Collisions are assumed absent (the standard vLLM trade)."""
    return hash((parent, tokens))


@dataclass
class PrefixHit:
    """Result of `lookup_prefix`: resident blocks covering a prompt prefix.

    `blocks` are fully-matched blocks; `tail_block` (if any) matches only its
    first `tail_tokens` tokens — its KV rows can be gathered to skip compute,
    but the block itself is never shared."""
    blocks: List[int] = field(default_factory=list)
    n_tokens: int = 0              # tokens covered by fully-matched blocks
    tail_block: Optional[int] = None
    tail_tokens: int = 0           # extra tokens matched inside tail_block

    @property
    def total_tokens(self) -> int:
        return self.n_tokens + self.tail_tokens


@dataclass
class PagedKVCache:
    """Pool: k/v (L, n_blocks, KV, block_size, hd)."""
    k: torch.Tensor
    v: torch.Tensor
    block_size: int
    free: List[int] = field(default_factory=list)
    #: refcount-0 blocks with live hash registrations, oldest-first (LRU)
    cached: "OrderedDict[int, None]" = field(default_factory=OrderedDict)
    tables: Dict[int, List[int]] = field(default_factory=dict)   # rid -> blocks
    lengths: Dict[int, int] = field(default_factory=dict)        # rid -> tokens
    ref: Dict[int, int] = field(default_factory=dict)            # block -> refs
    chain: Dict[int, int] = field(default_factory=dict)          # hash -> block
    block_hash: Dict[int, int] = field(default_factory=dict)     # block -> hash
    tails: Dict[Optional[int], List[int]] = field(default_factory=dict)
    tail_meta: Dict[int, Tuple[Optional[int], Tuple[int, ...]]] = \
        field(default_factory=dict)
    stats: Dict[str, int] = field(default_factory=lambda: dict(
        lookups=0, hits=0, hit_tokens=0, blocks_shared=0, cow_forks=0))
    #: the owning engine's spans (core/spans.py)
    tracer: Tracer = field(default_factory=Tracer, compare=False, repr=False)

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, n_layers: int, n_blocks: int, kv_heads: int,
               block_size: int, head_dim: int, dtype=torch.bfloat16,
               device="cuda", tracer: Optional[Tracer] = None
               ) -> "PagedKVCache":
        shape = (n_layers, n_blocks, kv_heads, block_size, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   block_size=block_size, free=list(range(n_blocks)),
                   tracer=tracer if tracer is not None else Tracer())

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1]

    def blocks_needed(self, tokens: int) -> int:
        return -(-tokens // self.block_size)

    def can_admit(self, tokens: int) -> bool:
        return (len(self.free) + len(self.cached)
                >= self.blocks_needed(tokens))

    def _index(self, blocks: Sequence[int]) -> torch.Tensor:
        # a copy from pageable host memory: it waits for the stream to drain
        # (a totals-only span: a profiler range may open only inside the
        # engine's own methods, and gathers also run outside them)
        with self.tracer.span("pool.index", wait=True):
            return torch.tensor(list(blocks), dtype=torch.long,
                                device=self.k.device)

    # ------------------------------------------------------------------
    # allocation: blank blocks first, then LRU-evict the cached-prefix list
    # ------------------------------------------------------------------
    def _alloc(self, n: int) -> List[int]:
        if len(self.free) + len(self.cached) < n:
            raise MemoryError(f"need {n} blocks, {len(self.free)} free + "
                              f"{len(self.cached)} cached")
        out = [self.free.pop() for _ in range(min(n, len(self.free)))]
        while len(out) < n:
            b, _ = self.cached.popitem(last=False)     # oldest first
            self._unregister(b)
            out.append(b)
        return out

    def _unregister(self, b: int) -> None:
        h = self.block_hash.pop(b, None)
        if h is not None and self.chain.get(h) == b:
            del self.chain[h]
        tm = self.tail_meta.pop(b, None)
        if tm is not None:
            lst = self.tails.get(tm[0])
            if lst is not None:
                lst.remove(b)
                if not lst:
                    del self.tails[tm[0]]

    def _acquire(self, b: int) -> None:
        """Take (or add) a reference on a resident block, reviving it from
        the cached list if it was refcount-0."""
        if b in self.cached:
            del self.cached[b]
        self.ref[b] = self.ref.get(b, 0) + 1

    # ------------------------------------------------------------------
    # prefix lookup
    # ------------------------------------------------------------------
    def lookup_prefix(self, tokens: Sequence[int]) -> PrefixHit:
        """Longest resident prefix of `tokens`: fully-matched whole blocks
        via the chain-hash index, plus a partial match inside one registered
        tail block.  Read-only (no refcounts taken)."""
        hit = PrefixHit()
        self.stats["lookups"] += 1
        bs = self.block_size
        h: Optional[int] = None
        i = 0
        while i + bs <= len(tokens):
            nh = _chain_hash(h, tuple(tokens[i:i + bs]))
            b = self.chain.get(nh)
            if b is None:
                break
            hit.blocks.append(b)
            if b in self.cached:                   # LRU touch
                self.cached.move_to_end(b)
            h = nh
            i += bs
        hit.n_tokens = i
        rem = tokens[i:]
        if len(rem):
            best_b, best_n = None, 0
            for tb in self.tails.get(h, []):
                _, ttoks = self.tail_meta[tb]
                n = 0
                for a, c in zip(ttoks, rem):
                    if a != c:
                        break
                    n += 1
                if n > best_n:
                    best_b, best_n = tb, n
            if best_b is not None:
                hit.tail_block, hit.tail_tokens = best_b, best_n
                if best_b in self.cached:
                    self.cached.move_to_end(best_b)
        if hit.total_tokens:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += hit.total_tokens
        return hit

    def _gather_blocks(self, blocks: Sequence[int], n_tokens: int):
        idx = self._index(blocks)
        k = self.k.index_select(1, idx)            # (L, n, KV, bs, hd)
        v = self.v.index_select(1, idx)
        L, n, KV, bs, hd = k.shape
        k = k.permute(0, 2, 1, 3, 4).reshape(L, KV, n * bs, hd)[:, :, :n_tokens]
        v = v.permute(0, 2, 1, 3, 4).reshape(L, KV, n * bs, hd)[:, :, :n_tokens]
        return k, v

    def gather_prefix(self, hit: PrefixHit):
        """A hit's KV as contiguous (L, KV, total_tokens, hd) — the past KV a
        suffix-only prefill attends over."""
        blocks = list(hit.blocks)
        if hit.tail_block is not None:
            blocks.append(hit.tail_block)
        return self._gather_blocks(blocks, hit.total_tokens)

    # ------------------------------------------------------------------
    def admit(self, rid: int, k: torch.Tensor, v: torch.Tensor,
              tokens: Optional[Sequence[int]] = None) -> PrefixHit:
        """Install a request's prefill KV.  k/v: (L, KV, S, hd) — always the
        FULL sequence (matched blocks' slices are simply not written).

        With `tokens`, fully-matched resident blocks are linked by reference
        and the newly written full blocks + partial tail are registered in
        the hash index.  Without `tokens`: plain allocate-and-write."""
        if rid in self.tables:
            raise KeyError(f"rid {rid} already resident")
        L, KV, S, hd = k.shape
        bs = self.block_size
        need = self.blocks_needed(S)
        hit = PrefixHit()
        shared: List[int] = []
        if tokens is not None:
            if len(tokens) != S:
                raise ValueError(f"tokens length {len(tokens)} != KV "
                                 f"sequence length {S}")
            h: Optional[int] = None
            i = 0
            while i + bs <= S:
                h = _chain_hash(h, tuple(tokens[i:i + bs]))
                b = self.chain.get(h)
                if b is None:
                    break
                shared.append(b)
                i += bs
            # acquire BEFORE allocating: a shared block must not be evicted
            # by our own suffix allocation
            for b in shared:
                self._acquire(b)
            hit.blocks, hit.n_tokens = list(shared), i
        n_shared = len(shared)
        try:
            new_blocks = self._alloc(need - n_shared)
        except MemoryError:
            for b in shared:                    # undo the acquisition
                self._release_block(b)
            raise
        if new_blocks:
            lo = n_shared * bs
            pad = need * bs - S
            n_new = len(new_blocks)
            idx = self._index(new_blocks)
            for pool, src in ((self.k, k), (self.v, v)):
                s = torch.nn.functional.pad(src[:, :, lo:], (0, 0, 0, pad))
                blocks = s.reshape(L, KV, n_new, bs, hd).permute(0, 2, 1, 3, 4)
                pool.index_copy_(1, idx, blocks.to(pool.dtype))
            for b in new_blocks:
                self.ref[b] = 1
        table = shared + new_blocks
        self.tables[rid] = table
        self.lengths[rid] = S
        if tokens is not None:
            self._register(table, tokens)
            self.stats["blocks_shared"] += n_shared
        return hit

    def _register(self, table: List[int], tokens: Sequence[int]) -> None:
        """Index a freshly-admitted table: chain hashes for full blocks,
        tail registry for a trailing partial block."""
        bs = self.block_size
        S = len(tokens)
        h: Optional[int] = None
        for bi in range(S // bs):
            h = _chain_hash(h, tuple(tokens[bi * bs:(bi + 1) * bs]))
            b = table[bi]
            if h not in self.chain:
                self.chain[h] = b
                self.block_hash[b] = h
        rem = tuple(tokens[(S // bs) * bs:])
        if rem:
            tb = table[S // bs]
            if tb not in self.tail_meta:
                self.tail_meta[tb] = (h, rem)
                self.tails.setdefault(h, []).append(tb)
                # writing a private tail where a sibling tail already
                # diverged is the admit-side copy-on-write fork
                if len(self.tails[h]) > 1:
                    self.stats["cow_forks"] += 1

    def append_token(self, rid: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append one token's KV, k/v (L, KV, hd), in place.  Copy-on-write:
        a block shared with another table is forked to a private copy first
        so the sharer's bytes are never disturbed."""
        pos = self.lengths[rid]
        blocks = self.tables[rid]
        if pos >= len(blocks) * self.block_size:
            blocks.append(self._alloc(1)[0])
            self.ref[blocks[-1]] = 1
        bi = pos // self.block_size
        b = blocks[bi]
        if self.ref.get(b, 0) > 1:
            nb = self._alloc(1)[0]
            self.k[:, nb] = self.k[:, b]
            self.v[:, nb] = self.v[:, b]
            self.ref[b] -= 1
            self.ref[nb] = 1
            blocks[bi] = nb
            b = nb
            self.stats["cow_forks"] += 1
        off = pos % self.block_size
        self.k[:, b, :, off] = k.to(self.k.dtype)
        self.v[:, b, :, off] = v.to(self.v.dtype)
        self.lengths[rid] = pos + 1

    def gather(self, rid: int):
        """Contiguous (L, KV, S, hd) copy of a request's KV."""
        return self._gather_blocks(self.tables[rid], self.lengths[rid])

    def reserve(self, rid: int, capacity_tokens: int) -> None:
        """Grow a resident request's block table to hold `capacity_tokens`
        WITHOUT writing data, so `append_token` never has to allocate and
        admission is the only place that can run out of blocks."""
        blocks = self.tables[rid]
        need = self.blocks_needed(capacity_tokens) - len(blocks)
        if need <= 0:
            return
        if len(self.free) + len(self.cached) < need:
            raise MemoryError(f"need {need} blocks to reserve "
                              f"{capacity_tokens} tokens for rid {rid}, "
                              f"{len(self.free)} free")
        for b in self._alloc(need):
            blocks.append(b)
            self.ref[b] = 1

    def _release_block(self, b: int) -> None:
        self.ref[b] -= 1
        if self.ref[b] > 0:
            return
        del self.ref[b]
        if b in self.block_hash or b in self.tail_meta:
            self.cached[b] = None          # park: data + hash stay live
        else:
            self.free.append(b)

    def release(self, rid: int) -> None:
        # children park after parents (reverse table order) so LRU eviction
        # (oldest first) drops chain leaves before the prefixes they extend
        for b in reversed(self.tables.pop(rid)):
            self._release_block(b)
        self.lengths.pop(rid)

    def drop_cache(self) -> None:
        """Forget every cached prefix: parked blocks return to the blank
        free list, the hash index and counters reset."""
        for b in self.cached:
            self.free.append(b)
        self.cached.clear()
        self.chain.clear()
        self.block_hash.clear()
        self.tails.clear()
        self.tail_meta.clear()
        for key in self.stats:
            self.stats[key] = 0

    # ------------------------------------------------------------------
    # accounting: physical occupancy, tail slack and reserve headroom are
    # three different questions
    # ------------------------------------------------------------------
    def utilization(self) -> float:
        """Fraction of physical blocks held by live tables or the cached
        prefix list (shared blocks count once)."""
        busy = self.n_blocks - len(self.free) - len(self.cached)
        return busy / self.n_blocks

    def written_tokens(self) -> int:
        """Token positions actually written across live tables (per table:
        a block shared by two tables holds tokens for both)."""
        return sum(self.lengths.values())

    def reserved_tokens(self) -> int:
        """Capacity held by reserve() headroom beyond each sequence's
        written blocks — allocated on purpose, NOT fragmentation."""
        bs = self.block_size
        return sum((len(t) - self.blocks_needed(self.lengths[rid])) * bs
                   for rid, t in self.tables.items())

    def fragmentation(self) -> float:
        """Unusable slack inside each sequence's written blocks (the partial
        last block) over the blocks the written tokens occupy."""
        bs = self.block_size
        denom = sum(self.blocks_needed(n) for n in self.lengths.values()) * bs
        if denom == 0:
            return 0.0
        return 1.0 - sum(self.lengths.values()) / denom
