"""Port paged KV pool vs the JAX reference pool, driven by one seeded
operation sequence: admits with and without prefix hits, appends (with
copy-on-write forks of pinned blocks), releases, LRU eviction of parked
prefixes, reserve, lookups and drop_cache.  After every operation the host
metadata must be identical and the gathered KV bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.kvcache import PagedKVCache as JaxPool
from repro_torch.serving.kvcache import PagedKVCache

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

L, KV, HD, BS = 2, 2, 4, 4


def _state(pc):
    return (pc.tables, pc.lengths, pc.ref, pc.free, list(pc.cached), pc.chain,
            pc.block_hash, pc.tails, pc.tail_meta, pc.stats)


def _assert_same(jp, tp):
    assert _state(jp) == _state(tp)
    for rid in jp.tables:
        jk, jv = jp.gather(rid)
        tk, tv = tp.gather(rid)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _both(fn_j, fn_t):
    """Run one operation on both pools; they must succeed or refuse alike."""
    err = []
    for fn in (fn_j, fn_t):
        try:
            fn()
            err.append(None)
        except MemoryError:
            err.append(MemoryError)
    assert err[0] == err[1]
    return err[0] is None


@pytest.mark.parametrize("seed,n_blocks", [(0, 16), (1, 12), (2, 24)])
def test_pool_matches_jax_on_random_ops(seed, n_blocks):
    rng = np.random.default_rng(seed)
    jp = JaxPool.create(L, n_blocks, KV, BS, HD, dtype=jnp.float32)
    tp = PagedKVCache.create(L, n_blocks, KV, BS, HD, dtype=torch.float32,
                             device="cpu")
    # prompts are prefixes of a few base sequences, so full blocks are
    # genuinely shared and partial tails diverge
    bases = [[int(x) for x in rng.integers(0, 3, 13)] for _ in range(3)]
    live, pins, next_rid = [], [], 0
    ops = ["admit", "admit_plain", "release", "append", "reserve", "pin",
           "unpin", "lookup"]
    for _ in range(120):
        op = ops[int(rng.integers(len(ops)))]
        if op in ("admit", "admit_plain"):
            n = int(rng.integers(1, 14))
            toks = bases[int(rng.integers(len(bases)))][:n]
            kv = rng.normal(size=(2, L, KV, n, HD)).astype(np.float32)
            tk = None if op == "admit_plain" else toks
            ok = _both(lambda: jp.admit(next_rid, jnp.asarray(kv[0]),
                                        jnp.asarray(kv[1]), tokens=tk),
                       lambda: tp.admit(next_rid, torch.from_numpy(kv[0]),
                                        torch.from_numpy(kv[1]), tokens=tk))
            if ok:
                live.append(next_rid)
            next_rid += 1
        elif op == "release" and live:
            rid = live.pop(int(rng.integers(len(live))))
            jp.release(rid)
            tp.release(rid)
        elif op == "append" and live:
            rid = live[int(rng.integers(len(live)))]
            kv = rng.normal(size=(2, L, KV, HD)).astype(np.float32)
            _both(lambda: jp.append_token(rid, jnp.asarray(kv[0]),
                                          jnp.asarray(kv[1])),
                  lambda: tp.append_token(rid, torch.from_numpy(kv[0]),
                                          torch.from_numpy(kv[1])))
        elif op == "reserve" and live:
            rid = live[int(rng.integers(len(live)))]
            cap = jp.lengths[rid] + int(rng.integers(1, 3 * BS))
            _both(lambda: jp.reserve(rid, cap), lambda: tp.reserve(rid, cap))
        elif op == "pin" and live:
            # a concurrent holder of a table's last block: the next append
            # into it must fork a private copy (copy-on-write)
            b = jp.tables[live[int(rng.integers(len(live)))]][-1]
            jp._acquire(b)
            tp._acquire(b)
            pins.append(b)
        elif op == "unpin" and pins:
            b = pins.pop()
            jp._release_block(b)
            tp._release_block(b)
        elif op == "lookup":
            toks = bases[int(rng.integers(len(bases)))][:int(rng.integers(1, 14))]
            jh, th = jp.lookup_prefix(toks), tp.lookup_prefix(toks)
            assert (jh.blocks, jh.n_tokens, jh.tail_block, jh.tail_tokens) == \
                (th.blocks, th.n_tokens, th.tail_block, th.tail_tokens)
            if th.total_tokens:
                jk, _ = jp.gather_prefix(jh)
                tk, _ = tp.gather_prefix(th)
                np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        _assert_same(jp, tp)
        assert tp.utilization() == jp.utilization()
        assert tp.fragmentation() == jp.fragmentation()
        assert tp.reserved_tokens() == jp.reserved_tokens()
        assert tp.written_tokens() == jp.written_tokens()
    assert tp.stats["cow_forks"] > 0 and tp.stats["blocks_shared"] > 0
    for b in pins:
        jp._release_block(b)
        tp._release_block(b)
    for rid in live:
        jp.release(rid)
        tp.release(rid)
    jp.drop_cache()
    tp.drop_cache()
    _assert_same(jp, tp)
    assert sorted(tp.free) == list(range(n_blocks))


def test_lru_eviction_matches_jax():
    jp = JaxPool.create(L, 4, KV, BS, HD, dtype=jnp.float32)
    tp = PagedKVCache.create(L, 4, KV, BS, HD, dtype=torch.float32,
                             device="cpu")
    for rid, toks in ((0, [1, 2, 3, 4]), (1, [5, 6, 7, 8]), (2, [9] * 12)):
        kv = np.full((L, KV, len(toks), HD), rid, np.float32)
        jp.admit(rid, jnp.asarray(kv), jnp.asarray(kv), tokens=toks)
        tp.admit(rid, torch.from_numpy(kv), torch.from_numpy(kv), tokens=toks)
        if rid < 2:
            jp.release(rid)
            tp.release(rid)
        _assert_same(jp, tp)
    assert tp.lookup_prefix([1, 2, 3, 4]).n_tokens == 0, "oldest evicted"
    assert tp.lookup_prefix([5, 6, 7, 8]).n_tokens == 4, "newest retained"


def test_split_accounting_matches_jax():
    """The accounting split after the same admit and reserve on both pools:
    written tokens (live payload), reserved tokens (reserve() headroom),
    utilization (physical blocks) and fragmentation (partial-tail slack
    only) equal the reference's, with the reference's own values."""
    n_blocks = 16
    jp = JaxPool.create(L, n_blocks, KV, BS, HD, dtype=jnp.float32)
    tp = PagedKVCache.create(L, n_blocks, KV, BS, HD, dtype=torch.float32,
                             device="cpu")
    kv = np.random.default_rng(3).normal(size=(2, L, KV, 10, HD)).astype(
        np.float32)
    jp.admit(0, jnp.asarray(kv[0]), jnp.asarray(kv[1]), tokens=list(range(10)))
    tp.admit(0, torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
             tokens=list(range(10)))

    def split(pc):
        return (pc.written_tokens(), pc.reserved_tokens(), pc.utilization(),
                pc.fragmentation())
    assert split(tp) == split(jp) == (10, 0, 3 / n_blocks, 1 - 10 / 12)
    jp.reserve(0, 6 * BS)
    tp.reserve(0, 6 * BS)
    assert split(tp) == split(jp) == (10, 3 * BS, 6 / n_blocks, 1 - 10 / 12)
    _assert_same(jp, tp)
