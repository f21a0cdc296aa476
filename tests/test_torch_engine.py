"""Port serving engine vs the JAX reference, end to end on the CPU.

* Within the port, a preempted prefill resumes bit-identically (§5.1).
* The port's `ReplicaEngine` and the reference's produce the same greedy
  tokens on the same weights and prompts, with and without a prefix-cache
  hit; prefill logits agree to 1e-4 (f32 sums in another order).
* `MiniCluster` on both packages under the analytic clock, with the same
  `HardwareSpec` values, gives IDENTICAL decision logs and generated tokens
  under `pecsched` and `fifo` — the slice's end-to-end parity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.cluster as jcluster
import repro_torch.serving.cluster as tcluster
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import init_params as j_init_params
from repro.serving.engine import ReplicaEngine as JaxEngine
from repro.sp.planner import TPU_V5E
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced_config
from repro_torch.serving.engine import ReplicaEngine
from repro_torch.sp.planner import HardwareSpec

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

BLOCK = 8


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(
        j_reduced_config(j_get_config("mistral_7b"), layers=2), dtype="float32")
    cfg = dataclasses.replace(
        reduced_config(get_config("mistral_7b"), layers=2), dtype="float32")
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _prefill(eng, rid, toks, to_arr, **kw):
    st = eng.start_prefill(rid, to_arr(toks[None]),
                           host_tokens=tuple(int(t) for t in toks), **kw)
    done = False
    while not done:
        st, done = eng.prefill_quantum(st)
    return st


def _greedy(eng, slot, first, n):
    out, tok = [first], first
    for _ in range(n):
        tok = eng.decode_iteration({slot: tok})[slot]
        out.append(tok)
    return out


def test_preempted_prefill_resumes_bit_identically(model):
    *_, cfg, params = model
    eng = ReplicaEngine(cfg, params, max_len=64, layers_per_quantum=1,
                        device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 24)))
    st = eng.start_prefill(0, toks)
    done = False
    while not done:
        st, done = eng.prefill_quantum(st)
    st2 = eng.start_prefill(1, toks)
    st2, done = eng.prefill_quantum(st2)           # pause after 1 layer ...
    assert not done and st2.layer == 1
    # §5.1: the suspension state's intermediate is small next to the KV
    assert st2.intermediate_bytes() < 0.6 * st.kv_bytes()
    while not done:                                # ... resume later
        st2, done = eng.prefill_quantum(st2)
    assert torch.equal(eng.prefill_logits(st), eng.prefill_logits(st2))
    for a, b in zip(st.kv_k + st.kv_v, st2.kv_k + st2.kv_v):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shared", [0, 2 * BLOCK, 2 * BLOCK + 5])
def test_engine_matches_jax(model, shared):
    """Greedy decode after a from-scratch prefill (shared=0) or after a
    prefix-cache hit of `shared` tokens against an earlier prompt."""
    jcfg, jparams, cfg, params = model
    jeng = JaxEngine(jcfg, jparams, max_len=64, block_size=BLOCK)
    teng = ReplicaEngine(cfg, params, max_len=64, block_size=BLOCK,
                         device="cpu")
    rng = np.random.default_rng(5 + shared)
    a = rng.integers(0, cfg.vocab_size, 30).astype(np.int32)
    b = np.concatenate([a[:shared], rng.integers(0, cfg.vocab_size,
                                                 30 - shared)]).astype(np.int32)
    results = []
    for eng, to_arr in ((jeng, jnp.asarray), (teng, torch.from_numpy)):
        if shared:
            st_a = _prefill(eng, 1, a, to_arr)
            k = [x for x in st_a.kv_k]
            v = [x for x in st_a.kv_v]
            stack = jnp.stack if eng is jeng else torch.stack
            eng.cache_prompt(1, stack(k, 0)[:, 0], stack(v, 0)[:, 0],
                             host_tokens=tuple(int(t) for t in a))
        hit, pk, pv = eng.lookup_cached_prefix(tuple(int(t) for t in b))
        want_hit = (shared // BLOCK) * BLOCK
        assert hit.n_tokens == want_hit
        st = _prefill(eng, 2, b, to_arr, prefix_k=pk, prefix_v=pv)
        logits = np.asarray(eng.prefill_logits(st))
        slot = eng.admit(2, st)
        toks = _greedy(eng, slot, int(logits[0].argmax()), 4)
        results.append((logits, toks))
    (jl, jt), (tl, tt) = results
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    assert tt == jt


def _requests(cfg, mod, n=10, seed=0):
    """Two longs, then shorts arriving while both long prefills run (the
    cost model prices a reduced-model prefill in microseconds), so
    PecSched preempts and FIFO queues."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        is_long = i < 2
        t = 1e-8 * i if is_long else 4e-7 + 2e-7 * i
        slen = 80 if is_long else 16        # two shapes: few JAX compiles
        reqs.append(mod.ServeRequest(
            rid=i, arrival=t, max_new=3, is_long=is_long,
            tokens=rng.integers(0, cfg.vocab_size, slen).astype(np.int32)))
    return reqs


@pytest.mark.parametrize("policy", ["pecsched", "fifo"])
def test_minicluster_parity_with_jax(model, policy, monkeypatch):
    jcfg, jparams, cfg, params = model
    logs = {}

    def recording(mod, key):
        make = mod.make_policy

        def make_policy(*a, **kw):
            pol = make(*a, **kw)
            pol.record_decisions = True
            logs[key] = pol.decision_log
            return pol
        monkeypatch.setattr(mod, "make_policy", make_policy)
    recording(jcluster, "jax")
    recording(tcluster, "torch")

    kw = dict(n_engines=2, policy=policy, max_len=128, layers_per_quantum=1,
              clock="analytic")
    jmc = jcluster.MiniCluster(jcfg, jparams, **kw)
    tmc = tcluster.MiniCluster(cfg, params, hw=HardwareSpec(
        **dataclasses.asdict(TPU_V5E)), device="cpu", **kw)
    for mc, mod in ((jmc, jcluster), (tmc, tcluster)):
        for r in _requests(cfg, mod):
            mc.submit(r)
        mc.run()
    assert logs["jax"] and logs["torch"] == logs["jax"]
    assert tmc.metrics() == jmc.metrics()
    gen = {r.rid: r.generated for r in tmc.done}
    assert len(gen) == 10 and all(len(g) == 3 for g in gen.values())
    assert gen == {r.rid: r.generated for r in jmc.done}
    if policy == "pecsched":
        assert tmc.metrics()["preemptions"] > 0


def test_first_token_in_padded_vocab_matches_reference():
    """A vocab of 500 is padded to 512.  The reference's engine takes the
    prefill's argmax over all 512 logits, padding included (its
    `_finalize_fn` does not mask), and the port gives the same first token
    on a prompt whose argmax falls in the padding."""
    jcfg = dataclasses.replace(
        j_reduced_config(j_get_config("mistral_7b"), layers=2),
        dtype="float32", vocab_size=500)
    cfg = dataclasses.replace(
        reduced_config(get_config("mistral_7b"), layers=2),
        dtype="float32", vocab_size=500)
    assert cfg.padded_vocab == 512
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    eng = ReplicaEngine(cfg, params, max_len=64, device="cpu")
    rng = np.random.default_rng(5)
    for _ in range(400):
        toks = rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
        first = int(eng.prefill_logits(_prefill(eng, 0, toks,
                                                torch.from_numpy))[0].argmax())
        if first >= cfg.vocab_size:
            break
    assert first >= cfg.vocab_size, "no prompt's argmax fell in the padding"
    jeng = JaxEngine(jcfg, jparams, max_len=64)
    want = int(jnp.argmax(jeng.prefill_logits(_prefill(jeng, 0, toks,
                                                       jnp.asarray))[0]))
    assert first == want
