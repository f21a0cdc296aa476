"""The whole-stack prefill of a fresh short (`serving/engine.PrefillGraphs`):
the captured work, run eagerly on the CPU at a padded bucket, against the
unpadded per-layer slice; the backend's routing (a fresh short in one timed
call, every other prefill one call per layer, the same tokens either way);
and on the card the graph replays against the eager slice, with no aliasing
between buckets and no capture while serving (marker `cuda`)."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (ClusterConfig, ExecutionModel, Simulator,
                              make_policy)
from repro_torch.core.request import Request
from repro_torch.core.spans import Tracer
from repro_torch.models import init_params
from repro_torch.serving.backend import EngineBackend
from repro_torch.serving.engine import (BUCKETS, PrefillGraphs, ReplicaEngine,
                                        layer_slice)

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

LAYERS = 3


def _cfg(window=0, dtype="float32", **kw):
    return dataclasses.replace(
        reduced_config(get_config("mistral_7b"), layers=LAYERS, **kw),
        dtype=dtype, sliding_window=window)


def _per_layer(cfg, params, x):
    """The eager path of a quantum a layer: (x, K (L, KV, S, hd), V)."""
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (kv,) = layer_slice(cfg, params, x, i, i + 1)
        ks.append(kv.k[0])
        vs.append(kv.v[0])
    return x, torch.stack(ks), torch.stack(vs)


def test_buckets_are_increasing_and_end_at_the_cells_context():
    assert list(BUCKETS) == sorted(set(BUCKETS)) and BUCKETS[-1] == 4096
    g = PrefillGraphs(_cfg(), {}, device="cpu", max_len=300,
                      tracer=Tracer())
    assert g.buckets == (64, 128, 256)
    assert [g.bucket(s) for s in (1, 64, 65, 256, 257)] == [64, 64, 128, 256,
                                                            None]


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("S", [64, 63, 65])
def test_padded_stack_equals_unpadded_layers(window, S):
    """The captured function run eagerly on the CPU in f32 at its bucket
    (S at a bucket, one below, one above the previous bucket), pad rows
    zeroed: the real rows' x, K and V are the per-layer slice's.  The
    staging, the body and the clones are a replay's, with no graph."""
    cfg = _cfg(window)
    params = init_params(cfg, seed=0, device="cpu")
    x = torch.randn((1, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(S))
    graphs = PrefillGraphs(cfg, params, device="cpu", max_len=128,
                           tracer=Tracer())

    def run(x):
        graphs._body(graphs._stage(x))
        return graphs._real_rows(x.shape[1])
    # a longer prompt first leaves its rows in the static input's pad
    run(torch.randn((1, 128, cfg.d_model)))
    gx, gk, gv = run(x)
    ex, ek, ev = _per_layer(cfg, params, x)
    assert gx.shape == ex.shape and gk.shape == ek.shape == gv.shape
    for got, want in ((gx, ex), (gk, ek), (gv, ev)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# ---- the backend's routing ------------------------------------------------

@pytest.fixture(scope="module")
def stack():
    cfg = _cfg()
    cc = ClusterConfig(n_nodes=1, gpus_per_node=3, tp=1,
                       n_short_decode_replicas=1, max_decode_concurrency=8)
    em = ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=0.5)
    return cfg, cc, em, init_params(cfg, seed=0, device="cpu")


def _backend(stack, clock="analytic"):
    cfg, _, _, params = stack
    return EngineBackend(cfg, params, max_len=128, layers_per_quantum=1,
                         clock=clock, device="cpu")


def _calls(be):
    """Log (rid, first layer, layers run) of every prefill_quantum call."""
    log = []
    for eng in be._engines.values():
        def quantum(st, _orig=eng.prefill_quantum):
            lo = st.layer
            out = _orig(st)
            log.append((st.rid, lo, st.layer - lo))
            return out
        eng.prefill_quantum = quantum
    return log


def _req(rid, is_long=False, group=None):
    return Request(rid=rid, arrival=0.0, input_len=2000, output_len=4,
                   is_long=is_long, prefix_group=group,
                   prefix_len=1500 if group is not None else 0)


def test_fresh_short_is_one_call_and_the_rest_one_per_layer(stack):
    be = _backend(stack)
    eng = be._engine(0)
    log = _calls(be)
    s = be.stats

    def run(req):
        before = s["backend.prefill_quantum:n"], s["prefill_layers"]
        be._complete_prefill(eng, req)
        return (s["backend.prefill_quantum:n"] - before[0],
                s["prefill_layers"] - before[1])

    assert run(_req(1)) == (1, LAYERS)                   # a fresh short
    assert log[-1] == (1, 0, LAYERS)
    assert run(_req(2, is_long=True)) == (LAYERS, LAYERS)   # recorded
    assert len(be.sp_timings[1]) == LAYERS
    assert run(_req(3, group=7)) == (1, LAYERS)          # group's first: miss
    assert run(_req(4, group=7)) == (LAYERS, LAYERS)     # suffix prefill
    assert s["prefix_hits"] == 1
    # a session already in flight (a preempted long resumed) is no fresh one
    st = be._start_prefill(eng, _req(5))
    eng.prefill_quantum(st)
    be._psessions[5] = st
    assert run(_req(5)) == (LAYERS - 1, LAYERS - 1)
    assert "prefill_graph_layers" not in s              # no graph on the CPU


def _trace():
    rng = np.random.default_rng(3)
    reqs, t = [], 0.0
    for i in range(12):
        t += 0.002 if i else 0.0
        reqs.append(Request(
            rid=i, arrival=round(t, 6),
            input_len=300_000 if i == 0 else int(rng.integers(2000, 3000)),
            output_len=6, is_long=i == 0,
            prefix_group=0 if i and i % 3 == 0 else None,
            prefix_len=1500 if i and i % 3 == 0 else 0))
    return reqs


def _serve(be, stack):
    _, cc, em, _ = stack
    be.reset()
    sim = Simulator(make_policy("pecsched", cc, em), backend=be)
    return sim.run(copy.deepcopy(_trace()))


def test_engine_step_quanta_stay_one_layer_each(stack):
    """On the measured clock a long advances by ENGINE_STEP quanta of one
    layer; fresh shorts take one call each, prefix hits one per layer."""
    be = _backend(stack, clock="measured")
    for rid in range(3):
        be._engine(rid)
    log = _calls(be)
    summary = _serve(be, stack)
    assert summary["long_completed"] == 1 and summary["short_completed"] == 11
    assert summary["preemptions"] > 0
    by_rid = {}
    for rid, lo, n in log:
        by_rid.setdefault(rid, []).append((lo, n))
    assert by_rid[0] == [(i, 1) for i in range(LAYERS)]
    whole = [r for r, c in by_rid.items() if c == [(0, LAYERS)]]
    per_layer = [r for r, c in by_rid.items() if r
                 and c == [(i, 1) for i in range(LAYERS)]]
    assert sorted(whole + per_layer) == list(range(1, 12))
    assert len(per_layer) == be.stats["prefix_hits"] > 0
    assert be.stats["backend.step.long_prefill:n"] >= LAYERS


def test_tokens_equal_the_per_layer_path(stack, monkeypatch):
    """Every request's greedy tokens, with fresh shorts in one call, equal
    those of a run with every prefill one call per layer (analytic clock:
    the same schedule)."""
    be = _backend(stack)
    _serve(be, stack)
    whole = {r: list(t) for r, t in be.generated.items()}
    calls = be.stats["backend.prefill_quantum:n"]
    orig = ReplicaEngine.prefill_quantum

    def per_layer(self, st):
        st.whole = False
        return orig(self, st)
    monkeypatch.setattr(ReplicaEngine, "prefill_quantum", per_layer)
    be2 = _backend(stack)
    _serve(be2, stack)
    assert be2.stats["backend.prefill_quantum:n"] > calls
    assert {r: list(t) for r, t in be2.generated.items()} == whole
    assert len(whole) == 12


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the hand kernels "
                    "run only on the card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 100])
def test_graph_replay_matches_eager_and_keeps_no_alias(cuda, window):
    """bf16 at head dim 128: replays at three buckets in the order A, B, A
    against the eager per-layer slice (K, V, first-token logits within 5e-3
    in relative norm); A's state is unchanged by B's replay and a second
    replay of A repeats it exactly; B1's launch count follows the replays,
    L each, and not the captures."""
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = _cfg(window, dtype="bfloat16", d_model=512, n_heads=4, n_kv=2)
    assert cfg.head_dim == 128
    params = init_params(cfg, seed=0, device=cuda)
    tracer = Tracer()
    eng = ReplicaEngine(cfg, params, max_len=1024, layers_per_quantum=1,
                        device=cuda, tracer=tracer,
                        graphs=PrefillGraphs(cfg, params, device=cuda,
                                             max_len=1024, tracer=tracer))
    prompts = {n: torch.randint(0, cfg.vocab_size, (1, n), generator=torch
                                .Generator().manual_seed(n))
               for n in (50, 200, 700)}

    def prefill(n, whole):
        st = eng.start_prefill(n, prompts[n])
        st.whole = whole
        done = False
        while not done:
            st, done = eng.prefill_quantum(st)
        return st, eng.prefill_logits(st)

    eng.graphs.capture(eng.graphs.bucket(50))      # and its eager first run
    launches = flash_attention.launches
    for n in prompts:
        eng.graphs.capture(eng.graphs.bucket(n))
    assert flash_attention.launches == launches      # captures run nothing
    out = {}
    for n in (50, 200, 50):
        st, logits = prefill(n, True)
        k, v = st.full_kv()
        if n in out:                 # A again: bit-equal to A's first replay
            assert torch.equal(logits, out[n][1])
            assert torch.equal(k, out[n][2]) and torch.equal(v, out[n][3])
        else:
            out[n] = (st, logits, k.clone(), v.clone())
        if n == 200:                 # B's replay left A's state alone
            ka, va = out[50][0].full_kv()
            assert torch.equal(ka, out[50][2]) and torch.equal(va, out[50][3])
    assert flash_attention.launches == launches + 3 * LAYERS
    st, logits = prefill(700, True)
    out[700] = (st, logits, *st.full_kv())
    for n in prompts:
        est, elogits = prefill(n, False)
        ek, ev = est.full_kv()
        _, logits, k, v = out[n]
        assert k.shape == ek.shape == (LAYERS, cfg.num_kv_heads, n, 128)
        assert _rel(k, ek) <= 5e-3 and _rel(v, ev) <= 5e-3
        assert _rel(logits, elogits) <= 5e-3, n
    assert eng.tracer.stats["prefill_graph_layers"] == 4 * LAYERS
    assert eng.tracer.stats["prefill_graph_pad_tokens"] == \
        (64 - 50) * 2 + 256 - 200 + 768 - 700


@pytest.mark.cuda
def test_warmup_captures_every_bucket_once(cuda, stack):
    """`warmup` captures each bucket a prompt runs at, one set for every
    engine; serving then replays them and captures nothing more; the
    profiler names B1 inside a replay."""
    cfg = _cfg(dtype="bfloat16", d_model=512, n_heads=4, n_kv=2)
    be = EngineBackend(cfg, init_params(cfg, seed=0, device=cuda),
                       max_len=300, layers_per_quantum=1, clock="measured",
                       device=cuda)
    be.warmup([16], range(3))
    assert be.stats["prefill_graph_captures"] == len(be.graphs.graphs) == 3
    assert all(e.graphs is be.graphs for e in be._engines.values())
    summary = _serve(be, (cfg, *stack[1:]))
    assert summary["short_completed"] == 11
    assert be.stats.get("prefill_graph_captures", 0) == 0
    assert be.stats["prefill_graph_layers"] > 0
    x = torch.randn((1, 100, cfg.d_model), device=cuda).to(torch.bfloat16)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        be.graphs.run(x)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("fa_tc_kernel" in k for k in kernels) == LAYERS, kernels
