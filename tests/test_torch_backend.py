"""The port's EngineBackend against the port's SimBackend: one scheduling
brain, two execution worlds, as tests/test_backends.py pins for the
reference.  Under the analytic clock the decision logs (placements,
preemptions, decode-lane evictions, with timestamps) must be IDENTICAL for
every `make_policy` policy, while every command really executes on torch
engines (reduced f32 mistral_7b on the CPU).  No JAX here: the brain is the
port's own copy, held equal to the reference by test_torch_isolation.py."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (POLICY_NAMES, ClusterConfig, ExecutionModel,
                              Phase, Simulator, make_policy)
from repro_torch.core.request import Request
from repro_torch.core.scenarios import assign_slo_tiers
from repro_torch.models import init_params
from repro_torch.serving.backend import EngineBackend
from repro_torch.serving.engine import ReplicaEngine, SlotsFull

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cluster():
    """2 general + 1 dedicated-decode replica, prefill target tight enough
    that a 300K long claims an SP group (which collapses to one replica
    on a one-device host, as in the reference)."""
    cfg = dataclasses.replace(
        reduced_config(get_config("mistral_7b"), layers=2), dtype="float32")
    cc = ClusterConfig(n_nodes=1, gpus_per_node=3, tp=1,
                       n_short_decode_replicas=1, max_decode_concurrency=8)
    return cfg, cc, ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=0.5)


@pytest.fixture(scope="module")
def params(cluster):
    return init_params(cluster[0], seed=0, device="cpu")


@pytest.fixture(scope="module")
def engine_backend(cluster, params):
    return EngineBackend(cluster[0], params, max_len=128, layers_per_quantum=1,
                         clock="analytic", device="cpu")


def mini_trace():
    """tests/test_backends.py's pinned trace: two longs under sustained
    short pressure on two general replicas."""
    rng = np.random.default_rng(0)
    reqs, t = [], 0.0
    for i in range(14):
        is_long = i in (0, 7)
        t += 0.002 if i else 0.0
        reqs.append(Request(
            rid=i, arrival=round(t, 6),
            input_len=300_000 if is_long else int(rng.integers(300, 3000)),
            output_len=60 if is_long else int(rng.integers(10, 60)),
            is_long=is_long))
    return reqs


def _run(pol, cc, em, backend=None):
    p = make_policy(pol, cc, em)
    p.record_decisions = True
    if backend is not None:
        backend.reset()
    s = Simulator(p, backend=backend).run(copy.deepcopy(mini_trace()))
    return p, s


@pytest.mark.parametrize("pol", list(POLICY_NAMES))
def test_decision_parity_with_sim_backend(cluster, engine_backend, pol):
    _, cc, em = cluster
    p_sim, s_sim = _run(pol, cc, em)
    p_eng, s_eng = _run(pol, cc, em, engine_backend)
    assert p_sim.decision_log == p_eng.decision_log
    assert s_sim["preemptions"] == s_eng["preemptions"]
    assert {r.rid for r in p_sim.done_requests} == \
        {r.rid for r in p_eng.done_requests}
    for r in p_eng.done_requests:
        assert len(engine_backend.generated.get(r.rid, [])) >= 1


def test_preempted_long_generates_same_tokens(cluster, engine_backend):
    """§5.1 end to end: the long is preempted under PecSched and never under
    FIFO, and its greedy tokens are the same."""
    _, cc, em = cluster
    outs = {}
    for pol in ("fifo", "pecsched"):
        p, s = _run(pol, cc, em, engine_backend)
        assert s["long_completed"] == 2
        if pol == "pecsched":
            assert s["preemptions"] > 0
        outs[pol] = {r.rid: list(engine_backend.generated[r.rid])
                     for r in p.done_requests if r.is_long}
    assert outs["fifo"] == outs["pecsched"]


def test_decode_lane_eviction_parks_and_restores(cluster, engine_backend):
    """sjf_pred evicts decode lanes mid-decode on this trace: the engine
    parks the KV host-side, re-admits it, and every evicted request's
    tokens equal an uninterrupted run's (FIFO)."""
    _, cc, em = cluster
    p, _ = _run("sjf_pred", cc, em, engine_backend)
    evicted = sorted({d[1] for d in p.decision_log if d[0] == "pred_evict"})
    assert evicted
    assert engine_backend.stats["decode_preemptions"] > 0
    assert engine_backend.stats["decode_readmits"] > 0
    assert not engine_backend._parked_decode and not engine_backend._pdone
    gen = {r.rid: list(engine_backend.generated[r.rid]) for r in p.done_requests}
    _run("fifo", cc, em, engine_backend)
    for rid in evicted:
        assert list(engine_backend.generated[rid]) == gen[rid], rid


def test_gang_of_two_or_more_raises(engine_backend, monkeypatch):
    """A fast-SP long over 2+ replicas on a host with 2+ cards would need
    the gang runner (ROADMAP A7): it raises instead of falling back; on one
    device the degree collapses to 1, as in the reference."""
    from repro_torch.core.simulator import Work
    from repro_torch.serving.backend import gang_degree
    assert gang_degree(4, n_devices=1) == 1
    assert gang_degree(4, n_devices=8, cap=2) == 2
    work = Work(wid=0, kind="long_prefill", replica_ids=[0, 1], requests=[],
                start=0.0, duration=1.0, sp_mode="fastsp")
    assert engine_backend._gang_degree_for(work) == 1          # CPU: 1 device
    monkeypatch.setattr(engine_backend, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="A7"):
        engine_backend._gang_degree_for(work)


def test_reclaim_parks_kv_and_resumes_elsewhere(engine_backend):
    """Spot reclamation of the replica holding a live long decode: its paged
    KV is parked host-side, the engine is cleared, and the session resumes on
    another replica (re-scatter + bind) with the same tokens as an
    uninterrupted decode."""
    be = engine_backend
    req = Request(rid=99, arrival=0.0, input_len=5000, output_len=8,
                  is_long=True)

    def decode(reclaim_after=None):
        be.reset()
        be._complete_prefill(be._engine(0), req)
        be._bind_long_decode(req, 0)
        sess = be._dsessions[req.rid]
        if reclaim_after is not None:
            be._decode_steps(be._engine(0), req, sess, reclaim_after)
            out = be.reclaim_replica(0.0, 0)
            assert out["parked_sessions"] == 1 and out["evacuated_blocks"] > 0
            assert not be._engine(0).kvpool.tables
            assert req.rid in be._parked_scatter
            be._bind_long_decode(req, 1)
            assert not be._parked_scatter
            sess = be._dsessions[req.rid]
        home = be._engine(sess["home"])
        be._decode_steps(home, req, sess, sess["remaining"])
        return list(be.generated[req.rid])

    want = decode()
    assert len(want) == be._target_new(req)
    assert decode(reclaim_after=1) == want


def test_warmup_runs_each_length_and_leaves_engines_clean(engine_backend):
    be = engine_backend
    be.reset()
    be.warmup([8, 24], replica_ids=[0, 2])
    for rid in (0, 2):
        eng = be._engine(rid)
        assert not eng.kvpool.tables and eng.free_slots() == list(range(eng.max_slots))


# ---- twins of the reference's remaining cross-backend tests -----------------
def tiered_trace(cc, em):
    """tests/test_backends.py's pinned tiered trace: two standard-tier
    shorts occupy the generals, a long queues and claims them, an
    interactive flood with near-zero contracts turns the plan urgent
    (retract), and a batch-tier flood forces shedding."""
    width = em.prefill_time(cc.max_batch_tokens, 1, sp_mode="local")
    mbt = cc.max_batch_tokens
    reqs = [Request(rid=0, arrival=0.0, input_len=mbt, output_len=4,
                    tenant="codegen"),
            Request(rid=1, arrival=0.0, input_len=mbt, output_len=4,
                    tenant="codegen"),
            Request(rid=2, arrival=round(0.1 * width, 9), input_len=300_000,
                    output_len=8, is_long=True, tenant="summarize")]
    rid = 3
    for i in range(10):
        reqs.append(Request(rid=rid, arrival=round(0.2 * width + i * 1e-6, 9),
                            input_len=1000, output_len=4, tenant="chat"))
        rid += 1
    for i in range(25):
        reqs.append(Request(rid=rid, arrival=round(0.25 * width + i * 1e-6, 9),
                            input_len=mbt, output_len=4, tenant="summarize"))
        rid += 1
    assign_slo_tiers(reqs, slo_scale=1e-6)
    return reqs


def test_slo_parity_on_tiered_trace(cluster, engine_backend):
    """pecsched/slo makes the same decisions, shed and retract included, on
    both backends, and the SLO summary fields agree."""
    _, cc, em = cluster
    trace = tiered_trace(cc, em)
    p_sim = make_policy("pecsched/slo", cc, em)
    p_sim.record_decisions = True
    s_sim = Simulator(p_sim).run(copy.deepcopy(trace))
    engine_backend.reset()
    p_eng = make_policy("pecsched/slo", cc, em)
    p_eng.record_decisions = True
    s_eng = Simulator(p_eng, backend=engine_backend).run(copy.deepcopy(trace))
    assert p_sim.decision_log == p_eng.decision_log
    assert any(d[0] == "retract" for d in p_sim.decision_log)
    assert any(d[0] == "shed" for d in p_sim.decision_log)
    assert p_sim.plan_retractions == p_eng.plan_retractions
    assert p_sim.shed_events == p_eng.shed_events
    assert s_sim["goodput"] == s_eng["goodput"]
    assert s_sim["slo_tiers"] == s_eng["slo_tiers"]
    assert s_sim["long_completed"] == s_eng["long_completed"] == 1
    assert {r.rid: r.first_token for r in p_sim.done_requests} == \
        {r.rid: r.first_token for r in p_eng.done_requests}


@pytest.mark.parametrize("pol", ["fifo", "pecsched", "pecsched/dis",
                                 "sjf_pred"])
def test_ttft_stamped_at_decode_landing_parity(cluster, engine_backend, pol):
    """Every path stamps first_token when decode lands, identically on both
    backends, and the stamp lies between arrival and finish."""
    _, cc, em = cluster
    p_sim = make_policy(pol, cc, em)
    Simulator(p_sim).run(copy.deepcopy(mini_trace()))
    engine_backend.reset()
    p_eng = make_policy(pol, cc, em)
    Simulator(p_eng, backend=engine_backend).run(copy.deepcopy(mini_trace()))
    assert {r.rid: r.first_token for r in p_sim.done_requests} == \
        {r.rid: r.first_token for r in p_eng.done_requests}
    for p in (p_sim, p_eng):
        for r in p.done_requests:
            assert r.first_token is not None
            assert r.arrival <= r.first_token <= r.finish, (pol, r.rid)
            assert r.ttft is not None and r.ttft >= 0.0


@pytest.fixture(scope="module")
def measured_backend(cluster, params):
    return EngineBackend(cluster[0], params, max_len=128, layers_per_quantum=1,
                         clock="measured", device="cpu")


@pytest.mark.parametrize("pol", list(POLICY_NAMES))
def test_engine_sweep_measured(measured_backend, cluster, pol):
    """Every policy serves the mini-trace end to end on torch engines with
    the measured clock, conserving requests and generating every target."""
    _, cc, em = cluster
    be = measured_backend
    be.reset()
    p = make_policy(pol, cc, em)
    s = Simulator(p, backend=be).run(copy.deepcopy(mini_trace()))
    done = s["short_completed"] + s["long_completed"]
    starved = sum(1 for r in p.all_requests if r.phase == Phase.STARVED)
    # fifo_noshort refuses longs at arrival (the Fig. 2 comparison arm)
    admitted = len(p.all_requests) - \
        (s["n_long"] if pol == "fifo_noshort" else 0)
    assert done + starved == admitted
    assert be.measured_s > 0.0
    for r in p.done_requests:
        assert len(be.generated[r.rid]) == be._target_new(r), (pol, r.rid)
    assert not be._kv


def coord_trace():
    """Two short floods with light decode around a quiet gap: the
    coordinator borrows a decode replica, returns it, and borrows again."""
    rng = np.random.default_rng(42)
    reqs, rid = [], 0
    for wave_start in (0.0, 0.25):
        for i in range(14):
            reqs.append(Request(
                rid=rid, arrival=round(wave_start + i * 5e-05, 9),
                input_len=int(rng.integers(2500, 3500)),
                output_len=int(rng.integers(3, 8))))
            rid += 1
    return reqs


def test_role_flip_parity_across_backends(cluster, engine_backend):
    """§5.2 coordination: the same role flips, in the same order at the same
    times, on both backends (3 general + 2 decode replicas), in both
    directions, each vetted by the engine backend."""
    cfg = cluster[0]
    cc = ClusterConfig(n_nodes=1, gpus_per_node=5, tp=1,
                       n_short_decode_replicas=2, max_decode_concurrency=8)
    em = ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=0.5)
    trace = coord_trace()
    p_sim = make_policy("pecsched/coord", cc, em)
    p_sim.record_decisions = True
    Simulator(p_sim).run(copy.deepcopy(trace))
    engine_backend.reset()
    flips_before = engine_backend.stats["role_flips"]
    p_eng = make_policy("pecsched/coord", cc, em)
    p_eng.record_decisions = True
    Simulator(p_eng, backend=engine_backend).run(copy.deepcopy(trace))
    assert p_sim.role_log and p_sim.role_log == p_eng.role_log
    assert p_sim.decision_log == p_eng.decision_log
    directions = {(old, new) for (_, _, old, new) in p_sim.role_log}
    assert ("short_decode", "prefill") in directions
    assert ("prefill", "short_decode") in directions
    assert engine_backend.stats["role_flips"] - flips_before \
        == len(p_eng.role_log)
    assert {r.rid for r in p_sim.done_requests} == \
        {r.rid for r in p_eng.done_requests} == {r.rid for r in trace}


def _prefilled(eng, rid, n):
    st = eng.start_prefill(rid, torch.zeros((1, n), dtype=torch.long))
    done = False
    while not done:
        st, done = eng.prefill_quantum(st)
    return st


def test_engine_role_change_rejects_undrained_engine(cluster, params):
    """Flipping a replica whose engine holds a live decode slot raises; once
    drained the flip is legal."""
    be = EngineBackend(cluster[0], params, max_len=64, layers_per_quantum=1,
                       clock="analytic", device="cpu")
    eng = be._engine(0)
    eng.admit(7, _prefilled(eng, 7, 8))
    with pytest.raises(RuntimeError, match="unsafe role flip"):
        be.role_change(0.0, 0, "short_decode", "prefill")
    eng.evict(0)
    be.role_change(0.0, 0, "short_decode", "prefill")
    assert be.stats["role_flips"] == 1


def test_admit_raises_slots_full(cluster, params):
    eng = ReplicaEngine(cluster[0], params, max_slots=2, max_len=64,
                        device="cpu")
    for rid in range(2):
        eng.admit(rid, _prefilled(eng, rid, 8))
    st = _prefilled(eng, 2, 8)
    with pytest.raises(SlotsFull):
        eng.admit(2, st)
    eng.evict(0)
    assert eng.admit(2, st) == 0


def test_admit_raises_slots_full_on_block_budget(cluster, params):
    """A pool without the block budget refuses `admit` (free slots or not)
    and `scatter_kv` with SlotsFull; an eviction unblocks both.  A bound
    slot reserves its full max_len budget (4 blocks of 16 here)."""
    eng = ReplicaEngine(cluster[0], params, max_slots=4, max_len=64,
                        block_size=16, n_blocks=5, device="cpu")
    slot = eng.admit(0, _prefilled(eng, 0, 20))
    assert len(eng.kvpool.free) == 1
    assert len(eng.free_slots()) == 3
    st2 = _prefilled(eng, 1, 20)
    with pytest.raises(SlotsFull):
        eng.admit(1, st2)
    k, v = st2.full_kv()
    with pytest.raises(SlotsFull):
        eng.scatter_kv(1, k, v)
    eng.evict(slot)
    eng.scatter_kv(1, k, v)                     # slotless: data blocks only
    assert len(eng.kvpool.free) == 3
    assert eng.bind_slot(1) == 0                # binding reserves the rest
    assert len(eng.kvpool.free) == 1
    out = eng.decode_iteration({0: 3})
    assert isinstance(out[0], int)


def test_decode_waits_for_slots(cluster, params):
    """A decode burst larger than the slot count completes by waiting for
    evictions instead of failing."""
    _, cc, em = cluster
    be = EngineBackend(cluster[0], params, max_len=128, layers_per_quantum=1,
                       max_slots=2, clock="analytic", device="cpu")
    reqs = [Request(rid=i, arrival=0.0, input_len=500, output_len=8)
            for i in range(7)]
    s = Simulator(make_policy("pecsched", cc, em), backend=be).run(reqs)
    assert s["short_completed"] == 7
    assert be.stats["kv_migrations"] == 7
    for i in range(7):
        assert len(be.generated[i]) == be._target_new(reqs[0])


# ---- the evaluation entry points, reduced, on the CPU -----------------------
def test_serve_cluster_serves_every_request():
    """launch/serve_cluster.py's build and run functions: both policies
    serve every request of the 24-request azure_default trace with its
    target length of in-vocab tokens, and on the analytic clock the engine
    run's summary equals the SimBackend's."""
    from repro_torch.launch import serve_cluster
    stack = serve_cluster.build(layers=2, device="cpu", clock="analytic")
    reqs = serve_cluster.make_trace(stack, "azure_default", 24,
                                    warmup=False)["requests"]
    assert any(r.is_long for r in reqs)
    for pol in ("pecsched", "fifo"):
        r = serve_cluster.run_policy(stack, reqs, pol, compare_sim=True)
        assert len(r["done"]) == len(reqs)
        for rid, toks in r["generated"].items():
            assert len(toks) == r["target_new"][rid]
            assert all(0 <= t < stack.cfg.vocab_size for t in toks)
        assert r["summary"] == r["sim"]
    ls = serve_cluster.layer_seconds(stack, reqs)
    assert ls["measured_s_per_layer"] > 0 and ls["model_s_per_layer"] > 0


def test_engine_overhead_suspension_bytes():
    """launch/engine_overhead.py on the reduced model: the paused state is
    one (S, d_model) activation, against the KV of every layer (finished)
    and of the half done at the pause."""
    from repro_torch.launch import engine_overhead
    out = engine_overhead.run(layers=4, device="cpu", reps=1)
    cfg = reduced_config(get_config("mistral_7b"), layers=4)
    kv_per_layer = 2 * cfg.num_kv_heads * cfg.head_dim
    assert out["suspend_state_vs_kv"] == cfg.d_model / (4 * kv_per_layer)
    assert out["suspend_state_vs_kv_at_pause"] == \
        cfg.d_model / (2 * kv_per_layer)
    assert out["kv_migrated_bytes"] == 4 * 96 * kv_per_layer * 4
    assert out["t_long_prefill_ms"] > 0 and out["kv_migration_ms"] > 0


@pytest.mark.parametrize("seed", [0, 2])
def test_full_width_prefill_target_lets_fifo_finish(seed):
    """At full width the H100 cost model prices a 300K-token long at tens of
    seconds: at the reduced model's 0.5 s target FIFO's head-of-line long
    waits forever for more replicas than the mini cluster has.  At the
    target serve_cluster fits to the trace the longest long claims both
    general engines and no long more, every request completes under FIFO,
    and PecSched preempts the long for the shorts behind it (sim only: no
    weights needed)."""
    from repro_torch.core import get_scenario
    from repro_torch.hardware import H100_SXM
    from repro_torch.launch import serve_cluster
    cfg = get_config("mistral_7b")
    cc = ClusterConfig(n_nodes=1, gpus_per_node=3, tp=1, hw=H100_SXM,
                       n_short_decode_replicas=1, max_decode_concurrency=8)
    reqs = get_scenario("azure_default", n_requests=24, seed=seed,
                        arrival_rps=13.0)
    reduced = serve_cluster.REDUCED_PREFILL_TARGET_S
    fitted = serve_cluster.fit_prefill_target(
        ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=reduced),
        reqs, 2)
    longs = [r.input_len for r in reqs if r.is_long]
    em = ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=fitted)
    assert em.replicas_needed(max(longs)) == 2
    assert all(em.replicas_needed(n) <= 2 for n in longs)
    done = {}
    for target in (reduced, fitted):
        em = ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=target)
        s = Simulator(make_policy("fifo", cc, em)).run(copy.deepcopy(reqs))
        done[target] = s["short_completed"] + s["long_completed"]
    assert done[reduced] < len(reqs)
    assert done[fitted] == len(reqs)
    s = Simulator(make_policy("pecsched", cc, em)).run(copy.deepcopy(reqs))
    assert s["short_completed"] + s["long_completed"] == len(reqs)
    assert s["preemptions"] > 0


def test_full_width_prompts_scale_linearly():
    """serve_cluster.scaled_prompts: a prompt is its cluster length over
    FULL_TOKEN_DIVISOR rounded up to 16 tokens, 16 at least and the
    engine's longest prompt at most; the same rid gives the same tokens,
    and a prefix group's requests share their scaled prefix."""
    from repro_torch.launch import serve_cluster
    cfg = get_config("mistral_7b")
    provide = serve_cluster.scaled_prompts(cfg, 4079, seed=0)
    div = serve_cluster.FULL_TOKEN_DIVISOR

    def req(rid, n, **kw):
        return Request(rid=rid, arrival=0.0, input_len=n, output_len=4, **kw)
    assert [len(provide(req(i, n))) for i, n in enumerate(
        (1, 16 * div, 16 * div + 1, 222_947, 400_000))] == [16, 16, 32, 3488, 4079]
    a = provide(req(7, 5000))
    assert np.array_equal(a, provide(req(7, 5000)))
    assert a.dtype == np.int32 and a.min() >= 0 and a.max() < cfg.vocab_size
    x = provide(req(1, 9000, prefix_group=3, prefix_len=4096))
    y = provide(req(2, 9000, prefix_group=3, prefix_len=4096))
    assert np.array_equal(x[:64], y[:64]) and not np.array_equal(x[64:], y[64:])
