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
                              Simulator, make_policy)
from repro_torch.core.request import Request
from repro_torch.models import init_params
from repro_torch.serving.backend import EngineBackend

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
def engine_backend(cluster):
    cfg = cluster[0]
    return EngineBackend(cfg, init_params(cfg, seed=0, device="cpu"),
                         max_len=128, layers_per_quantum=1, clock="analytic",
                         device="cpu")


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
