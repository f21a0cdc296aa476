"""The port's elastic-fleet layer (`core/fleet.py`, a copy of the
reference's) over torch engines: reclaiming a general replica mid-run parks
its resident KV host-side and every request still completes, as
tests/test_fleet.py pins for the reference; and the whole run, reclaim
included, makes the reference's decisions on the JAX EngineBackend."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core as jcore
import repro.core.fleet as jfleet
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.core.fleet as tfleet
from repro.models import init_params as jax_init_params
from repro.serving.backend import EngineBackend as JaxEngineBackend
from repro_torch.models import init_params
from repro_torch.serving.backend import EngineBackend

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)


def mini_trace(core):
    """Two longs under sustained short pressure (tests/test_fleet.py), as
    `core`'s own Request objects."""
    rng = np.random.default_rng(0)
    reqs, t = [], 0.0
    for i in range(14):
        is_long = i in (0, 7)
        t += 0.002 if i else 0.0
        reqs.append(core.Request(
            rid=i, arrival=round(t, 6),
            input_len=300_000 if is_long else int(rng.integers(300, 3000)),
            output_len=60 if is_long else int(rng.integers(10, 60)),
            is_long=is_long))
    return reqs


def small_cfg(configs):
    return dataclasses.replace(
        configs.reduced_config(configs.get_config("mistral_7b"), layers=2),
        dtype="float32", sliding_window=0)


def reclaim_run(core, fleet, backend, cfg, pol):
    """`pol` on 2 general + 1 decode replica through one package's brain,
    with replica 0 reclaimed at 0.3 s after a 0.05 s notice."""
    cc = core.ClusterConfig(n_nodes=1, gpus_per_node=3, tp=1,
                            n_short_decode_replicas=1,
                            max_decode_concurrency=8)
    em = core.ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=0.5)
    p = core.make_policy(pol, cc, em)
    p.record_decisions = True
    ctrl = fleet.FleetController(fleet.FleetConfig(reclamations=((0.3, 0),),
                                                   notice_s=0.05))
    backend.reset()
    s = core.Simulator(p, backend=backend, fleet=ctrl).run(
        copy.deepcopy(mini_trace(core)))
    return p, s


@pytest.fixture(scope="module")
def torch_backend():
    cfg = small_cfg(tconfigs)
    return cfg, EngineBackend(cfg, init_params(cfg, seed=0, device="cpu"),
                              max_len=128, layers_per_quantum=1,
                              clock="analytic", device="cpu")


@pytest.fixture(scope="module")
def jax_backend():
    cfg = small_cfg(jconfigs)
    return cfg, JaxEngineBackend(cfg, jax_init_params(jax.random.PRNGKey(0), cfg),
                                 max_len=128, layers_per_quantum=1,
                                 clock="analytic")


def test_engine_reclaim_parks_and_completes(torch_backend):
    """Reclaiming a general replica on the torch EngineBackend parks its
    resident KV host-side and the run still completes every request."""
    cfg, backend = torch_backend
    p, s = reclaim_run(tcore, tfleet, backend, cfg, "pecsched")
    assert s["short_completed"] == s["n_short"]
    assert s["long_completed"] == s["n_long"]
    assert backend.stats["reclaims"] == 1
    for r in p.done_requests:
        assert len(backend.generated.get(r.rid, [])) >= 1


@pytest.mark.parametrize("pol", ["pecsched", "fifo"])
def test_engine_reclaim_matches_reference(torch_backend, jax_backend, pol):
    """The same reclaim run on the reference's JAX EngineBackend: identical
    decision log and summary, churn counters included (the analytic clock
    makes every decision independent of numerics)."""
    cfg, backend = torch_backend
    p_t, s_t = reclaim_run(tcore, tfleet, backend, cfg, pol)
    jcfg, jbe = jax_backend
    p_j, s_j = reclaim_run(jcore, jfleet, jbe, jcfg, pol)
    assert p_t.decision_log == p_j.decision_log
    assert s_t == s_j
    assert s_t["reclaims"] == 1
    assert backend.stats["reclaims"] == jbe.stats["reclaims"] == 1
