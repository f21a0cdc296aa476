"""Gang-scheduled SP prefill on the port's engines: the twins of the six
tests of tests/multidevice/test_gang_sp.py, parametrised as there, on a
single-controller mesh of eight CPU ranks (``sp_devices=["cpu"] * 8``).

Held against the reference:

* in-process, the JAX `ReplicaEngine`'s single-replica prefill on the same
  weights (`bridge.params_from_jax`) and prompt: the port's gang logits to
  5e-4 and its gang KV to 5e-5, the reference's own tolerances (f32 sums
  in another order, over 4 layers);
* the reference's `GangSPRunner` and its `EngineBackend`, which need eight
  XLA devices, run once for this module in ONE subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (this file run as
  a script), writing their logits, KV and the quiet gang run's generated
  tokens to an .npz: the same tolerances, the same tokens.

Two assertions of the reference depend on ranks running at once on
distinct devices: the engine world's ``d_jct > 0`` of the /FSP ablation
and ``measured[degree] < measured[1]`` of the calibration.  On
``["cpu"] * 8`` the ranks run one after another in one process, so those
two stay as written in tests marked `cuda` that run the gang over one card
per rank and skip below two cards; everything else is asserted here.
"""
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import init_params as j_init_params
from repro.serving.engine import ReplicaEngine as JaxEngine
from repro.sp import planner as jplanner
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import ClusterConfig, ExecutionModel, Simulator, make_policy
from repro_torch.core.request import Request
from repro_torch.hardware import H100_SXM
from repro_torch.serving.backend import EngineBackend
from repro_torch.serving.engine import ReplicaEngine
from repro_torch.sp.gang import GangSPRunner, make_gang_mesh, plan_for_gang
from repro_torch.sp.planner import TPU_V5E, SPPlan

# one intra-op thread: the suite runs several test workers on a few cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LAYERS = 4
MODELS = ("mistral_7b", "qwen2_7b")
CPU8 = ["cpu"] * 8
PROMPT = 96            # the parity prompt (seed 1)


def small_cfg(get, reduce, name):
    return dataclasses.replace(reduce(get(name), layers=LAYERS),
                               dtype="float32", sliding_window=0)


def _parity_tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, PROMPT).astype(np.int32)


def _jax_outputs(path):
    """The reference's gang runner (both models, both inner strategies) and
    its backend's quiet gang run; needs 8 XLA devices."""
    sys.path.insert(0, str(ROOT / "tests" / "multidevice"))
    import test_gang_sp as ref
    from repro.serving.backend import EngineBackend as JaxBackend
    from repro.sp.gang import GangSPRunner as JaxRunner
    from repro.sp.gang import make_gang_mesh as jax_mesh
    assert jax.device_count() >= 8, jax.device_count()
    out = {}
    for name in MODELS:
        cfg = small_cfg(j_get_config, j_reduced_config, name)
        params = j_init_params(jax.random.PRNGKey(0), cfg)
        toks = _parity_tokens(cfg.vocab_size)
        for strategy in ("a2a", "allgather"):
            runner = JaxRunner(cfg, params, jax_mesh(4, cfg.num_heads), strategy)
            st = runner.start(7, toks, SPPlan("ulysses", "ulysses", 1.0))
            done = False
            while not done:
                st, done = runner.quantum(st, 4)
            out[f"{name}_{strategy}_logits"] = np.asarray(runner.logits(st))
            out[f"{name}_{strategy}_k"], out[f"{name}_{strategy}_v"] = \
                runner.gather_kv(st)
    cfg = ref.small_cfg("mistral_7b")
    cc, em = ref.gang_cluster(cfg)
    be = JaxBackend(cfg, j_init_params(jax.random.PRNGKey(0), cfg), max_len=256,
                    layers_per_quantum=1, clock="measured",
                    token_provider=ref._tokens_for)
    ref.run_policy(be, cc, em, "pecsched", ref.gang_trace(n_shorts=0))
    assert be.stats["gang_prefills"] == 1
    out["quiet_tokens"] = np.asarray(be.generated[0])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("gang") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return dict(np.load(path))


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    jcfg = small_cfg(j_get_config, j_reduced_config, request.param)
    cfg = small_cfg(get_config, reduced_config, request.param)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return request.param, jcfg, jparams, cfg, params


# ---------------- numerical parity ------------------------------------------
@pytest.mark.parametrize("attn_strategy", ["megatron", "ulysses"])
@pytest.mark.parametrize("mlp_strategy", ["megatron", "ulysses"])
def test_gang_prefill_and_scatter_match_single_replica(model, jax_out,
                                                       attn_strategy,
                                                       mlp_strategy):
    """Gang logits == single-replica logits, and the KV that `scatter_kv`
    lands in the home replica's paged pool == the single-replica prefill KV,
    for every planner strategy combination: against the port's own engine,
    the reference's engine, and the reference's gang."""
    name, jcfg, jparams, cfg, params = model
    toks = _parity_tokens(cfg.vocab_size)

    eng = ReplicaEngine(cfg, params, max_len=256, layers_per_quantum=1,
                        device="cpu")
    st = eng.start_prefill(0, torch.from_numpy(toks[None]).long())
    done = False
    while not done:
        st, done = eng.prefill_quantum(st)
    ref_logits = eng.prefill_logits(st).numpy()
    ref_k, ref_v = (t.numpy() for t in st.full_kv())

    jeng = JaxEngine(jcfg, jparams, max_len=256, layers_per_quantum=1)
    jst = jeng.start_prefill(0, jnp.asarray(toks[None]))
    done = False
    while not done:
        jst, done = jeng.prefill_quantum(jst)
    j_logits = np.asarray(jeng.prefill_logits(jst))
    j_k = np.asarray(jnp.stack(jst.kv_k, 0)[:, 0])
    j_v = np.asarray(jnp.stack(jst.kv_v, 0)[:, 0])

    mesh = make_gang_mesh(4, cfg.num_heads, CPU8)
    plan = SPPlan(attn_strategy=attn_strategy, mlp_strategy=mlp_strategy,
                  est_time=1.0)
    runner = GangSPRunner(cfg, params, mesh, plan.inner_impl)
    gst = runner.start(7, toks, plan)
    gdone = False
    while not gdone:
        gst, gdone = runner.quantum(gst, 4)
    g_logits = runner.logits(gst).numpy()
    gk, gv = runner.gather_kv(gst, "cpu")

    key = f"{name}_{plan.inner_impl}"
    for want_logits, want_k, want_v in ((ref_logits, ref_k, ref_v),
                                        (j_logits, j_k, j_v),
                                        (jax_out[f"{key}_logits"],
                                         jax_out[f"{key}_k"], jax_out[f"{key}_v"])):
        assert float(np.abs(g_logits - want_logits).max()) < 5e-4
        np.testing.assert_allclose(gk.numpy(), want_k, atol=5e-5)
        np.testing.assert_allclose(gv.numpy(), want_v, atol=5e-5)

    # scatter into the home replica's paged pool and read it back
    home = ReplicaEngine(cfg, params, max_len=256, device="cpu")
    home.scatter_kv(7, gk, gv)
    pk, pv = home.kvpool.gather(7)
    assert torch.equal(pk, gk) and torch.equal(pv, gv)


def test_planner_strategy_reaches_the_gang():
    """The gang must run the planner's chosen inner strategy
    (SPPlan.inner_impl), not a hardcoded one; the plan is the reference
    planner's on the same hardware (the reference's default TPU spec and
    the backend's default, the H100's)."""
    cfg = small_cfg(get_config, reduced_config, "mistral_7b")
    jcfg = small_cfg(j_get_config, j_reduced_config, "mistral_7b")
    mesh = make_gang_mesh(4, cfg.num_heads, CPU8)
    assert mesh.shape == {"ring": 2, "sp": 2}
    for hw in (TPU_V5E, H100_SXM):
        plan = plan_for_gang(cfg, 300_000, mesh, hw)
        assert plan.inner_impl in ("a2a", "allgather")
        assert plan.inner_impl == \
            {"megatron": "allgather", "ulysses": "a2a"}[plan.attn_strategy]
        want = jplanner.plan_fast_sp(
            jcfg, 300_000, n_nodes=2, gpus_per_node=2, tp=2,
            hw=jplanner.HardwareSpec(**dataclasses.asdict(hw)))
        assert (plan.attn_strategy, plan.mlp_strategy, plan.est_time) == \
            (want.attn_strategy, want.mlp_strategy, want.est_time)


# ---------------- scheduler-level harness -----------------------------------
N_GENERAL = 2          # 2-replica gang: degree 2, mid-prefill preemption point
LONG_PROMPT = 224      # engine-side tokens for the long (compute-dominated)
SHORT_PROMPT = 16


def gang_cluster(cfg):
    """N_GENERAL general + 1 decode replica, prefill target tight enough
    that a 300K long claims every general replica (an SP gang)."""
    cc = ClusterConfig(n_nodes=1, gpus_per_node=N_GENERAL + 1, tp=1,
                       n_short_decode_replicas=1, max_decode_concurrency=8)
    em = ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=0.05)
    assert em.replicas_needed(300_000) >= N_GENERAL
    return cc, em


def gang_trace(n_shorts=12, long_output=6, gap=2e-3):
    reqs = [Request(rid=0, arrival=0.0, input_len=300_000,
                    output_len=long_output, is_long=True)]
    rng = np.random.default_rng(4)
    for i in range(1, n_shorts + 1):
        reqs.append(Request(rid=i, arrival=round(i * gap, 6),
                            input_len=int(rng.integers(300, 3000)),
                            output_len=int(rng.integers(2, 8))))
    return reqs


def _tokens_for(req):
    """The reference test's prompts.  It draws ids below 1000 for a
    512-token vocab, and its embedding gather clamps an id past the table
    to the last row (out-of-range gathers clamp in JAX), so the same
    prompts here clip to 511: the same embeddings."""
    n = LONG_PROMPT if req.is_long else SHORT_PROMPT
    rng = np.random.default_rng(req.rid + 11)
    return rng.integers(0, 1000, n).clip(max=511).astype(np.int32)


def _backend_stack(sp_devices, device="cpu"):
    jcfg = small_cfg(j_get_config, j_reduced_config, "mistral_7b")
    cfg = small_cfg(get_config, reduced_config, "mistral_7b")
    params = params_from_jax(jax.tree.map(
        np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg)), device=device)
    cc, em = gang_cluster(cfg)
    be = EngineBackend(cfg, params, max_len=256, layers_per_quantum=1,
                       clock="measured", token_provider=_tokens_for,
                       device=device, sp_devices=sp_devices, hw=TPU_V5E)
    return cfg, cc, em, be


@pytest.fixture(scope="module")
def backend_stack():
    return _backend_stack(CPU8)


def run_policy(be, cc, em, policy, trace, *, enable_sp=True):
    be.reset()
    be.enable_sp = enable_sp
    pol = make_policy(policy, cc, em)
    summary = Simulator(pol, backend=be).run(copy.deepcopy(trace))
    return pol, summary


def test_gang_uses_fewer_engine_quanta(backend_stack):
    """Acceptance bar: pecsched's long prefill via a degree>=2 gang
    completes in measurably fewer engine quanta than the single-replica
    path on the same trace."""
    cfg, cc, em, be = backend_stack
    trace = gang_trace()

    _, s_sp = run_policy(be, cc, em, "pecsched", trace, enable_sp=True)
    sp_stats = dict(be.stats)
    assert sp_stats["gang_prefills"] >= 1
    assert sp_stats["gang_scatters"] >= 1
    assert s_sp["long_completed"] == 1
    assert s_sp["short_completed"] == len(trace) - 1

    _, s_single = run_policy(be, cc, em, "pecsched", trace, enable_sp=False)
    single_stats = dict(be.stats)
    assert single_stats.get("gang_prefills", 0) == 0
    assert s_single["long_completed"] == 1

    # lpq=1, degree 2: the gang covers 2 layers per quantum.  Shorts take
    # identical quanta in both runs, so the long's cost is the difference.
    gang_quanta = sp_stats["sp_prefill_quanta"]
    long_single_quanta = (single_stats["prefill_quanta"]
                          - sp_stats["prefill_quanta"])
    assert long_single_quanta == LAYERS
    assert gang_quanta == -(-LAYERS // 2)
    assert gang_quanta < long_single_quanta


def test_preempted_gang_long_generates_identical_tokens(backend_stack, jax_out):
    """A gang-SP long preempted (and resumed) by short pressure must
    generate exactly the tokens of an unpreempted gang run (the paper's
    suspension-state exactness, on the SP path) — and those of the
    reference's unpreempted gang run."""
    cfg, cc, em, be = backend_stack

    _, s_quiet = run_policy(be, cc, em, "pecsched", gang_trace(n_shorts=0))
    assert be.stats["gang_prefills"] == 1
    quiet_tokens = list(be.generated[0])
    assert s_quiet["preemptions"] == 0

    _, s_busy = run_policy(be, cc, em, "pecsched",
                           gang_trace(n_shorts=16, gap=1e-4))
    assert be.stats["gang_prefills"] == 1
    assert s_busy["preemptions"] > 0, "short pressure must preempt the gang"
    busy_tokens = list(be.generated[0])

    assert quiet_tokens == busy_tokens
    assert len(quiet_tokens) == be._target_new(gang_trace()[0])
    assert quiet_tokens == jax_out["quiet_tokens"].tolist()


def _ablation_deltas(be, cc, em, worlds):
    """pecsched vs pecsched/FSP: (long JCT, preemptions) deltas per world."""
    trace = gang_trace(n_shorts=24, gap=1.5e-3)
    deltas = {}
    for world in worlds:
        jct, preempt = {}, {}
        for pol_name in ("pecsched", "pecsched/fsp"):
            if world == "sim":
                pol = make_policy(pol_name, cc, em)
                s = Simulator(pol).run(copy.deepcopy(trace))
            else:
                # warm pass runs every shape once; measure the second pass
                run_policy(be, cc, em, pol_name, trace)
                pol, s = run_policy(be, cc, em, pol_name, trace)
            longs = [r for r in pol.done_requests if r.is_long]
            assert len(longs) == 1
            jct[pol_name] = longs[0].finish - longs[0].arrival
            preempt[pol_name] = s["preemptions"]
        deltas[world] = (jct["pecsched/fsp"] - jct["pecsched"],
                         preempt["pecsched/fsp"] - preempt["pecsched"])
    return deltas


def test_fsp_ablation_same_sign_on_sim_and_measured_engine(backend_stack):
    """pecsched vs pecsched/FSP (the paper's Fig. 14 / Table 3 ablation):
    /FSP's long finishes later and is suspended at least as often on the
    analytic SimBackend; on the measured-clock engines of eight CPU ranks
    it is suspended at least as often.  That /FSP's long also finishes
    later on the engines needs the ranks to run at once on distinct
    devices: `test_fsp_ablation_engine_world_on_cards`."""
    cfg, cc, em, be = backend_stack
    deltas = _ablation_deltas(be, cc, em, ("sim", "engine"))
    d_jct, d_pre = deltas["sim"]
    assert d_jct > 0, deltas             # /FSP's long finishes later
    assert d_pre >= 0, deltas            # suspended at least as often
    assert deltas["engine"][1] >= 0, deltas


def _calibrate(be, cc, em):
    trace = gang_trace(n_shorts=2)
    # degree-1 long timings come from a no-gang run, gang timings from an
    # SP run; run each shape first so medians are steady-state
    for sp in (False, True):
        run_policy(be, cc, em, "pecsched", trace, enable_sp=sp)
    be.sp_timings.clear()
    for sp in (False, True):
        run_policy(be, cc, em, "pecsched", trace, enable_sp=sp)
    t_ring_before = em.prefill_time(300_000, 2, sp_mode="ring")
    t_local_before = em.prefill_time(300_000, 1, sp_mode="local")
    measured = be.calibrate_costmodel(em)
    degree = max(measured)
    assert degree >= 2 and 1 in measured
    t_fast = em.prefill_time(300_000, degree, sp_mode="fastsp")
    t_local = em.prefill_time(300_000, 1, sp_mode="local")
    # the calibrated estimate IS the measured speedup curve
    assert t_fast == pytest.approx(t_local / (measured[1] / measured[degree]))
    # ring-only and local pricing never consult the calibration
    assert em.prefill_time(300_000, 2, sp_mode="ring") == t_ring_before
    assert t_local == t_local_before
    return measured, degree, t_fast, t_local


def test_measured_timings_calibrate_the_analytic_winner(backend_stack):
    """The engine's measured per-degree timings, fed back through
    `calibrate_sp`, make the analytic model's fast-SP price exactly the
    measured speedup curve, and leave ring-only and local pricing alone.
    That the gang measures faster than the single replica (and so wins in
    the calibrated model) needs distinct devices:
    `test_measured_speedup_on_cards`."""
    cfg, cc, em, be = backend_stack
    try:
        _calibrate(be, cc, em)
    finally:
        em._sp_speedup = {}                              # leave em clean


# ---------------- the speed-dependent halves, one card per rank ------------
@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the gang's ranks must run at once "
                    "on distinct cards for the gang to be faster")
    n = torch.cuda.device_count()
    return _backend_stack([torch.device("cuda", i) for i in range(n)],
                          device="cuda")


@pytest.mark.cuda
def test_fsp_ablation_engine_world_on_cards(cards):
    """The engine world of the ablation, as the reference asserts it."""
    cfg, cc, em, be = cards
    d_jct, d_pre = _ablation_deltas(be, cc, em, ("engine",))["engine"]
    assert d_jct > 0, (d_jct, d_pre)     # /FSP's long finishes later
    assert d_pre >= 0, (d_jct, d_pre)


@pytest.mark.cuda
def test_measured_speedup_on_cards(cards):
    """The gang beat the single-replica prefill, and the calibrated model
    predicts that winner."""
    cfg, cc, em, be = cards
    try:
        measured, degree, t_fast, t_local = _calibrate(be, cc, em)
        assert measured[degree] < measured[1], measured
        assert t_fast < t_local
    finally:
        em._sp_speedup = {}


if __name__ == "__main__":
    _jax_outputs(sys.argv[1])
