"""Claims-as-tests on the port: the paper's §6 evaluation replayed through
`repro_torch.experiments`, the twin of tests/test_claims.py.

The canonical smoke grid (`repro_torch.experiments.smoke_grid`) runs on
both backends — the analytic simulator on the paper cluster and torch
engines (the reference's reduced f32 stack, on the CPU here) on the small
cluster — and every claim in the registry must hold with its direction
and tolerance, one parametrised case per claim.  Also covered: the engines
really executed, the on-disk cache (a warm rerun executes nothing; engine
results are kept per device), the regression canaries, and the port held
to the JAX package: for the 8 `smoke_mini` engine specs and one spec each
of `churn`, `slo_tiered` and `shared_prefix`, the port's summary equals
`repro.experiments.runner.run_spec`'s key for key (counts and strings
exactly, floats to 1e-9 relative), apart from `wall_s` and
`sched_time_s`.  Reports go under a temporary directory.
"""
import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

import repro_torch.experiments as ex
from repro.experiments import runner as jax_runner
from repro.experiments.spec import ExperimentSpec as JaxSpec
from repro_torch.experiments import runner
from repro_torch.experiments.claims import CLAIMS
from repro_torch.experiments.spec import ExperimentSpec, grid
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import flash_decode as fd_mod
from repro_torch.kernels.checks import ENGINE_F32_HEADS

pytestmark = pytest.mark.claims

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

VOLATILE = ("wall_s", "sched_time_s")
FLOAT_RTOL = 1e-9


# ---------------- shared grid execution -------------------------------------
@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The smoke grid on both backends, with every call the engine cells
    make to B1's and B2's wrappers recorded (on the CPU the wrappers run
    their plain versions, which this wraps; on the card each call is one
    launch)."""
    cache = tmp_path_factory.mktemp("claims_cache")
    specs = ex.smoke_grid()
    calls = {"flash_attention": [], "flash_decode": []}
    with pytest.MonkeyPatch.context() as mp:
        for mod, fn, key in ((fa_mod, "torch_attention", "flash_attention"),
                             (fd_mod, "torch_decode", "flash_decode")):
            def record(q, k, v, *args, _plain=getattr(mod, fn), _key=key, **kw):
                calls[_key].append((tuple(q.shape), tuple(k.shape), q.dtype,
                                    args, kw))
                return _plain(q, k, v, *args, **kw)
            mp.setattr(mod, fn, record)
        results = ex.run_sweep(specs, cache_dir=cache, device="cpu")
    return {"specs": specs, "results": results, "cache": cache, "calls": calls}


@pytest.fixture(scope="module")
def claim_results(smoke, tmp_path_factory):
    out = tmp_path_factory.mktemp("claims_report")
    cres = ex.evaluate_claims(ex.smoke_sweep_cells(smoke["results"]))
    ex.write_report(cres, out / "claims_report.json",
                    md_path=out / "claims_ledger.md",
                    meta={"source": "tests/test_torch_claims.py",
                          "n_specs": len(smoke["specs"])})
    return cres, out


# ---------------- the ledger itself -----------------------------------------
def test_registry_shape():
    assert len(CLAIMS) >= 12
    dual = [c for c in CLAIMS.values()
            if {"sim", "engine"} <= set(c.backends)]
    assert len(dual) >= 10
    refs = " ".join(c.paper_ref for c in CLAIMS.values())
    for artifact in ("Fig. 2", "Table 1", "Table 2", "Table 3", "Fig. 9",
                     "Fig. 10", "Fig. 11", "Fig. 12", "Fig. 13", "Fig. 14",
                     "Table 6", "Fig. 3"):
        assert artifact in refs, f"no claim covers {artifact}"


@pytest.mark.parametrize("cid", sorted(CLAIMS))
def test_claim(claim_results, cid):
    """Every declared (claim, backend) pair evaluates — never skips — and
    passes its bound, the engine side on torch engines."""
    rs = [r for r in claim_results[0] if r.cid == cid]
    assert {r.backend for r in rs} == set(CLAIMS[cid].backends)
    for r in rs:
        assert not r.skipped, f"{cid}[{r.backend}] skipped: {r.skipped}"
        assert r.passed, (f"{cid}[{r.backend}] value {r.value} violates "
                          f"{r.direction} {r.bound} ({r.paper_ref})")


def test_dual_backend_coverage(claim_results):
    evaluated_on = {}
    for r in claim_results[0]:
        if not r.skipped:
            evaluated_on.setdefault(r.cid, set()).add(r.backend)
    assert len([c for c, bs in evaluated_on.items()
                if {"sim", "engine"} <= bs]) >= 10


def test_engines_really_executed(smoke):
    """The engine cells came from torch compute on the CPU stack: prefill
    quanta ran and tokens were generated."""
    _, _, _, backend = runner._ENGINE_STACKS[("mistral_7b", "analytic", "cpu")]
    assert backend.device.type == "cpu"
    assert backend.stats["prefill_quanta"] > 0 or \
        backend.stats["short_prefill"] > 0
    assert any(len(toks) >= 1 for toks in backend.generated.values())


def test_engine_cells_kernel_calls(smoke):
    """What the engine cells ask of B1 and B2: 2,746 and 7,972 calls, the
    launches chip_smoke.py's `claims` line counts on the card (decisions on
    the analytic clock do not depend on the device), all in f32 at the
    shapes `checks.engine_f32_checks` holds the kernels to there: B1 causal
    at batch 1 with 4 query / 2 KV heads of 64, at most 128 keys, from
    offset 0 or as a prefix-cache suffix, no window or kv_len; B2 at 8
    slots over a 128-key cache, no window."""
    h, kvh, d = ENGINE_F32_HEADS
    calls = smoke["calls"]
    assert (len(calls["flash_attention"]), len(calls["flash_decode"])) == \
        (2746, 7972)
    for q, k, dtype, args, kw in calls["flash_attention"]:
        assert dtype == torch.float32 and not args
        b, hq, sq, dq = q
        assert (b, hq, dq) == (1, h, d) and k[:2] == (1, kvh) and k[3] == d
        assert sq <= k[2] <= runner.ENGINE_MAX_LEN
        assert kw["causal"] and not kw["sliding_window"] and kw["kv_len"] is None
        assert kw["q_offset"] in (0, k[2] - sq)
    for q, k, dtype, args, kw in calls["flash_decode"]:
        assert dtype == torch.float32 and len(args) == 1
        assert (q, k) == ((8, h, d), (8, kvh, runner.ENGINE_MAX_LEN, d))
        assert not kw.get("sliding_window")
        assert int(args[0].max()) <= runner.ENGINE_MAX_LEN


def test_report_artifact(claim_results):
    cres, out = claim_results
    blob = json.loads((out / "claims_report.json").read_text())
    assert blob["summary"]["n_failed"] == 0
    assert blob["summary"]["n_skipped"] == 0
    assert blob["summary"]["backends"] == ["engine", "sim"]
    assert len(blob["results"]) == len(cres)
    md = (out / "claims_ledger.md").read_text()
    assert "| claim |" in md and "**FAIL**" not in md


# ---------------- regression canaries ---------------------------------------
@pytest.mark.parametrize("backend", ["sim", "engine"])
def test_regression_canary(smoke, backend):
    """PecSched with preemption disabled standing in for the real thing must
    flip the preemption claims to failing on both backends."""
    cells = ex.smoke_sweep_cells(smoke["results"])
    cell = dict(cells[(backend, "azure_default")])
    cell["pecsched"] = cell["pecsched/pe"]
    res = ex.evaluate_claims({(backend, "azure_default"): cell})
    flipped = [r.cid for r in res if not r.passed and not r.skipped]
    assert "table6_pec_preempts" in flipped
    assert "fig12_preempt_delay_ablation" in flipped


@pytest.mark.parametrize("backend", ["sim", "engine"])
def test_predictor_canary(smoke, backend):
    """The adversarial predictor swapped in for the calibrated arms must
    flip the prediction claims on both backends."""
    cells = ex.smoke_sweep_cells(smoke["results"])
    cell = dict(cells[(backend, "pred_stress")])
    adversarial = cell["sjf_pred:adversarial"]
    cell["sjf_pred:oracle"] = adversarial
    cell["sjf_pred:noisy2.0"] = adversarial
    res = ex.evaluate_claims({(backend, "pred_stress"): cell})
    flipped = [r.cid for r in res if not r.passed and not r.skipped
               and r.backend == backend]
    assert "pred_oracle_zero_evictions" in flipped
    assert "pred_noise_crossover" in flipped


# ---------------- the port against the JAX package --------------------------
def _parity_specs():
    engine = [s for s in ex.smoke_grid() if s.backend == "engine"]
    picked = [s for s in engine if s.scenario == "smoke_mini"]
    for scenario, policy in (("churn", "pecsched"),
                             ("slo_tiered", "pecsched/slo"),
                             ("shared_prefix", "pecsched/cache")):
        picked += [s for s in engine
                   if s.scenario == scenario and s.policy == policy]
    return picked


def _assert_equal(got, want, path="summary"):
    """Counts, strings and structure exactly; floats to FLOAT_RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, (int, float)), path
        assert got == want or math.isclose(got, want, rel_tol=FLOAT_RTOL), \
            f"{path}: {got} != {want}"
    else:
        assert type(got) is type(want) and got == want, \
            f"{path}: {got!r} != {want!r}"


def test_parity_specs_cover_the_named_cells():
    specs = _parity_specs()
    assert len(specs) == 11
    assert {s.scenario for s in specs} == {"smoke_mini", "churn",
                                           "slo_tiered", "shared_prefix"}


@pytest.mark.parametrize("spec", _parity_specs(), ids=lambda s: s.key())
def test_engine_summary_matches_reference(smoke, spec):
    got = {k: v for k, v in smoke["results"][spec].items()
           if k not in VOLATILE}
    want = jax_runner.run_spec(JaxSpec.from_dict(spec.to_dict()))
    want = {k: v for k, v in want.items() if k not in VOLATILE}
    _assert_equal(got, want)


# ---------------- subsystem mechanics ---------------------------------------
def test_spec_hash_stable_and_sensitive():
    a = ExperimentSpec(policy="fifo")
    assert a.spec_hash() == ExperimentSpec(policy="fifo").spec_hash()
    assert a == ExperimentSpec.from_dict(json.loads(json.dumps(a.to_dict())))
    assert a.spec_hash() == JaxSpec(policy="fifo").spec_hash()
    for change in (dict(policy="pecsched"), dict(seed=1),
                   dict(n_requests=999), dict(backend="engine"),
                   dict(overrides=(("arrival_rps", 5.0),))):
        assert dataclasses.replace(a, **change).spec_hash() != a.spec_hash()


def test_bad_spec_rejected():
    with pytest.raises(ValueError):
        ExperimentSpec(policy="fifo", backend="quantum")
    with pytest.raises(ValueError):
        ExperimentSpec(policy="fifo", engine_clock="sundial")


def test_cache_warm_rerun_executes_nothing(smoke, monkeypatch):
    """Every smoke spec is cached after the first run; a warm rerun is
    served entirely from disk."""
    cache = smoke["cache"]
    assert len(list(Path(cache).glob("*.json"))) == len(smoke["specs"])

    def boom(spec, device=None):
        raise AssertionError(f"cache miss executed {spec.key()}")

    monkeypatch.setattr(runner, "run_spec", boom)
    warm = ex.run_sweep(smoke["specs"], cache_dir=cache, device="cpu")
    assert set(warm) == set(smoke["results"])
    assert runner.by_policy(warm) == runner.by_policy(smoke["results"])


def test_engine_cache_kept_per_device(smoke):
    """An engine result run on the CPU is stored under the CPU and never
    read back for a run on the card; sim results carry no device."""
    cache = Path(smoke["cache"])
    eng = next(s for s in smoke["specs"] if s.backend == "engine")
    sim = next(s for s in smoke["specs"] if s.backend == "sim")
    assert runner._cache_path(cache, eng, "cpu").name.endswith(".cpu.json")
    assert runner._cache_load(cache, eng, "cpu") is not None
    assert runner._cache_load(cache, eng, "cuda") is None
    assert runner._cache_path(cache, sim, "cpu") == \
        runner._cache_path(cache, sim, "cuda")


def test_engine_sweep_refuses_missing_card(smoke):
    """The runner's default device is the card: without one an engine sweep
    raises rather than running on the CPU or reading the CPU's cache."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is legitimate")
    eng = [s for s in smoke["specs"] if s.backend == "engine"][:1]
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.run_sweep(eng, cache_dir=smoke["cache"])


def test_cache_invalidated_by_spec_change(tmp_path):
    spec = ExperimentSpec(policy="fifo", n_requests=120)
    r1 = ex.run_sweep([spec], cache_dir=tmp_path)
    changed = dataclasses.replace(spec, seed=spec.seed + 1)
    r2 = ex.run_sweep([changed], cache_dir=tmp_path)
    assert len(list(tmp_path.glob("*.json"))) == 2
    assert r1[spec]["_spec"]["seed"] != r2[changed]["_spec"]["seed"]


def test_cell_collision_rejected():
    a = ExperimentSpec(policy="fifo", n_requests=100)
    b = ExperimentSpec(policy="fifo", n_requests=200)
    with pytest.raises(ValueError, match="ambiguous cell"):
        runner.by_policy({a: {"policy": "fifo"}, b: {"policy": "fifo"}})
    c = dataclasses.replace(b, model="yi_34b")
    assert len(runner.by_policy({a: {"x": 1}, c: {"x": 2}})) == 2
    with pytest.raises(ValueError, match="would mix"):
        ex.smoke_sweep_cells({a: {"x": 1}, c: {"x": 2}})


def test_parallel_workers_match_serial():
    """Process-parallel sim sweeps give the same summaries as serial ones."""
    specs = grid(("fifo", "pecsched"), n_requests=300)
    serial = ex.run_sweep(specs, workers=1)
    par = ex.run_sweep(specs, workers=2)
    for s in specs:
        a, b = dict(serial[s]), dict(par[s])
        for volatile in VOLATILE:
            a.pop(volatile), b.pop(volatile)
        assert a == b
