"""The port's spans and counters (core/spans.py): totals with nesting, self
and wait time; profiler ranges only while a profiler is active and only
under the ``engine.`` names the benchmark's device trace reader expects;
the decode split and the policy's own time on a reduced EngineBackend run;
and the benchmark's readers of them (`bench/run.py --rehearse 1`)."""
import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

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

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
SPANS = ROOT / "src" / "repro_torch" / "core" / "spans.py"
#: the engine methods the benchmark's traced run wraps (bench/devtrace.py)
ENGINE_METHODS = {"engine.start_prefill", "engine.prefill_quantum",
                  "engine.prefill_logits", "engine.admit", "engine.evict",
                  "engine.decode_iteration"}
#: the per-layer metrics that read the spans
SPAN_METRICS = ("engine.decode_issue_ms_per_iter",
                "engine.decode_wait_ms_per_iter",
                "engine.decode_view_ms_per_iter",
                "engine.prefill_issue_ms_per_layer",
                "engine.admit_ms_per_migration", "sched.decide_us_per_request")


def _busy(s):
    t = time.perf_counter() + s
    while time.perf_counter() < t:
        pass


def test_tracer_nesting_self_and_wait():
    tr = Tracer()
    with tr.span("outer"):
        _busy(0.004)
        with tr.span("outer.inner"):
            _busy(0.003)
            with tr.span("outer.inner.sync", wait=True):
                _busy(0.002)
        with tr.span("outer.inner"):
            pass
    tr.count("things", 3)
    tr.count("things")
    s = tr.stats
    assert s["outer:n"] == 1 and s["outer.inner:n"] == 2
    assert s["things"] == 4
    # a span's self time is its duration less its children's
    assert s["outer:self_ns"] == s["outer:ns"] - s["outer.inner:ns"]
    assert s["outer.inner:self_ns"] == (s["outer.inner:ns"]
                                        - s["outer.inner.sync:ns"])
    assert s["outer:self_ns"] >= 4e6 and s["outer.inner:self_ns"] >= 3e6
    # waits count in their own span and in every span around them
    assert s["outer.inner.sync:wait_ns"] == s["outer.inner.sync:ns"] >= 2e6
    assert s["outer:wait_ns"] == s["outer.inner:wait_ns"] \
        == s["outer.inner.sync:ns"]
    assert tr.seconds("outer", "self_ns") == pytest.approx(
        s["outer:self_ns"] * 1e-9)
    assert len(tr._open) == 1               # the root frame alone
    tr.reset()
    assert not tr.stats


def test_span_closes_on_exception():
    tr = Tracer()
    with pytest.raises(KeyError):
        with tr.span("a"):
            with tr.span("a.b"):
                raise KeyError
    assert len(tr._open) == 1 and tr.stats["a:n"] == tr.stats["a.b:n"] == 1


def test_added_span_leaves_its_spans_out():
    """A block the caller times itself (`add`, as the simulator's loop
    does) gets the spans closed inside it as its children: its self time
    leaves them out, and the span around it counts them once."""
    tr = Tracer()
    with tr.span("outer"):
        t0, inner0 = time.perf_counter_ns(), tr.inner_ns()
        _busy(0.002)
        with tr.span("work", wait=True):
            _busy(0.003)
        ns = time.perf_counter_ns() - t0
        tr.add("decide", ns, ns - (tr.inner_ns() - inner0))
    s = tr.stats
    assert s["decide:n"] == 1 and s["decide:ns"] == ns
    assert s["decide:self_ns"] == ns - s["work:ns"] >= 2e6
    assert s["outer:self_ns"] == s["outer:ns"] - ns
    assert s["outer:wait_ns"] == s["work:ns"]


@pytest.fixture(scope="module")
def stack():
    cfg = dataclasses.replace(
        reduced_config(get_config("mistral_7b"), layers=2), dtype="float32")
    cc = ClusterConfig(n_nodes=1, gpus_per_node=3, tp=1,
                       n_short_decode_replicas=1, max_decode_concurrency=8)
    em = ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=0.5)
    be = EngineBackend(cfg, init_params(cfg, seed=0, device="cpu"),
                       max_len=128, layers_per_quantum=1, clock="measured",
                       device="cpu")
    return cc, em, be


def _trace():
    """Shorts around one long, arriving together, so the long is preempted
    and the decode engine batches several migrated shorts."""
    rng = np.random.default_rng(1)
    return [Request(rid=i, arrival=0.001 * i,
                    input_len=300_000 if i == 1 else int(rng.integers(300, 3000)),
                    output_len=int(rng.integers(3, 8)), is_long=i == 1)
            for i in range(10)]


def _serve(stack):
    cc, em, be = stack
    be.reset()
    sim = Simulator(make_policy("pecsched", cc, em), backend=be)
    summary = sim.run(copy.deepcopy(_trace()))
    assert summary["short_completed"] == 9 and summary["long_completed"] == 1
    return sim, be


def test_decode_split_and_policy_time(stack):
    sim, be = _serve(stack)
    s = be.stats
    assert s["decode_iters"] > 0 and s["kv_migrations"] > 0
    assert s["prefill_layers"] >= 2 * 10
    # issue + wait is the backend's decode span, which is decode_s
    issue = s["backend.decode_iteration:ns"] - s["backend.decode_iteration:wait_ns"]
    wait = s["backend.decode_iteration:wait_ns"]
    assert (issue + wait) * 1e-9 == pytest.approx(be.decode_s, rel=0.05)
    assert 0 < wait < issue + wait
    # every span the engines and the backend opened is inside a
    # sched.decide span, and the policy's time leaves them out
    assert sim.sched_time == pytest.approx(
        be.tracer.seconds("sched.decide", "self_ns"))
    assert 0 < sim.sched_time <= sim.run_time - be.measured_s + 0.05
    inner = be.tracer.seconds("sched.decide") - sim.sched_time
    assert inner >= be.measured_s
    be.reset()
    assert not be.stats and be.stats is be.tracer.stats


def test_no_range_without_a_profiler(stack, monkeypatch):
    """With no profiler active no range is entered and no span's attributes
    are built; under one, the engine's ranges open with theirs."""
    entered, built = [], []
    real_span = Tracer.span
    real_fast = torch._C._profiler._RecordFunctionFast
    real_rf = torch.profiler.record_function

    def span(self, name, **kw):
        args = kw.get("args")
        if args is not None:
            kw["args"] = lambda: (built.append(name), args())[1]
        return real_span(self, name, **kw)

    def fast(name, *a):
        entered.append(name)
        return real_fast(name, *a)

    def rf(name, *a):
        entered.append(name)
        return real_rf(name, *a)

    monkeypatch.setattr(Tracer, "span", span)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast)
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    _serve(stack)
    assert entered == [] and built == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _serve(stack)
    assert ENGINE_METHODS <= set(entered) and ENGINE_METHODS <= set(built)


def test_tracer_imports_no_torch():
    """core/spans.py loads with torch blocked: the simulator's layer keeps
    its totals without the profiler, which the serving layer hooks in."""
    code = ("import sys, importlib.util\n"
            "sys.modules['torch'] = None\n"
            "spec = importlib.util.spec_from_file_location('s', sys.argv[1])\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "tr = mod.Tracer()\n"
            "with tr.span('a', record=True, args=lambda: 1 / 0):\n"
            "    pass\n"
            "print(tr.stats['a:n'])\n")
    out = subprocess.run([sys.executable, "-c", code, str(SPANS)],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"


def test_range_args_carry_request_ids(stack, tmp_path):
    """Under a profiler that records inputs, the ranges' trace args hold
    each prefill quantum's request id, S, P and layers and each decode
    lane's request id and cache length."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        _serve(stack)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    args = {}
    for ev in events:
        args.setdefault(ev.get("name"), ev.get("args", {}))
    assert {"rid", "S", "P", "layers"} <= set(args["engine.prefill_quantum"])
    assert "lanes" in args["engine.decode_iteration"]
    assert args["engine.decode_iteration"]["lanes"].startswith("[(")


def test_profiler_ranges_are_engine_ranges(stack):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, be = _serve(stack)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    spans = {k.rsplit(":", 1)[0] for k in be.stats if ":" in k}
    seen = names & spans
    # the six wrapped methods and their parts are on the timeline; the
    # backend's, the pool's and the scheduler's spans are not
    assert ENGINE_METHODS | {"engine.decode_iteration.view",
                             "engine.decode_iteration.step",
                             "engine.decode_iteration.readback",
                             "engine.prefill_quantum.layers",
                             "engine.admit.pool"} <= seen
    assert all(n.startswith("engine.") for n in seen), sorted(seen)
    assert {"backend.decode_iteration", "sched.decide", "pool.index"} <= spans


def _devtrace():
    spec = importlib.util.spec_from_file_location("devtrace_under_test",
                                                  BENCH / "devtrace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_read(raw):
    """(name, start, end, on the device) as `devtrace.Slice.events` gives
    them: a device event named ``engine.`` (a range's twin) is no work."""
    return [(n, a, b, d and not n.startswith("engine."))
            for n, a, b, d in raw]


def test_nested_ranges_leave_the_device_trace_reduction_unchanged():
    """The program's ``engine.<method>.<part>`` ranges, nested in the
    benchmark's ``engine.<method>`` ranges, and their device-side twins
    change neither the device's busy time, nor its time by operation, nor
    the names idle gaps are put down to."""
    dt = _devtrace()
    wrapped = [
        # a decode iteration: host range, its twin, kernels, the readback
        ("engine.decode_iteration", 0.0, 10.0, False),
        ("engine.decode_iteration", 1.0, 9.5, True),
        ("gemv", 1.0, 2.0, True), ("copy", 4.0, 4.5, True),
        ("gemv", 6.0, 9.5, True),
        # a prefill quantum that returns before its kernels end (the
        # backend's synchronise follows outside it)
        ("engine.prefill_quantum", 11.0, 12.0, False),
        ("engine.prefill_quantum", 11.5, 15.0, True),
        ("gemm", 11.5, 13.0, True), ("attn", 13.5, 15.0, True),
        ("engine.admit", 16.0, 17.0, False),
        ("engine.admit", 16.2, 17.5, True),
        ("stack", 16.2, 16.4, True), ("index_copy", 17.2, 17.5, True),
        ("gemv", 18.0, 19.0, True),
    ]
    nested = wrapped + [
        ("engine.decode_iteration", 0.1, 9.9, False),
        ("engine.decode_iteration.view", 0.2, 3.0, False),
        ("engine.decode_iteration.view", 1.0, 2.0, True),
        ("engine.decode_iteration.upload_lens", 3.1, 4.6, False),
        ("engine.decode_iteration.upload_lens", 4.0, 4.5, True),
        ("engine.decode_iteration.step", 4.7, 6.5, False),
        ("engine.decode_iteration.step", 6.0, 9.5, True),
        ("engine.decode_iteration.readback", 6.6, 9.8, False),
        ("engine.prefill_quantum", 11.05, 11.95, False),
        # the layer slice's twin starts and ends with the quantum's
        ("engine.prefill_quantum.layers", 11.1, 11.9, False),
        ("engine.prefill_quantum.layers", 11.5, 15.0, True),
        ("engine.admit.pool", 16.5, 16.9, False),
        ("engine.admit.pool", 17.2, 17.5, True),
    ]
    base = dt.reduce(_as_read(wrapped), 20.0)
    got = dt.reduce(_as_read(nested), 20.0)
    assert got["busy_s"] == pytest.approx(base["busy_s"])
    assert got["by_op"] == pytest.approx(base["by_op"])
    assert dict(got["idle_gaps"]) == pytest.approx(dict(base["idle_gaps"]))
    assert {n for n, _ in base["idle_gaps"]} == {
        "engine.decode_iteration", "engine.prefill_quantum", "engine.admit",
        dt.HOST_OTHER}


def test_bench_rehearsal_reads_the_span_metrics():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cell in ("mistral_7b.azure_overload", "phi3_14b.azure_overload"):
        p = subprocess.run(
            [sys.executable, str(BENCH / "run.py"), "--workload", cell,
             "--seed", str(2 ** 31 + 77), "--seconds", "2", "--trace", "1",
             "--rehearse", "1"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert p.returncode == 0, p.stderr[-2000:]
        metrics = json.loads(p.stdout.strip().splitlines()[-1])["metrics"]
        for name in SPAN_METRICS:
            assert metrics[name]["value"] is not None, (cell, name)
            assert metrics[name]["value"] >= 0, (cell, name)
        split = (metrics["engine.decode_issue_ms_per_iter"]["value"]
                 + metrics["engine.decode_wait_ms_per_iter"]["value"])
        assert split == pytest.approx(
            metrics["engine.decode_ms_per_iter"]["value"], rel=0.05)
