"""The benchmark of the PyTorch port (``src/repro_torch``): one cell of
``BENCHMARK.json``, one run, one JSON line.

    python3 bench/run.py --workload mistral_7b.azure_overload --seed 7 \\
        --seconds 51 --trace 0

A cell is a configuration (``configs/<name>.json``, which names its model
module, ``models/<kind>.py``, and its plain reference), a traffic mix
(``traffic/<name>.json``) and the cell's own settings
(``workloads/<cell>.json``: its rate in requests per cluster second and the
check's limit); each metric is a reader of its own (``metrics/<name>.py``).
All of them are found by the names in ``BENCHMARK.json`` and the
configuration file, so a cell, a metric or a model kind is added by adding
files.

A run builds the port's serving stack on the card from its public
constructors (the pecsched policy over an `EngineBackend` of three
`ReplicaEngine`s: two general, one dedicated to decode), with weights drawn
from ``--seed``, warms it, and then serves the mix's open-loop arrivals
through ``Simulator.run`` for ``--seconds`` of wall time; the window's
arrivals are then served to the end.  Every time is on the backend's
measured cluster clock (host seconds around work that ends in a
synchronise with the card).  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones from a profiled slice of the
window.  Either way the served tokens of a sample of requests are then
checked against the plain float32 reference (`check`).

``--rehearse 1`` runs the same code on the CPU at a tiny float32 size, for
the tests; it is never a measurement.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import check  # noqa: E402
import devtrace  # noqa: E402
import models  # noqa: E402
import stats  # noqa: E402
import traffic  # noqa: E402

#: top-level module names that may not be loaded in a run (the JAX
#: reference package and JAX itself), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the published dense peaks of one H100 SXM (bf16 FLOP/s, HBM bytes/s)
PEAKS = {"flops": 989e12, "bytes_per_s": 3.35e12}
#: the traced slice: where it opens in the window, and how long it lasts
TRACE_AT, TRACE_S = 0.4, 6.0


class NoResult(SystemExit):
    """Exit without a result line, naming why on standard error."""

    def __init__(self, why: str):
        print(f"bench: {why}", file=sys.stderr)
        super().__init__(2)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_files(name: str) -> SimpleNamespace:
    """The cell's entry in BENCHMARK.json and its data files."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise NoResult(f"no workload {name!r} in BENCHMARK.json")
    return SimpleNamespace(
        bench=bench, cell=cell,
        config=load_json(BENCH / "configs" / f"{cell['config']}.json"),
        mix=load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        own=load_json(BENCH / "workloads" / f"{name}.json"))


def fit_prefill_target(em, longest: int, engines: int) -> float:
    """The port's ``launch.serve_cluster.fit_prefill_target`` rule: the
    target at which the mix's longest long claims every general engine and
    no long claims more."""
    return em.prefill_time(longest, 1, sp_mode="local") / (engines - 0.5)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def forbidden_modules(names=None) -> List[str]:
    """The FORBIDDEN top-level names among `names` (by default the
    modules this process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics the cell reports: its end-to-end ones with --trace 0, its
    per-layer ones with --trace 1 (a metric without `workloads` goes to
    every cell that reports the end-to-end metric it moves)."""
    def mine(m):
        return cell in m["workloads"] if "workloads" in m else True
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def log(**kw) -> None:
    print("bench: " + json.dumps(kw, default=str), file=sys.stderr)


def serve(name: str, seed: int, seconds: float, trace: bool, *,
          rehearse: bool = False, control: bool = False,
          rate: Optional[float] = None, run_check: bool = True) -> Dict:
    """One run of cell `name`: set-up, window, drain, metrics and check.
    `control` puts the check's control in the program's place: the tokens
    judged are the ones the reference in fp8 puts first (`check.gaps`), so
    the run comes out not correct; the served tokens' own gap is logged as
    ``program_gap``.  `rate` replaces the cell's rate and `run_check` False
    skips the check (both for the knee sweep).  The result's ``info`` holds
    what the run logged."""
    from repro_torch.core import (ClusterConfig, ExecutionModel, Simulator,
                                  make_policy)
    from repro_torch.core.request import Phase, Request
    from repro_torch.hardware import H100_SXM
    from repro_torch.serving.backend import EngineBackend

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    f = cell_files(name)
    rate = rate or f.own["rate"]
    sv = f.config["serving"]
    chips = f.cell["chips"]
    if rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoResult(f"cell {name} needs {chips} CUDA device(s); "
                           f"found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.empty(1, device=device)       # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)
    model = models.load(f.config["model"])
    c = model.sizes(f.config, rehearse)
    cfg = model.port_config(f.config, c)
    parts = {"imports_s": time.perf_counter() - T_START}

    t = time.perf_counter()
    w = model.draw(c, seed, device, getattr(torch, c["dtype"]))
    params = model.port_layout(w)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    sync()
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    engines = sv["general_engines"]
    cc = ClusterConfig(n_nodes=1, gpus_per_node=engines + sv["decode_engines"],
                       tp=1, hw=H100_SXM,
                       n_short_decode_replicas=sv["decode_engines"],
                       max_decode_concurrency=sv["max_decode_concurrency"])
    ins, _, longs, _ = traffic.azure_trace(traffic.trace_params(f.mix))
    em = ExecutionModel(cfg, cc.replica_spec())
    em = ExecutionModel(cfg, cc.replica_spec(), target_prefill_s=(
        fit_prefill_target(em, int(ins[longs].max()), engines)))
    backend = EngineBackend(cfg, params, max_len=c["max_len"],
                            max_slots=sv["max_slots"],
                            layers_per_quantum=sv["layers_per_quantum"],
                            clock="measured", max_new_cap=sv["max_new"],
                            seed=seed, device=device, sp_devices=[device])
    prompts = traffic.Prompts(seed, c["vocab_size"], backend.max_prompt)
    backend.token_provider = prompts
    ladder = sorted({n for n in (16, 64, 256, 1024, backend.max_prompt)
                     if n <= backend.max_prompt})
    backend.warmup(ladder, range(cc.n_replicas))
    backend.reset()
    spans = devtrace.Spans() if trace else None
    if spans is not None:
        for eng in backend._engines.values():
            spans.wrap(eng)
        devtrace.warm_profiler(device)
    policy = make_policy("pecsched", cc, em)
    sim = Simulator(policy, backend=backend)
    sync()
    parts["build_warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START

    window: List = []
    backlog: List = []
    win = SimpleNamespace(end=None, wall=None, exhausted=True)
    sl = devtrace.Slice(spans, TRACE_AT * seconds,
                        min(TRACE_S, 0.3 * seconds)) if trace else None

    def arrivals():
        t0 = time.perf_counter()
        for i, (n_in, n_out, is_long, at) in enumerate(
                traffic.run_requests(f.mix, rate, seed)):
            el = time.perf_counter() - t0
            if el >= seconds:
                win.exhausted = False
                break
            if sl is not None:
                sl.poll(el)
            backlog.append((sim.now, len(policy.short_queue)
                            + len(policy.decode_queue)))
            r = Request(rid=i, arrival=at, input_len=n_in, output_len=n_out,
                        is_long=is_long)
            window.append(r)
            yield r
        if sl is not None:
            sl.close()
        win.end, win.wall = sim.now, time.perf_counter() - t0

    t = time.perf_counter()
    summary = sim.run(arrivals())
    sync()
    wall_total = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    generated = {r.rid: list(backend.generated.get(r.rid, []))
                 for r in window}
    target = stats.target_tokens(sv["max_new"])
    fails = stats.failures(window, generated, target, c["vocab_size"])
    trace_red = None
    if sl is not None:
        trace_red = devtrace.reduce(
            sl.events(), sl.t1 - sl.t0 if sl.t0 is not None else 0.0)
    half = len(backlog) // 2
    run = SimpleNamespace(
        requests=window, window_end=win.end, summary=summary,
        stats=dict(backend.stats), decode_s=backend.decode_s,
        sp_per_layer=backend.sp_per_layer_s(), setup_s=setup_s,
        trace=trace_red, spans=spans, sizes=c, model=model, peaks=PEAKS,
        elt_bytes=torch.empty((), dtype=getattr(torch, c["dtype"])).element_size())
    info = dict(
        cell=name, seed=seed, device=str(device),
        power=power_limit() if device.type == "cuda" else "cpu",
        rate=rate, setup_parts=parts, setup_s=setup_s,
        arrivals=len(window), shorts=len(stats.shorts(window)),
        longs=sum(r.is_long for r in window), window_cluster_s=win.end,
        window_wall_s=win.wall, run_wall_s=wall_total,
        drain_wall_s=wall_total - (win.wall or 0.0),
        population_exhausted=win.exhausted,
        backlog_mean_halves=[
            sum(b for _, b in backlog[:half]) / max(half, 1),
            sum(b for _, b in backlog[half:]) / max(len(backlog) - half, 1)],
        preemptions=summary.get("preemptions"),
        decode_iters=backend.stats.get("decode_iters"),
        decode_tokens=backend.stats.get("decode_tokens"),
        failures=fails, memory_peak_bytes=peak,
        shorts_done_in_window=stats.shorts_done_by(window, win.end or 0.0),
        latency_s={k: stats.summary(v) for k, v in (
            ("short_qd_s", stats.short_qd_s(window)),
            ("short_ttft_s", stats.short_ttft_s(window)),
            ("long_jct_s", stats.long_jct_s(window)))})
    log(**info)

    metrics = {}
    for m in cell_metrics(f.bench, name, trace):
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if not run_check:
        return {"metrics": metrics, "info": info}
    # the check, once the program's state is gone
    done = [r for r in window if r.phase == Phase.DONE
            and len(generated[r.rid]) == target(r)]
    n_served = {r.rid: len(generated[r.rid]) for r in done}
    picked = check.sample(done, n_served, f.own["check"]["tokens"],
                          lambda r: len(prompts(r)), seed)
    cover = {"requests": len(picked),
             "preempted_longs": sum(1 for r in picked
                                    if r.is_long and r.n_preemptions),
             "migrated_shorts": sum(1 for r in picked if not r.is_long),
             "longest_prompt": max((len(prompts(r)) for r in picked),
                                   default=0)}
    del backend, policy, sim, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    Reference = check.load_reference(f.config)
    ref = Reference(c, model.reference_layout(w))
    low = Reference(c, model.reference_layout(w), "fp8") if control else None
    g = check.gaps(ref, [prompts(r) for r in picked],
                   [generated[r.rid] for r in picked], device, low) \
        if picked else {"served_gap": None, "tokens": 0}
    sync()
    info.update(check_s=time.perf_counter() - t, check_cover=cover, **g)
    log(check_s=info["check_s"], check_cover=cover, **g)
    limit = f.own["check"]["served_gap_limit"]
    failed = sum(fails.values())
    compared = {"served_logit_gap": {"value": g["served_gap"],
                                     "limit": limit},
                "failed_requests": {"value": failed, "limit": 0}}
    correct = (g["served_gap"] is not None and g["served_gap"] <= limit
               and failed == 0)
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(window),
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = trace_red["busy_s"] if trace_red else 0.0
        dev["window_s"] = trace_red["window_s"] if trace_red else 0.0
        if trace_red:
            out["breakdown"] = {"device_ops": trace_red["device_ops"],
                                "idle_gaps": trace_red["idle_gaps"]}
    out["compared"] = compared
    out["info"] = info
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", type=int, choices=(0, 1), default=0,
                    help="the tests' CPU run at a tiny float32 size")
    a = ap.parse_args(argv)
    out = serve(a.workload, a.seed, a.seconds, bool(a.trace),
                rehearse=bool(a.rehearse))
    del out["info"]
    found = forbidden_modules()         # the window has closed by now
    if found:
        raise NoResult("modules loaded that the port may not use: "
                       + ", ".join(found))
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
