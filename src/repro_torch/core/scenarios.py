"""Named workload scenarios: one registry every harness consumes.

The paper evaluates on a single Azure-style stream (§3.1/§6.2). This module
widens that into a scenario matrix — each entry is a named builder returning
a list of `Request`s, so benchmarks, examples and tests can sweep any policy
across every regime with `get_scenario(name)`:

    azure_default   the paper's length mix, Poisson arrivals, in the
                    calibrated ~1.1x-capacity regime (EXPERIMENTS.md
                    §Simulator-calibration)
    bursty          same mix, 2-state MMPP arrivals (quiet/burst cycles)
    heavy_tail      gamma-renewal arrivals (CV 3) + a heavier input-length
                    tail — the Tail-Aware-Scheduling stress regime
    pred_stress     input-dominated heavy tail + narrow outputs — the
                    output-length-prediction robustness regime
                    (experiments/robustness.py)
    diurnal         sinusoidal day/night arrival rate (compressed period)
    multi_tenant    superposed per-tenant streams (chat / summarize /
                    codegen) with distinct rate and length mixes
    slo_tiered      the multi_tenant mix under MMPP bursts with per-tier
                    TTFT/TPOT SLO contracts (interactive/standard/batch)
    chat_multiturn  session-correlated follow-ups: each turn's input carries
                    the accumulated conversation context
    shared_prefix   many users, few shared system prompts, bursty arrivals —
                    the millions-of-users prefix-cache regime
    churn           the azure_default mix, tagged for the elastic-fleet
                    layer: the experiment runner injects a 20% spot
                    reclamation wave (core/fleet.py) when replaying it
    churn_scale     the churn regime with autoscale backfill enabled —
                    the recovery-claims cell (overloaded, joins allowed)
    csv             replay a real Azure-trace-format file (pass path=...)

Every builder takes (n_requests, seed, **overrides) and is deterministic
under a fixed seed. Overrides flow into the underlying TraceConfig (or the
builder's own knobs) so a scenario is a *default*, not a straitjacket.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np

from repro_torch.core.request import Request
from repro_torch.core.trace import TraceConfig, generate_trace, load_trace_csv


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    description: str
    builder: Callable


SCENARIOS: Dict[str, ScenarioSpec] = {}


def register_scenario(name: str, description: str) -> Callable:
    def deco(fn: Callable) -> Callable:
        SCENARIOS[name] = ScenarioSpec(name, description, fn)
        return fn
    return deco


def get_scenario(name: str, *, n_requests: int = 20000, seed: int = 0,
                 **overrides) -> List[Request]:
    """Build the named scenario's request list (sorted by arrival, rids
    renumbered in arrival order)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    reqs = SCENARIOS[name].builder(n_requests, seed, **overrides)
    reqs.sort(key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs


def list_scenarios() -> Dict[str, str]:
    return {n: s.description for n, s in sorted(SCENARIOS.items())}


# ---------------------------------------------------------------------------
# Azure-mix scenarios: the paper's length distribution under four arrival
# regimes. Length defaults follow workload.experiment_trace's calibrated
# ~1.1x-capacity setup (EXPERIMENTS.md §Simulator-calibration) rather than
# the raw paper parameters, so replays flow instead of backlogging.
# ---------------------------------------------------------------------------
_CALIBRATED = dict(long_quantile=0.996, long_low=100_000, long_high=400_000)


def _azure_mix(n_requests: int, seed: int, overrides: dict,
               **defaults) -> List[Request]:
    kw = {**_CALIBRATED, **defaults, **overrides}
    return generate_trace(TraceConfig(n_requests=n_requests, seed=seed, **kw))


@register_scenario("azure_default",
                   "paper §3.1 Azure length mix, Poisson arrivals")
def azure_default(n_requests: int, seed: int, **overrides) -> List[Request]:
    return _azure_mix(n_requests, seed, overrides)


@register_scenario("bursty",
                   "Azure mix under 2-state MMPP (quiet/burst) arrivals")
def bursty(n_requests: int, seed: int, **overrides) -> List[Request]:
    return _azure_mix(n_requests, seed, overrides, arrival_process="mmpp",
                      arrival_params=(("burst_factor", 8.0),
                                      ("burst_frac", 0.15),
                                      ("mean_cycle", 60.0)))


@register_scenario("heavy_tail",
                   "gamma-renewal arrivals (CV 3) + heavier length tail")
def heavy_tail(n_requests: int, seed: int, **overrides) -> List[Request]:
    return _azure_mix(n_requests, seed, overrides, arrival_process="gamma",
                      arrival_params=(("cv", 3.0),), input_sigma=2.0)


@register_scenario("pred_stress",
                   "prediction-robustness regime: input-dominated cost, "
                   "narrow outputs, bursty arrivals")
def pred_stress(n_requests: int, seed: int, **overrides) -> List[Request]:
    """The regime where output-length prediction is *decision-relevant*:
    per-request cost is dominated by a heavy-tailed **observable** input
    (lognormal σ=2.2, shorts up to 60 K tokens) while outputs are narrow
    (σ=0.35) — so at σ_err=0 an SJF ordering is near-perfect from the
    prompt alone, and multiplicative prediction noise on the decode term
    is what scrambles it.  Gamma CV-3 arrivals provide the transient
    overloads whose queue-drain *order* sets the p99 short queueing
    delay (experiments/robustness.py sweeps σ_err over this trace)."""
    return _azure_mix(n_requests, seed, overrides, arrival_process="gamma",
                      arrival_params=(("cv", 3.0),), input_sigma=2.2,
                      input_max=60_000, output_sigma=0.35,
                      long_quantile=0.997, long_high=250_000)


@register_scenario("churn",
                   "Azure mix replayed under elastic-fleet churn (the "
                   "runner injects a 20% spot-reclamation wave)")
def churn(n_requests: int, seed: int, **overrides) -> List[Request]:
    """The trace itself is the azure_default mix — churn is a property of
    the FLEET, not the arrivals.  The scenario name is what keys the
    experiment runner's default `FleetController` (a 20%-of-fleet
    reclamation wave at the first arrival quartile, notice window 1% of
    the trace span); `fleet_*` spec overrides retune it."""
    return _azure_mix(n_requests, seed, overrides)


@register_scenario("churn_scale",
                   "Churn regime with the pressure-driven autoscaler "
                   "allowed to backfill the reclaimed capacity")
def churn_scale(n_requests: int, seed: int, **overrides) -> List[Request]:
    """Same azure mix as `churn`; the claims grid runs this cell
    overloaded (utilization past the post-wave capacity knee) with
    ``fleet_autoscale`` on, so the recovery claims can pin that scale-up
    joins fire under backlog pressure and bound the surviving p99.  The
    wave itself still comes from the runner's fleet defaults."""
    return _azure_mix(n_requests, seed, overrides)


@register_scenario("diurnal",
                   "Azure mix under a compressed day/night arrival cycle")
def diurnal(n_requests: int, seed: int, **overrides) -> List[Request]:
    return _azure_mix(n_requests, seed, overrides, arrival_process="diurnal",
                      arrival_params=(("period", 600.0), ("depth", 0.8)))


# ---------------------------------------------------------------------------
# Multi-tenant: superposed independent per-tenant Poisson streams, each with
# its own rate share and length mix (superposition of Poissons keeps the
# total stream Poisson at the full rate).
# ---------------------------------------------------------------------------
DEFAULT_TENANTS: Dict[str, dict] = {
    # interactive chat: the bulk of traffic, short in/out, no longs
    "chat": dict(share=0.60, input_mu=math.log(400.0), input_sigma=1.2,
                 output_mu=math.log(150.0), output_sigma=0.9,
                 long_quantile=2.0),
    # document summarization: big inputs, a real long tail (§6.2-style)
    "summarize": dict(share=0.25, input_mu=math.log(3000.0), input_sigma=1.0,
                      input_max=50_000, output_mu=math.log(250.0),
                      output_sigma=0.6, long_quantile=0.98,
                      long_low=100_000, long_high=400_000),
    # code generation: medium inputs, long outputs
    "codegen": dict(share=0.15, input_mu=math.log(1500.0), input_sigma=0.9,
                    output_mu=math.log(400.0), output_sigma=0.7,
                    long_quantile=2.0),
}


@register_scenario("multi_tenant",
                   "superposed chat/summarize/codegen tenant streams")
def multi_tenant(n_requests: int, seed: int, *, arrival_rps: float = 10.0,
                 tenants: Dict[str, dict] = DEFAULT_TENANTS,
                 **overrides) -> List[Request]:
    shares = {t: spec["share"] for t, spec in tenants.items()}
    total = sum(shares.values())
    out: List[Request] = []
    for i, (tenant, spec) in enumerate(sorted(tenants.items())):
        share = shares[tenant] / total
        n_t = max(int(round(n_requests * share)), 1)
        kw = {k: v for k, v in spec.items() if k != "share"}
        kw.update(overrides)
        tc = TraceConfig(n_requests=n_t, seed=seed * 1000 + i,
                         arrival_rps=arrival_rps * share, **kw)
        for r in generate_trace(tc):
            r.tenant = tenant
            out.append(r)
    # per-tenant rounding can overshoot by a request or two; trim the trace
    # END (latest arrivals), not whichever tenant happens to sit last
    out.sort(key=lambda r: r.arrival)
    return out[:n_requests]


# ---------------------------------------------------------------------------
# SLO-tiered: the multi_tenant mix under bursty (MMPP) arrivals, with every
# request carrying a per-tier TTFT/TPOT contract.  Tiers are assigned via a
# tenant -> tier map (chat is interactive, codegen standard, summarize
# batch); targets are multiples of a single `slo_scale` knob so one override
# retunes the whole contract set for compressed (engine) timelines the same
# way `mean_cycle` retunes the burst clock.
# ---------------------------------------------------------------------------
DEFAULT_TIER_MAP: Dict[str, str] = {
    "chat": "interactive",
    "codegen": "standard",
    "summarize": "batch",
}

#: per-tier (ttft_mult, tpot_mult) applied to `slo_scale`; None = no bound
#: on that term.  batch has no TTFT contract — its longs legitimately spend
#: minutes in prefill — so its promise is completion at a sane decode
#: cadence (and not being shed).
DEFAULT_SLO_TIERS: Dict[str, tuple] = {
    "interactive": (1.0, 0.05),
    "standard": (4.0, 0.20),
    "batch": (None, 2.0),
}


def assign_slo_tiers(reqs: List[Request], *, slo_scale: float = 1.0,
                     tier_map: Dict[str, str] = DEFAULT_TIER_MAP,
                     tiers: Dict[str, tuple] = DEFAULT_SLO_TIERS,
                     default_tier: str = "standard") -> List[Request]:
    """Stamp `slo`/`ttft_target`/`tpot_target` onto `reqs` in place (and
    return them) from the tenant -> tier map.  Exposed so tests and other
    scenarios can tier arbitrary traces."""
    for r in reqs:
        tier = tier_map.get(r.tenant or "", default_tier)
        ttft_mult, tpot_mult = tiers[tier]
        r.slo = tier
        r.ttft_target = None if ttft_mult is None else ttft_mult * slo_scale
        r.tpot_target = None if tpot_mult is None else tpot_mult * slo_scale
    return reqs


@register_scenario("slo_tiered",
                   "multi-tenant mix with per-tier TTFT/TPOT SLOs under "
                   "bursty (MMPP) arrivals")
def slo_tiered(n_requests: int, seed: int, *, arrival_rps: float = 10.0,
               tenants: Dict[str, dict] = DEFAULT_TENANTS,
               tier_map: Dict[str, str] = DEFAULT_TIER_MAP,
               slo_scale: float = 1.0,
               burst_factor: float = 8.0, burst_frac: float = 0.15,
               mean_cycle: float = 60.0, **overrides) -> List[Request]:
    reqs = multi_tenant(n_requests, seed, arrival_rps=arrival_rps,
                        tenants=tenants, arrival_process="mmpp",
                        arrival_params=(("burst_factor", burst_factor),
                                        ("burst_frac", burst_frac),
                                        ("mean_cycle", mean_cycle)),
                        **overrides)
    return assign_slo_tiers(reqs, slo_scale=slo_scale, tier_map=tier_map)


# ---------------------------------------------------------------------------
# Chat multi-turn: sessions arrive Poisson; within a session each follow-up
# turn arrives a think-time gap after the previous one and its input carries
# the full accumulated context (previous inputs + previous outputs), so
# later turns are progressively heavier — the prefix-growth pattern real
# chat serving sees.
# ---------------------------------------------------------------------------
@register_scenario("chat_multiturn",
                   "session-correlated follow-ups with growing context")
def chat_multiturn(n_requests: int, seed: int, *, arrival_rps: float = 10.0,
                   mean_turns: float = 4.0, think_mean: float = 30.0,
                   prompt_mu: float = math.log(150.0),
                   prompt_sigma: float = 0.8,
                   output_mu: float = math.log(180.0),
                   output_sigma: float = 0.7, output_max: int = 800,
                   input_max: int = 64_000,
                   long_threshold: int = 2048) -> List[Request]:
    rng = np.random.default_rng(seed)
    session_rate = arrival_rps / mean_turns
    out: List[Request] = []
    t_session, sid = 0.0, 0
    while len(out) < n_requests:
        t_session += rng.exponential(1.0 / session_rate)
        # turns ~ geometric with mean `mean_turns` (support starts at 1)
        n_turns = int(rng.geometric(1.0 / mean_turns))
        t, context = t_session, 0
        for _turn in range(n_turns):
            if len(out) >= n_requests:
                break
            prompt = int(np.clip(rng.lognormal(prompt_mu, prompt_sigma),
                                 8, input_max))
            output = int(np.clip(rng.lognormal(output_mu, output_sigma),
                                 1, output_max))
            inp = min(context + prompt, input_max)
            # growing context crosses the paper's 2K short/long boundary
            # routinely (~27% of a 2000-request seed-0 trace); classify by
            # the same threshold trace generation uses (core/trace.py)
            truncated = context + prompt > input_max
            out.append(Request(rid=len(out), arrival=t, input_len=inp,
                               output_len=output,
                               is_long=inp >= long_threshold,
                               tenant="chat", session=sid,
                               prefix_group=sid,
                               # the leading `context` tokens are exactly the
                               # previous turn's input+output — reusable from
                               # cache unless truncation broke the identity
                               prefix_len=0 if truncated else context,
                               prefix_write=inp + output))
            context = inp + output
            t += rng.exponential(think_mean)
        sid += 1
    return out


# ---------------------------------------------------------------------------
# Shared-prefix: many independent users, few long system prompts. Every
# request's input starts with one of `n_prompts` fixed system prompts (Zipf
# popularity), followed by a short user-specific message — the
# millions-of-users shape where a prefix cache pays off on the *system
# prompt* rather than per-session context. Arrivals are 2-state MMPP so the
# scenario doubles as the affinity-vs-balance burst stress.
# ---------------------------------------------------------------------------
@register_scenario("shared_prefix",
                   "many users, few shared system prompts, bursty arrivals")
def shared_prefix(n_requests: int, seed: int, *, arrival_rps: float = 10.0,
                  n_prompts: int = 8,
                  sys_mu: float = math.log(1500.0), sys_sigma: float = 0.7,
                  sys_min: int = 256, sys_max: int = 8192,
                  user_mu: float = math.log(120.0), user_sigma: float = 0.8,
                  user_max: int = 2000,
                  output_mu: float = math.log(180.0),
                  output_sigma: float = 0.7, output_max: int = 800,
                  burst_factor: float = 8.0, burst_frac: float = 0.15,
                  mean_cycle: float = 60.0,
                  long_threshold: int = 2048) -> List[Request]:
    rng = np.random.default_rng(seed)
    # fixed system-prompt lengths, drawn once per trace
    sys_lens = np.clip(rng.lognormal(sys_mu, sys_sigma, size=n_prompts),
                       sys_min, sys_max).astype(int)
    # Zipf popularity: a couple of prompts dominate, the rest are a tail
    weights = 1.0 / np.arange(1, n_prompts + 1)
    weights /= weights.sum()
    # 2-state MMPP: rates chosen so the long-run mean equals arrival_rps
    base = arrival_rps / (1.0 - burst_frac + burst_frac * burst_factor)
    rates = (base, base * burst_factor)
    durations = (mean_cycle * (1.0 - burst_frac), mean_cycle * burst_frac)
    out: List[Request] = []
    t, state = 0.0, 0
    state_end = rng.exponential(durations[0])
    while len(out) < n_requests:
        t += rng.exponential(1.0 / rates[state])
        while t > state_end:                       # advance the phase chain
            state = 1 - state
            state_end += rng.exponential(durations[state])
        p = int(rng.choice(n_prompts, p=weights))
        sys_len = int(sys_lens[p])
        user = int(np.clip(rng.lognormal(user_mu, user_sigma), 8, user_max))
        output = int(np.clip(rng.lognormal(output_mu, output_sigma),
                             1, output_max))
        inp = sys_len + user
        out.append(Request(rid=len(out), arrival=t, input_len=inp,
                           output_len=output,
                           is_long=inp >= long_threshold,
                           prefix_group=p,
                           # only the system prompt is shared across users;
                           # the user suffix is never reusable
                           prefix_len=sys_len, prefix_write=sys_len))
    return out


@register_scenario("smoke_mini",
                   "pinned deterministic longs-under-short-pressure smoke "
                   "trace (claims suite / engine grids)")
def smoke_mini(n_requests: int, seed: int, *, long_every: int = 7,
               arrival_gap: float = 0.002, long_input: int = 300_000,
               long_output: int = 60, short_input_low: int = 300,
               short_input_high: int = 3000, short_output_low: int = 10,
               short_output_high: int = 60, **ignored) -> List[Request]:
    """Fixed-shape mini stress trace: every `long_every`-th request is a
    300 K-token long arriving amid a steady 2 ms short stream — the regime
    that forces HOL blocking under FIFO, reservation splits, and repeated
    preemption under PecSched on a 2-general-replica cluster.  Deterministic
    under a fixed seed and small enough for real CPU engines, it is the
    pinned workload the claims regression suite replays on both backends
    (`repro_torch.experiments`).  Rate/length overrides other harnesses pass to
    every scenario are accepted-and-ignored: the point of a pinned trace is
    that nothing recalibrates it."""
    rng = np.random.default_rng(seed)
    reqs, t = [], 0.0
    for i in range(n_requests):
        is_long = i % long_every == 0
        t += arrival_gap if i else 0.0
        reqs.append(Request(
            rid=i, arrival=round(t, 6),
            input_len=long_input if is_long
            else int(rng.integers(short_input_low, short_input_high)),
            output_len=long_output if is_long
            else int(rng.integers(short_output_low, short_output_high)),
            is_long=is_long))
    return reqs


@register_scenario("csv", "replay a real Azure-trace-format CSV (path=...)")
def csv_scenario(n_requests: int, seed: int, *, path: str,
                 **kw) -> List[Request]:
    del seed  # replays are deterministic by construction
    # harnesses pass arrival_rps to every scenario; a recorded trace has its
    # own arrival times, so that one knob is accepted-and-ignored. Anything
    # else unknown is a caller error, same as the synthetic scenarios.
    kw.pop("arrival_rps", None)
    unknown = set(kw) - {"long_threshold", "time_scale"}
    if unknown:
        raise TypeError(f"csv scenario got unexpected overrides {unknown}")
    return load_trace_csv(path, max_requests=n_requests or None, **kw)
