"""Claims-as-tests: the paper's §3/§6 artifacts as executable assertions.

Each `Claim` encodes one figure/table-level statement from the paper as a
metric expression over a policy sweep, a direction, and a threshold with
tolerance.  The registry is the single source of truth three consumers
share: the `-m claims` golden suite (tests/test_claims.py) gates every PR
on it, `benchmarks/run.py` evaluates it against the full sweeps, and
`report.py` renders it into the EXPERIMENTS.md claims ledger +
claims_report.json.

Expressions evaluate in a tiny closed namespace over one sweep cell
({policy: summarize-dict}); helpers:

    qd99(pol)    short queueing-delay p99          rps(pol)   short RPS
    qd_mean(pol) short queueing-delay mean         jct(pol)   long JCT mean
    preempt(pol) total long suspensions            idle(pol)  GPU idle rate
    starved(pol) long starvation fraction          devict(pol) decode evictions
    tenant_qd99(pol, tenant)  per-tenant short qd p99 (multi_tenant)
    goodput(pol) SLO-honouring completions/s   attain(pol, tier) attainment
    shedfrac(pol, tier)  shed fraction of a tier's arrivals (slo_tiered)
    ratio(a, b)  a / max(b, 1e-9)  (safe when a policy's delay hits 0.0)
    m(pol, *keys) raw summary access

Direction semantics: ``ge`` passes when value >= threshold*(1-tolerance),
``le`` when value <= threshold*(1+tolerance) (thresholds <= 0 use absolute
tolerance instead, since relative slack is meaningless at 0).

Thresholds are reproduction-regime bounds, deliberately looser than the
paper's point values (EXPERIMENTS.md §Claims-ledger tabulates both): the
suite is a *direction-and-magnitude* regression gate for the smoke grids,
not a re-measurement of the paper's exact numbers.  Where the tiny real-
engine grid sits in a different regime than the simulated 32-GPU cluster,
a claim either carries a per-backend threshold override or restricts its
`backends` to ("sim",).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

#: sweep cell key: (backend, scenario) -> {policy: summary}
SweepCell = Dict[str, Dict]


@dataclass(frozen=True)
class Claim:
    cid: str
    paper_ref: str
    description: str
    metric_expr: str
    direction: str                       # "ge" | "le"
    threshold: float
    tolerance: float = 0.0               # relative slack on the threshold
    #: sim-side scenario; on the engine backend the pinned `smoke_mini`
    #: trace stands in for azure_default (experiments.smoke_sweep_cells)
    scenario: str = "azure_default"
    backends: Tuple[str, ...] = ("sim", "engine")
    #: per-backend threshold overrides, e.g. (("engine", 1.6),)
    thresholds: Tuple[Tuple[str, float], ...] = ()
    #: policies the expression reads — the runner uses this to know which
    #: sweeps a claim needs
    policies: Tuple[str, ...] = ()

    def threshold_for(self, backend: str) -> float:
        return dict(self.thresholds).get(backend, self.threshold)

    def bound(self, backend: str) -> float:
        """The effective pass bound after tolerance."""
        th = self.threshold_for(backend)
        if th <= 0:
            return th + self.tolerance if self.direction == "le" \
                else th - self.tolerance
        return th * (1 + self.tolerance) if self.direction == "le" \
            else th * (1 - self.tolerance)

    def passes(self, value: float, backend: str) -> bool:
        b = self.bound(backend)
        return value <= b if self.direction == "le" else value >= b


@dataclass
class ClaimResult:
    cid: str
    backend: str
    scenario: str
    value: Optional[float]
    threshold: float
    bound: float
    direction: str
    passed: bool
    skipped: Optional[str] = None        # reason, when not evaluated
    paper_ref: str = ""
    description: str = ""

    def to_dict(self) -> Dict:
        return dict(self.__dict__)


CLAIMS: Dict[str, Claim] = {}


def register_claim(**kw) -> Claim:
    c = Claim(**kw)
    if c.cid in CLAIMS:
        raise ValueError(f"duplicate claim id {c.cid!r}")
    if c.direction not in ("ge", "le"):
        raise ValueError(f"{c.cid}: bad direction {c.direction!r}")
    CLAIMS[c.cid] = c
    return c


# ---------------------------------------------------------------------------
# expression evaluation
# ---------------------------------------------------------------------------
def _env(results: SweepCell) -> Dict:
    def m(pol, *keys):
        v = results[pol]
        for k in keys:
            v = v[str(k)]
        return v

    def ratio(a, b):
        return a / max(b, 1e-9)

    return {
        "m": m,
        "ratio": ratio,
        "qd99": lambda pol: m(pol, "short_qd_pct", "99"),
        "qd_mean": lambda pol: m(pol, "short_qd_mean"),
        "rps": lambda pol: m(pol, "short_rps"),
        "jct": lambda pol: m(pol, "long_jct_mean"),
        "preempt": lambda pol: m(pol, "preemptions"),
        "idle": lambda pol: m(pol, "gpu_idle_rate"),
        "starved": lambda pol: m(pol, "long_starved_frac"),
        "tenant_qd99": lambda pol, t: m(pol, "per_tenant", t, "qd_pct", "99"),
        "flips": lambda pol: m(pol, "role_flips"),
        "devict": lambda pol: m(pol, "decode_preemptions"),
        "hit": lambda pol: m(pol, "prefix_hit_rate"),
        "saved": lambda pol: m(pol, "prefill_flops_saved"),
        "goodput": lambda pol: m(pol, "goodput"),
        "attain": lambda pol, tier: m(pol, "slo_tiers", tier, "attainment"),
        "shedfrac": lambda pol, tier: ratio(m(pol, "slo_tiers", tier, "shed"),
                                            m(pol, "slo_tiers", tier, "n")),
    }


def eval_claim(claim: Claim, results: SweepCell) -> float:
    value = eval(claim.metric_expr, {"__builtins__": {}}, _env(results))
    return float(value)


def evaluate_claims(sweeps: Dict[Tuple[str, str], SweepCell],
                    claims: Optional[Sequence[Claim]] = None
                    ) -> List[ClaimResult]:
    """Evaluate claims against sweep cells keyed (backend, scenario).

    Every (claim, backend) pair the claim declares produces one result; a
    pair whose sweep cell is absent (or whose expression hits a missing
    policy/metric) is reported as skipped, never silently dropped — a
    missing sweep must not read as a passing ledger."""
    out: List[ClaimResult] = []
    for claim in (claims if claims is not None else CLAIMS.values()):
        for backend in claim.backends:
            cell = sweeps.get((backend, claim.scenario))
            common = dict(cid=claim.cid, backend=backend,
                          scenario=claim.scenario,
                          threshold=claim.threshold_for(backend),
                          bound=claim.bound(backend),
                          direction=claim.direction,
                          paper_ref=claim.paper_ref,
                          description=claim.description)
            if cell is None:
                out.append(ClaimResult(value=None, passed=False,
                                       skipped="sweep cell not run", **common))
                continue
            try:
                value = eval_claim(claim, cell)
            except (KeyError, TypeError, ZeroDivisionError) as e:
                out.append(ClaimResult(
                    value=None, passed=False,
                    skipped=f"metric unavailable: {e!r}", **common))
                continue
            out.append(ClaimResult(value=value,
                                   passed=claim.passes(value, backend),
                                   **common))
    return out


def claims_for_scenarios() -> Dict[Tuple[str, str], List[str]]:
    """(backend, scenario) cells the registry needs, -> claim ids."""
    need: Dict[Tuple[str, str], List[str]] = {}
    for c in CLAIMS.values():
        for b in c.backends:
            need.setdefault((b, c.scenario), []).append(c.cid)
    return need


def policies_needed(scenario: str, backend: Optional[str] = None
                    ) -> Tuple[str, ...]:
    pols: List[str] = []
    for c in CLAIMS.values():
        if c.scenario == scenario and (backend is None or
                                       backend in c.backends):
            for p in c.policies:
                if p not in pols:
                    pols.append(p)
    return tuple(pols)


# ===========================================================================
# The registry: §3 motivation + §6 evaluation, one Claim per statement.
# "paper" notes the published value; thresholds bound our smoke regimes.
# ===========================================================================

# --- §3.2 / Fig.2: FIFO head-of-line blocking ------------------------------
register_claim(
    cid="fig2_hol_delay", paper_ref="Fig. 2",
    description="Long requests inflate FIFO's short p99 queueing delay "
                "(paper: 2.5-10.2x; ours is a stronger regime)",
    metric_expr="qd99('fifo') - qd99('fifo_noshort')",
    direction="ge", threshold=0.5,
    policies=("fifo", "fifo_noshort"))
register_claim(
    cid="fig2_hol_tput", paper_ref="Fig. 2",
    description="Long requests cut FIFO's short throughput "
                "(paper: to 0.19-0.64x of the no-long stream)",
    metric_expr="ratio(rps('fifo'), rps('fifo_noshort'))",
    direction="le", threshold=0.95,
    policies=("fifo", "fifo_noshort"))

# --- §3.2 / Table 1 + Fig.3: Reservation -----------------------------------
register_claim(
    cid="table1_idle_reservation", paper_ref="Table 1",
    description="Reservation idles GPUs that FIFO keeps busy "
                "(paper: 0.16-0.41 idle vs ~0.0005)",
    metric_expr="idle('reservation') - idle('fifo')",
    direction="ge", threshold=0.05,
    policies=("reservation", "fifo"))
register_claim(
    cid="fig3_res_long_jct", paper_ref="Fig. 3 / §3.2",
    description="Reservation's small long pool inflates long JCT vs FIFO",
    metric_expr="ratio(jct('reservation'), jct('fifo'))",
    direction="ge", threshold=1.2,
    policies=("reservation", "fifo"))

# --- §3.2 / Table 2: Priority starves longs --------------------------------
register_claim(
    cid="table2_priority_starves", paper_ref="Table 2",
    description="Priority starves a large fraction of long requests "
                "(paper: 0.92-1.00)",
    metric_expr="starved('priority')",
    direction="ge", threshold=0.4,
    policies=("priority",))
register_claim(
    cid="table2_pecsched_no_starvation", paper_ref="Table 2 / §5",
    description="PecSched never starves longs in the calibrated regime",
    metric_expr="starved('pecsched')",
    direction="le", threshold=0.0,
    backends=("sim",),
    policies=("pecsched",))

# --- §6.3 / Figs. 9-11: overall performance --------------------------------
register_claim(
    cid="fig9_qd_cut_vs_fifo", paper_ref="Fig. 9",
    description="PecSched cuts short p99 queueing delay vs FIFO "
                "(paper: 58-87%)",
    metric_expr="1 - ratio(qd99('pecsched'), qd99('fifo'))",
    direction="ge", threshold=0.5,
    policies=("pecsched", "fifo"))
register_claim(
    cid="fig9_qd_cut_vs_res", paper_ref="Fig. 9",
    description="PecSched cuts short p99 queueing delay vs Reservation "
                "(paper: 61-92%, the headline 92% claim)",
    metric_expr="1 - ratio(qd99('pecsched'), qd99('reservation'))",
    direction="ge", threshold=0.5,
    policies=("pecsched", "reservation"))
register_claim(
    cid="fig10_tput_gain_vs_fifo", paper_ref="Fig. 10",
    description="PecSched raises short throughput vs FIFO "
                "(paper: +42-318%)",
    metric_expr="ratio(rps('pecsched'), rps('fifo')) - 1",
    direction="ge", threshold=0.05,
    policies=("pecsched", "fifo"))
register_claim(
    cid="fig10_tput_gain_vs_res", paper_ref="Fig. 10",
    description="PecSched raises short throughput vs Reservation "
                "(paper: +193-595%, the headline 595% claim)",
    metric_expr="ratio(rps('pecsched'), rps('reservation')) - 1",
    direction="ge", threshold=0.05,
    backends=("sim",),           # the 2-replica engine grid saturates both
    policies=("pecsched", "reservation"))
register_claim(
    cid="fig11_long_jct_cost", paper_ref="Fig. 11",
    description="PecSched's long-JCT cost vs FIFO stays modest "
                "(paper: 1.04-1.07x)",
    metric_expr="ratio(jct('pecsched'), jct('fifo'))",
    direction="le", threshold=1.2,
    thresholds=(("engine", 1.6),),     # tiny engine grid amortizes less
    policies=("pecsched", "fifo"))

# --- §6.4 / Figs. 12-14 + Tables 3/6: ablations ----------------------------
register_claim(
    cid="fig12_preempt_delay_ablation", paper_ref="Fig. 12",
    description="Disabling preemption (/PE) gives back short p99 delay",
    metric_expr="qd99('pecsched/pe') - qd99('pecsched')",
    direction="ge", threshold=0.5,
    # gang-SP regime (ENGINE_TARGET_PREFILL_S): longs claim BOTH general
    # replicas, so /PE's un-preempted shorts recover a smaller absolute
    # delta on the 2-replica grid — the sign is what the engine cell pins
    thresholds=(("engine", 0.2),),
    policies=("pecsched/pe", "pecsched"))
register_claim(
    cid="fig12_pe_disables_preemption", paper_ref="Fig. 12 / §6.4",
    description="/PE performs zero suspensions (ablation sanity)",
    metric_expr="preempt('pecsched/pe')",
    direction="le", threshold=0.0,
    policies=("pecsched/pe",))
register_claim(
    cid="table6_pec_preempts", paper_ref="Table 6",
    description="Full PecSched actively preempts long prefills",
    metric_expr="preempt('pecsched')",
    direction="ge", threshold=1.0,
    policies=("pecsched",))
register_claim(
    cid="table3_fsp_more_preempts", paper_ref="Table 3 / Fig. 14",
    description="Without fast SP (/FSP) prefills stretch and suspensions "
                "do not drop (paper: 167K-379K on the full trace)",
    metric_expr="preempt('pecsched/fsp') - preempt('pecsched')",
    direction="ge", threshold=0.0,
    policies=("pecsched/fsp", "pecsched"))
register_claim(
    cid="table6_col_preempt_order", paper_ref="Table 6",
    description="Removing colocation (/CoL) cannot reduce suspensions "
                "(paper ordering: pec < /Dis < /CoL < /FSP)",
    metric_expr="preempt('pecsched/col') - preempt('pecsched')",
    direction="ge", threshold=0.0,
    policies=("pecsched/col", "pecsched"))
register_claim(
    cid="fig13_dis_jct", paper_ref="Fig. 13",
    description="Removing disaggregation (/Dis) inflates long JCT "
                "(paper: 1.21-1.29x)",
    metric_expr="ratio(jct('pecsched/dis'), jct('pecsched'))",
    direction="ge", threshold=1.1,
    backends=("sim",),           # /Dis flips regime on the 2-replica grid
    policies=("pecsched/dis", "pecsched"))
register_claim(
    cid="fig14_fsp_jct", paper_ref="Fig. 14",
    description="Ring-only SP (/FSP) inflates long JCT "
                "(paper: 1.39-1.55x)",
    metric_expr="ratio(jct('pecsched/fsp'), jct('pecsched'))",
    direction="ge", threshold=1.1,
    # engine-evaluated since the gang-SP regime: ENGINE_TARGET_PREFILL_S
    # makes longs claim an SP group on the engine cluster, so ring-only SP
    # (/FSP) prices — and on multi-device hosts, executes — slower prefill
    policies=("pecsched/fsp", "pecsched"))

# --- §5.2 coordination: load-adaptive vs static prefill/decode split -------
# Cells pin a prefill-surge regime (high utilization, light decode — the
# summarization-like mix where the decode pool has headroom to lend; see
# experiments.CELL_SETUP).  The static split leaves the pool idle through
# the surges; the coordinator lends it to short prefill and takes it back
# when decode pressure returns.
register_claim(
    cid="coord_qd_cut_bursty", paper_ref="§5.2 (coordination)",
    description="Adaptive role coordination cuts short p99 queueing delay "
                "vs the static split under bursty arrivals",
    metric_expr="1 - ratio(qd99('pecsched/coord'), qd99('pecsched'))",
    direction="ge", threshold=0.05,
    # the 3-replica engine cell can only lend one replica; the bar there is
    # "no worse", the sim cell carries the strict improvement
    thresholds=(("engine", 0.0),),
    scenario="bursty",
    policies=("pecsched/coord", "pecsched"))
register_claim(
    cid="coord_long_jct_bursty", paper_ref="§5.2 (coordination)",
    description="Coordination does not tax long JCT by more than 5% "
                "under bursty arrivals (borrowed replicas serve short "
                "prefill only, never long groups)",
    metric_expr="ratio(jct('pecsched/coord'), jct('pecsched'))",
    direction="le", threshold=1.05,
    thresholds=(("engine", 1.1),),     # tiny engine grid amortizes less
    scenario="bursty",
    policies=("pecsched/coord", "pecsched"))
register_claim(
    cid="coord_flips_live", paper_ref="§5.2 (coordination)",
    description="The coordinator actually flips roles under bursty load "
                "(adaptive != static by construction, not by accident)",
    metric_expr="flips('pecsched/coord')",
    direction="ge", threshold=2.0,
    # the engine cell's pool-of-one cluster has nothing to lend under the
    # default min_decode floor — adaptive deliberately equals static there
    # (the engine cells pin "coordination never hurts"); real engine role
    # flips are exercised by the cross-backend parity test instead
    scenario="bursty", backends=("sim",),
    policies=("pecsched/coord",))
register_claim(
    cid="coord_qd_cut_diurnal", paper_ref="§5.2 (coordination)",
    description="Adaptive role coordination cuts short p99 queueing delay "
                "vs the static split across day/night cycles",
    metric_expr="1 - ratio(qd99('pecsched/coord'), qd99('pecsched'))",
    direction="ge", threshold=0.05,
    thresholds=(("engine", 0.0),),     # pool-of-one: "no worse" (see bursty)
    scenario="diurnal",
    policies=("pecsched/coord", "pecsched"))
register_claim(
    cid="coord_long_jct_diurnal", paper_ref="§5.2 (coordination)",
    description="Coordination does not tax long JCT by more than 5% "
                "across day/night cycles",
    metric_expr="ratio(jct('pecsched/coord'), jct('pecsched'))",
    direction="le", threshold=1.05,
    thresholds=(("engine", 1.1),),
    scenario="diurnal",
    policies=("pecsched/coord", "pecsched"))

# --- prediction robustness: output-length prediction under uncertainty -----
# The `pred_stress` cells pin the regime where output prediction is
# decision-relevant (input-dominated heavy tail, narrow outputs; see
# core/scenarios.py and experiments/robustness.py): perfect prediction
# beats PecSched's prediction-free preemption, calibrated noise hands the
# advantage back, and quantile hedging contains the eviction cost of
# misprediction without touching the queueing decisions.
register_claim(
    cid="pred_oracle_qd_cut", paper_ref="§7 (prediction extension)",
    description="With a perfect output-length oracle, predicted-SJF beats "
                "PecSched's prediction-free preemption on short p99 "
                "queueing delay",
    metric_expr="1 - ratio(qd99('sjf_pred:oracle'), qd99('pecsched'))",
    direction="ge", threshold=0.08,
    scenario="pred_stress",
    policies=("sjf_pred:oracle", "pecsched"))
register_claim(
    cid="pred_noise_crossover", paper_ref="§7 (prediction extension)",
    description="At sigma=2.0 multiplicative prediction error, the oracle "
                "advantage inverts: PecSched wins p99 back (the robustness "
                "crossover; experiments/robustness.py locates sigma*)",
    metric_expr="ratio(qd99('sjf_pred:noisy2.0'), qd99('pecsched'))",
    direction="ge", threshold=1.1,
    scenario="pred_stress",
    policies=("sjf_pred:noisy2.0", "pecsched"))
register_claim(
    cid="pred_oracle_zero_evictions", paper_ref="§7 (prediction extension)",
    description="A perfect predictor never underpredicts, so predicted-SJF "
                "performs zero decode-lane evictions (sanity anchor for "
                "the misprediction counter)",
    metric_expr="devict('sjf_pred:oracle')",
    direction="le", threshold=0.0,
    scenario="pred_stress",
    policies=("sjf_pred:oracle",))
register_claim(
    cid="pred_tail_budget_evictions", paper_ref="§7 (prediction extension)",
    description="Budgeting decode lanes at the q90 predictive quantile "
                "(tail_aware) cuts decode-lane evictions vs point-estimate "
                "budgets at the same sigma",
    metric_expr="ratio(devict('tail_aware:noisy2.0'), "
                "devict('sjf_pred:noisy2.0'))",
    direction="le", threshold=0.5,
    scenario="pred_stress",
    policies=("tail_aware:noisy2.0", "sjf_pred:noisy2.0"))
register_claim(
    cid="pred_tail_same_ordering", paper_ref="§7 (prediction extension)",
    description="tail_aware hedges budgets only — its queueing decisions "
                "(and hence short p99 delay) match sjf_pred exactly at the "
                "same sigma",
    metric_expr="ratio(qd99('tail_aware:noisy2.0'), "
                "qd99('sjf_pred:noisy2.0'))",
    direction="le", threshold=1.0, tolerance=0.02,
    scenario="pred_stress",
    policies=("tail_aware:noisy2.0", "sjf_pred:noisy2.0"))
register_claim(
    cid="pred_adversarial_evictions", paper_ref="§7 (prediction extension)",
    description="An adversarial (inverse-rank) predictor maximizes "
                "underprediction: strictly more decode-lane evictions than "
                "any calibrated arm (the canary the regression test "
                "substitutes into honest cells)",
    metric_expr="ratio(devict('sjf_pred:adversarial'), "
                "devict('sjf_pred:noisy2.0'))",
    direction="ge", threshold=1.3,
    scenario="pred_stress",
    policies=("sjf_pred:adversarial", "sjf_pred:noisy2.0"))
register_claim(
    cid="pred_long_jct_cost", paper_ref="§7 (prediction extension)",
    description="Prediction is not free for longs: never-preempted "
                "predicted-SJF longs queue behind the short backlog, "
                "paying vs PecSched's suspend/resume (sim cluster; the "
                "tiny engine grid drains longs too fast to price this)",
    metric_expr="ratio(jct('sjf_pred:oracle'), jct('pecsched'))",
    direction="ge", threshold=1.15,
    scenario="pred_stress", backends=("sim",),
    policies=("sjf_pred:oracle", "pecsched"))

# --- prefix-cache extension: block-hash reuse + cache-affinity routing -----
# Multi-turn chat grows each session's context past the 2K short/long
# boundary (the is_long misclassification this PR fixes made those turns
# invisible to the long path entirely); with the threshold fixed, those
# 10K+-token turns are exactly where prefix reuse pays.  `pecsched/cache`
# discounts resident prefixes and routes toward them only when reuse beats
# the wait — the greedy ablation chases residency unconditionally and must
# pay for it at the short tail under burst.
register_claim(
    cid="cache_chat_long_jct_cut", paper_ref="§7 (prefix-cache extension)",
    description="Block-hash prefix reuse + cache-affinity routing cut mean "
                "long JCT (TTFT-dominated: the re-classified multi-turn "
                "contexts skip resident prefill) vs plain PecSched on "
                "multi-turn chat",
    metric_expr="1 - ratio(jct('pecsched/cache'), jct('pecsched'))",
    direction="ge", threshold=0.05,
    scenario="chat_multiturn",
    policies=("pecsched/cache", "pecsched"))
register_claim(
    cid="cache_chat_hit_rate", paper_ref="§7 (prefix-cache extension)",
    description="Session contexts actually resolve against the residency "
                "map: whole-block prefix hit rate on multi-turn chat",
    metric_expr="hit('pecsched/cache')",
    direction="ge", threshold=0.35,
    scenario="chat_multiturn",
    policies=("pecsched/cache",))
register_claim(
    cid="cache_chat_flops_saved", paper_ref="§7 (prefix-cache extension)",
    description="Prefix reuse skips real prefill compute (the "
                "prefill_flops_saved counter is live, not decorative)",
    metric_expr="saved('pecsched/cache')",
    direction="ge", threshold=1.0,
    scenario="chat_multiturn",
    policies=("pecsched/cache",))
register_claim(
    cid="cache_chat_no_short_tax", paper_ref="§7 (prefix-cache extension)",
    description="Cache-affinity routing never trades the short tail away: "
                "short p99 queueing delay stays at PecSched's level (the "
                "router prefers residency only among idle replicas)",
    metric_expr="qd99('pecsched/cache') - qd99('pecsched')",
    direction="le", threshold=0.0, tolerance=0.02,
    scenario="chat_multiturn",
    policies=("pecsched/cache", "pecsched"))
register_claim(
    cid="cache_shared_long_jct_cut", paper_ref="§7 (prefix-cache extension)",
    description="Under a bursty shared-system-prompt mix, prefix reuse "
                "cuts mean long JCT vs plain PecSched",
    metric_expr="1 - ratio(jct('pecsched/cache'), jct('pecsched'))",
    direction="ge", threshold=0.15,
    # the 3-replica engine grid drains its queue fast enough that only the
    # prefill discount itself shows; the bar there is a smaller strict cut
    thresholds=(("engine", 0.02),),
    scenario="shared_prefix",
    policies=("pecsched/cache", "pecsched"))
register_claim(
    cid="cache_shared_hit_rate", paper_ref="§7 (prefix-cache extension)",
    description="Zipf-popular system prompts stay resident: whole-block "
                "prefix hit rate on the shared-prefix mix",
    metric_expr="hit('pecsched/cache')",
    direction="ge", threshold=0.6,
    thresholds=(("engine", 0.4),),     # 64-request grid, colder cache
    scenario="shared_prefix",
    policies=("pecsched/cache",))
register_claim(
    cid="cache_greedy_burst_tax", paper_ref="§7 (prefix-cache extension)",
    description="The affinity-vs-balance tension is real: a cache-greedy "
                "router (holds the queue for a busy replica with the best "
                "resident copy) LOSES on short p99 queueing delay under "
                "bursty arrivals — balance must stay in charge of the tail "
                "(sim cluster; the tiny engine grid has no queueing to tax)",
    metric_expr="qd99('pecsched/cache_greedy') - qd99('pecsched/cache')",
    direction="ge", threshold=0.1,
    scenario="shared_prefix", backends=("sim",),
    policies=("pecsched/cache_greedy", "pecsched/cache"))
register_claim(
    cid="cache_greedy_same_reuse", paper_ref="§7 (prefix-cache extension)",
    description="The greedy tax is pure queueing, not reuse: greedy's hit "
                "rate matches the balanced router's (chasing residency "
                "harder buys nothing once recording follows placement)",
    metric_expr="ratio(hit('pecsched/cache_greedy'), "
                "hit('pecsched/cache'))",
    direction="ge", threshold=0.9,
    scenario="shared_prefix", backends=("sim",),
    policies=("pecsched/cache_greedy", "pecsched/cache"))

# --- SLO extension: plan-ahead scheduling with goodput as the objective ----
# The `slo_tiered` cells pin a tight-contract overload regime (utilization
# just past calibrated short capacity, halved SLO targets; see
# experiments.CELL_SETUP): plain PecSched — FIFO within the short class —
# drops interactive attainment below the 0.95 bar there, and the plan-ahead
# policy's slack ordering + long-claim retraction wins it back without
# giving up goodput or taxing longs.  The engine cell's 3-replica grid sits
# in a different regime (compressed ms-scale timeline), so it pins the
# weaker "plan-ahead never hurts" direction, like the coordination cells.
register_claim(
    cid="slo_goodput_gain", paper_ref="§7 (SLO extension)",
    description="Plan-ahead scheduling does not trade goodput away: "
                "SLO-honouring completions per second match or beat plain "
                "PecSched on the tiered bursty mix",
    metric_expr="ratio(goodput('pecsched/slo'), goodput('pecsched'))",
    direction="ge", threshold=1.0,
    scenario="slo_tiered", backends=("sim",),
    policies=("pecsched/slo", "pecsched"))
register_claim(
    cid="slo_interactive_attained", paper_ref="§7 (SLO extension)",
    description="The interactive tier meets its TTFT/TPOT contract at "
                "least 95% of the time under plan-ahead scheduling",
    metric_expr="attain('pecsched/slo', 'interactive')",
    direction="ge", threshold=0.95,
    scenario="slo_tiered", backends=("sim",),
    policies=("pecsched/slo",))
register_claim(
    cid="slo_pecsched_misses", paper_ref="§7 (SLO extension)",
    description="The regime is binding: plain PecSched (FIFO within the "
                "short class) falls below the 0.95 interactive bar the "
                "plan-ahead policy clears",
    metric_expr="attain('pecsched', 'interactive')",
    direction="le", threshold=0.95,
    scenario="slo_tiered", backends=("sim",),
    policies=("pecsched",))
register_claim(
    cid="slo_interactive_gain", paper_ref="§7 (SLO extension)",
    description="Slack ordering + retraction strictly raise interactive "
                "attainment over plain PecSched (sim); the tiny engine "
                "grid pins the 'never hurts' direction",
    metric_expr="attain('pecsched/slo', 'interactive') "
                "- attain('pecsched', 'interactive')",
    direction="ge", threshold=0.02,
    thresholds=(("engine", 0.0),),
    scenario="slo_tiered",
    policies=("pecsched/slo", "pecsched"))
register_claim(
    cid="slo_batch_shed_bounded", paper_ref="§7 (SLO extension)",
    description="Shedding stays surgical: at most 10% of batch-tier work "
                "is dropped, and only when the plan window is provably "
                "oversubscribed",
    metric_expr="shedfrac('pecsched/slo', 'batch')",
    direction="le", threshold=0.10,
    scenario="slo_tiered", backends=("sim",),
    policies=("pecsched/slo",))
register_claim(
    cid="slo_long_jct_cost", paper_ref="§7 (SLO extension)",
    description="Retracting planned (never started) long placements under "
                "urgency costs longs at most 10% mean JCT vs plain "
                "PecSched",
    metric_expr="ratio(jct('pecsched/slo'), jct('pecsched'))",
    direction="le", threshold=1.1,
    scenario="slo_tiered", backends=("sim",),
    policies=("pecsched/slo", "pecsched"))


# --- scenario extension: multi-tenant fairness -----------------------------
register_claim(
    cid="mt_chat_qd_cut", paper_ref="Fig. 9 (multi_tenant extension)",
    description="PecSched's short-delay cut holds for the interactive chat "
                "tenant in the multi-tenant mix",
    metric_expr="1 - ratio(tenant_qd99('pecsched', 'chat'), "
                "tenant_qd99('fifo', 'chat'))",
    direction="ge", threshold=0.5,
    scenario="multi_tenant", backends=("sim",),
    policies=("pecsched", "fifo"))


# --- elastic-fleet churn (core/fleet.py) -----------------------------------
# The paper's fleet is static; these cells replay the azure mix while the
# runner reclaims 20% of the replicas mid-trace (spot eviction with a
# notice window).  The headline question: does the preemptive short-QD win
# survive losing a fifth of the fleet, on both execution worlds?
register_claim(
    cid="churn_wave_applied", paper_ref="§8 (elastic-fleet extension)",
    description="The wave is real: every configured reclamation executed — "
                "ceil(0.2 x 32) = 7 replicas on the sim grid, ceil(0.2 x 3) "
                "= 1 on the engine grid — and no short request was lost",
    metric_expr="m('pecsched', 'reclaims')"
                " * (m('pecsched', 'short_completed')"
                " == m('pecsched', 'n_short'))",
    direction="ge", threshold=1.0,
    scenario="churn",
    policies=("pecsched",))
register_claim(
    cid="churn_qd_cut_vs_fifo", paper_ref="Fig. 2/3 (elastic extension)",
    description="PecSched's p99 short queueing-delay cut over FIFO survives "
                "a 20%-of-fleet reclamation wave: preemption + KV "
                "evacuation keep shorts off the dying replicas while FIFO "
                "restarts their work from scratch",
    metric_expr="1 - ratio(qd99('pecsched'), qd99('fifo'))",
    direction="ge", threshold=0.9,
    thresholds=(("engine", 0.5),),
    scenario="churn",
    policies=("pecsched", "fifo"))
register_claim(
    cid="churn_coord_qd_cut_vs_fifo", paper_ref="§5.2 (elastic extension)",
    description="The coordinated variant holds the same p99 cut under the "
                "wave — role flips and reclamations compose",
    metric_expr="1 - ratio(qd99('pecsched/coord'), qd99('fifo'))",
    direction="ge", threshold=0.9,
    thresholds=(("engine", 0.5),),
    scenario="churn",
    policies=("pecsched/coord", "fifo"))
register_claim(
    cid="churn_graceful_no_restarts", paper_ref="§5.1 (elastic extension)",
    description="Graceful degradation: PecSched resumes from migrated KV "
                "rather than restarting — zero restarted requests under the "
                "wave, where FIFO (no evacuation hook beyond requeue) "
                "restarts every caught in-flight batch",
    metric_expr="m('pecsched', 'restarted_requests')",
    direction="le", threshold=0.0,
    scenario="churn",
    policies=("pecsched",))
register_claim(
    cid="churn_scale_joins_fire", paper_ref="§8 (elastic-fleet extension)",
    description="Pressure-driven scale-up is live: with the cell overloaded "
                "past the post-wave knee, the coordinator backlog signal "
                "fires every allowed join (7 = the whole wave)",
    metric_expr="m('pecsched', 'joins')",
    direction="ge", threshold=7.0,
    scenario="churn_scale", backends=("sim",),
    policies=("pecsched",))
register_claim(
    cid="churn_scale_p99_recovery", paper_ref="§8 (elastic-fleet extension)",
    description="Autoscale-up restores the tail within a bounded window: "
                "with joins backfilling the wave (5 s provisioning), p99 "
                "short QD stays under 100 ms at 2.4x calibrated capacity — "
                "the same cell without autoscale sits at ~190 ms (pinned in "
                "EXPERIMENTS.md §Elastic-fleet churn)",
    metric_expr="qd99('pecsched')",
    direction="le", threshold=0.1,
    scenario="churn_scale", backends=("sim",),
    policies=("pecsched",))
