"""Output-length predictors: the scheduler-visible estimate of a request's
decode length.

`Request.output_len` is ground truth the scheduler must never read
(core/request.py) — the execution world reveals it only by emitting EOS.
Prediction-aware policies (`sjf_pred`, `tail_aware` in core/schedulers.py)
therefore consult a `Predictor`, mirroring the output-length-predictor
line of work the roadmap names (ELIS's response-length predictor,
Beyond-Prediction's quantile hedging):

    oracle          exact (the σ=0 end of the robustness sweep)
    bucketed_noisy  truth x log-normal multiplicative error, quantized to
                    geometric buckets — a length *classifier* with a
                    controllable error scale σ
    trace_history   per-tenant/session running quantiles learned online
                    from completed requests (no ground-truth access at
                    predict time; `observe` is called at EOS)
    adversarial     inverse rank of the true length — the worst-case
                    predictor the claims-ledger canary substitutes in to
                    prove the robustness cells can fail

Contract: predictors never mutate the `Request`; `predict` and `quantile`
are deterministic given (predictor config, request) and the observation
history; estimates are always finite and >= 1 token.
"""
from __future__ import annotations

import bisect
import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.request import Request

#: geometric bucket ratio of `bucketed_noisy` (√2 ≈ half-octave classes)
BUCKET_RATIO = math.sqrt(2.0)

PREDICTOR_NAMES = ("oracle", "noisy<sigma>", "history", "adversarial")


# ---------------------------------------------------------------------------
# Vectorized per-rid noise draws.
#
# `BucketedNoisyPredictor` pins its error draw to
# ``default_rng((seed, rid)).standard_normal()`` — one rng *construction*
# per request, ~17 us each, which at bench scale is a quarter of the
# sjf_pred wall clock.  Almost all of that is SeedSequence entropy hashing
# and PCG64 seeding, both data-independent in their control flow, so they
# vectorize across a block of rids.  The replication below reproduces
# numpy's pipeline bit-for-bit (SeedSequence pool mixing -> generate_state
# -> pcg64_srandom), verified at first use against default_rng itself: any
# mismatch (different numpy internals, exotic seeds) permanently falls the
# predictor back to the per-rid construction, so the draws a scheduling
# decision sees are identical either way.
# ---------------------------------------------------------------------------
_SS_XSHIFT = np.uint32(16)
_SS_INIT_A, _SS_MULT_A = 0x43B0D7E5, 0x931E8875
_SS_INIT_B, _SS_MULT_B = 0x8B51F9DD, 0x58F38DED
_SS_MIX_L = np.uint32(0xCA01F9DD)
_SS_MIX_R = np.uint32(0x4973F715)
_PCG64_MULT = (2549297995355413924 << 64) + 4865540595714422341
_M128 = (1 << 128) - 1

def _hash_const_pairs(init: int, mult: int, n: int):
    """hashmix XORs the pre-update constant and multiplies by the post-
    update one; the constant stream is data-independent, so precompute the
    (pre, post) pair of every call in sequence order."""
    pairs, hc = [], init
    for _ in range(n):
        post = (hc * mult) & 0xFFFFFFFF
        pairs.append((np.uint32(hc), np.uint32(post)))
        hc = post
    return pairs


#: mix_entropy makes 16 hashmix calls per sequence (4 pool fills + 4x3
#: cross-mix); generate_state(4, uint64) makes 8 with the B constants
_HC_A = _hash_const_pairs(_SS_INIT_A, _SS_MULT_A, 16)
_HC_B = _hash_const_pairs(_SS_INIT_B, _SS_MULT_B, 8)


def _pcg64_seed_words(seed: int, rids: np.ndarray):
    """`SeedSequence((seed, rid)).generate_state(4, np.uint64)` for every
    rid at once: the pool mixing and state generation loops have data-
    independent control flow, so each scalar hashmix/mix call becomes one
    vector op across the block.  Returns a list of 8 uint32 arrays (the
    little-endian word pairs of the 4 uint64 state words)."""
    n = len(rids)
    calls = iter(_HC_A)

    def hashmix(value):
        pre, post = next(calls)
        value = (value ^ pre) * post
        return value ^ (value >> _SS_XSHIFT)

    def mix(x, y):
        r = x * _SS_MIX_L - y * _SS_MIX_R
        return r ^ (r >> _SS_XSHIFT)

    # pool fill: assembled entropy is (seed, rid) zero-padded to pool size 4
    pool = [hashmix(np.full(n, seed, dtype=np.uint32)),
            hashmix(rids.astype(np.uint32)),
            hashmix(np.zeros(n, dtype=np.uint32)),
            hashmix(np.zeros(n, dtype=np.uint32))]
    # cross-mix every source into every other destination, in call order
    for i_src in range(4):
        for i_dst in range(4):
            if i_src != i_dst:
                pool[i_dst] = mix(pool[i_dst], hashmix(pool[i_src]))

    out, calls_b = [], iter(_HC_B)
    for i in range(8):          # generate_state cycles the pool
        pre, post = next(calls_b)
        v = (pool[i % 4] ^ pre) * post
        out.append(v ^ (v >> _SS_XSHIFT))
    return out


def _standard_normal_block(seed: int, rids: np.ndarray,
                           gen: "np.random.Generator") -> np.ndarray:
    """One ``default_rng((seed, rid)).standard_normal()`` per rid, with the
    SeedSequence hashing vectorized and `gen`'s PCG64 reseeded in place per
    rid (pcg64_srandom replicated on 128-bit Python ints)."""
    w = _pcg64_seed_words(seed, rids)
    hi = [a.astype(np.uint64) for a in (w[1], w[3], w[5], w[7])]
    lo = [a.astype(np.uint64) for a in (w[0], w[2], w[4], w[6])]
    # PCG_128BIT_CONSTANT(val[0], val[1]): first uint64 is the HIGH half
    initstate = [(int(a) << 96) | (int(b) << 64) | (int(c) << 32) | int(d)
                 for a, b, c, d in zip(hi[0], lo[0], hi[1], lo[1])]
    initseq = [(int(a) << 96) | (int(b) << 64) | (int(c) << 32) | int(d)
               for a, b, c, d in zip(hi[2], lo[2], hi[3], lo[3])]
    bg = gen.bit_generator
    st = bg.state                       # template dict, mutated per rid
    inner = st["state"]
    st["has_uint32"] = 0
    st["uinteger"] = 0
    out = np.empty(len(rids), dtype=np.float64)
    normal = gen.standard_normal
    for i, (s0, i0) in enumerate(zip(initstate, initseq)):
        inc = ((i0 << 1) | 1) & _M128   # pcg64_srandom_r
        inner["state"] = ((inc + s0) * _PCG64_MULT + inc) & _M128
        inner["inc"] = inc
        bg.state = st
        out[i] = normal()
    return out


class Predictor:
    """Pluggable output-length predictor (see module docstring)."""

    name = "base"

    def predict(self, req: Request) -> float:
        """Point estimate of the request's total output length (tokens)."""
        raise NotImplementedError

    def quantile(self, req: Request, q: float) -> float:
        """`q`-quantile of the predictive distribution.  Point predictors
        collapse to their estimate; tail-aware policies schedule against a
        high quantile of this (Beyond-Prediction hedging)."""
        return self.predict(req)

    def observe(self, req: Request, output_len: int) -> None:
        """Execution-side feedback: called when `req` finishes generating
        (the one moment the true length is observable).  Online predictors
        update their state; stateless ones ignore it."""


class OraclePredictor(Predictor):
    """Exact output length — the σ=0 reference arm of the sweep."""

    name = "oracle"

    def predict(self, req: Request) -> float:
        return float(max(req.output_len, 1))


class BucketedNoisyPredictor(Predictor):
    """Truth perturbed by log-normal multiplicative error of scale `sigma`,
    then quantized to geometric buckets (ratio `BUCKET_RATIO`) — the shape
    of a trained length classifier with a tunable error knob.

    The error draw is deterministic per (seed, rid), so the same request
    always gets the same (mis)prediction on every backend — the property
    cross-backend decision parity relies on.
    """

    name = "bucketed_noisy"

    #: rids precomputed per vectorized block (must be a power of two)
    _FAST_BLOCK = 1024
    #: probe rids the fast path is verified on before first use
    _FAST_PROBE = (0, 1, 2, 3, 1000, 12345, (1 << 20) + 7, (1 << 31) - 1)

    def __init__(self, sigma: float = 0.6, seed: int = 0):
        if sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {sigma}")
        self.sigma = float(sigma)
        self.seed = int(seed)
        self._log_ratio = math.log(BUCKET_RATIO)
        self._noise_cache: Dict[int, float] = {}
        self._fast_ok = None                # None = not yet verified
        self._gen = None                    # reusable Generator (fast path)

    def _verify_fast(self) -> bool:
        """Prove the vectorized pipeline reproduces default_rng exactly on
        this numpy before trusting it; a single mismatch disables it for
        the predictor's lifetime (the slow path IS the contract)."""
        if not 0 <= self.seed < (1 << 32):
            return False
        try:
            rids = np.array(self._FAST_PROBE, dtype=np.int64)
            self._gen = np.random.Generator(np.random.PCG64())
            fast = _standard_normal_block(self.seed, rids, self._gen)
            want = [np.random.default_rng((self.seed, r)).standard_normal()
                    for r in self._FAST_PROBE]
            return all(f == w for f, w in zip(fast, want))
        except Exception:
            return False

    def _noise(self, req: Request) -> float:
        rid = req.rid & 0x7FFFFFFF
        z = self._noise_cache.get(rid)
        if z is None:
            if self._fast_ok is None:
                self._fast_ok = self._verify_fast()
            if self._fast_ok:
                base = rid & ~(self._FAST_BLOCK - 1)
                rids = np.arange(base, base + self._FAST_BLOCK,
                                 dtype=np.int64)
                vals = _standard_normal_block(self.seed, rids, self._gen)
                cache = self._noise_cache
                for r, v in zip(range(base, base + self._FAST_BLOCK), vals):
                    cache[r] = float(v)
                z = cache[rid]
            else:
                rng = np.random.default_rng((self.seed, rid))
                z = self._noise_cache[rid] = float(rng.standard_normal())
        return z

    def _bucket(self, x: float) -> float:
        if x <= 1.0:
            return 1.0
        k = round(math.log(x) / self._log_ratio)
        return float(math.exp(k * self._log_ratio))

    def predict(self, req: Request) -> float:
        raw = max(req.output_len, 1) * math.exp(self.sigma * self._noise(req))
        return self._bucket(raw)

    def quantile(self, req: Request, q: float) -> float:
        """The error scale σ is a *known* property of a deployed classifier
        (measured on holdout), so the predictive distribution around the
        point estimate is log-normal(σ): quantiles scale it by exp(σ z_q)."""
        q = min(max(q, 1e-6), 1.0 - 1e-6)
        z = NormalDist().inv_cdf(q)
        return max(self.predict(req) * math.exp(self.sigma * z), 1.0)


class TraceHistoryPredictor(Predictor):
    """Per-tenant/session running quantiles learned online.

    Completed requests feed `observe`; estimates are empirical quantiles of
    the lengths seen so far under the request's key (session if tagged,
    else tenant, else the global stream), falling back to the global
    history and then a fixed prior while a key is cold.  Never reads
    `output_len` at predict time.
    """

    name = "trace_history"

    def __init__(self, prior: float = 64.0):
        self.prior = float(prior)
        self._hist: Dict[Tuple[str, object], List[float]] = {}

    @staticmethod
    def _key(req: Request) -> Tuple[str, object]:
        if req.session is not None:
            return ("session", req.session)
        if req.tenant is not None:
            return ("tenant", req.tenant)
        return ("global", None)

    def observe(self, req: Request, output_len: int) -> None:
        val = float(max(output_len, 1))
        key = self._key(req)
        bisect.insort(self._hist.setdefault(key, []), val)
        if key != ("global", None):
            bisect.insort(self._hist.setdefault(("global", None), []), val)

    def _values(self, req: Request) -> List[float]:
        return (self._hist.get(self._key(req))
                or self._hist.get(("global", None)) or [])

    def predict(self, req: Request) -> float:
        return self.quantile(req, 0.5)

    def quantile(self, req: Request, q: float) -> float:
        vals = self._values(req)
        if not vals:
            return self.prior
        q = min(max(q, 0.0), 1.0)
        pos = q * (len(vals) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return max(vals[lo] * (1 - frac) + vals[hi] * frac, 1.0)


class AdversarialPredictor(Predictor):
    """Inverse-rank predictor: strictly decreasing in the true length, so
    predicted-SJF order becomes predicted-*longest*-first.  Exists for the
    regression canary — substituting it must flip the robustness claims."""

    name = "adversarial"

    #: numerator chosen so estimates stay in a plausible token range
    SCALE = 4096.0

    def predict(self, req: Request) -> float:
        return max(self.SCALE / (1.0 + max(req.output_len, 1)), 1.0)


def make_predictor(spec: str, *, seed: int = 0) -> Predictor:
    """Parse a predictor spec string: ``oracle`` | ``noisy<σ>`` (e.g.
    ``noisy0.6``) | ``history`` | ``adversarial``."""
    spec = spec.lower()
    if spec == "oracle":
        return OraclePredictor()
    if spec.startswith("noisy"):
        try:
            sigma = float(spec[len("noisy"):] or 0.6)
        except ValueError:
            raise ValueError(f"bad noisy predictor spec {spec!r}") from None
        return BucketedNoisyPredictor(sigma=sigma, seed=seed)
    if spec == "history":
        return TraceHistoryPredictor()
    if spec == "adversarial":
        return AdversarialPredictor()
    raise ValueError(
        f"unknown predictor {spec!r}; have {PREDICTOR_NAMES}")
