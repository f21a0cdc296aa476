"""The frozen traffic generator against the port's, and the run stream's
promise: every seed serves the same sizes and gaps, in another order."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

import traffic
from repro_torch.core.trace import TraceConfig, generate_trace

BENCH = Path(__file__).resolve().parent.parent
MIX = json.loads((BENCH / "traffic" / "azure_6_2.json").read_text())


@pytest.mark.parametrize("over", [
    {}, {"n_requests": 300, "seed": 5, "arrival_rps": 7.5},
    {"n_requests": 64, "long_quantile": 1.0, "seed": 11},
    {"n_requests": 500, "input_sigma": 2.1, "long_low": 1000,
     "long_high": 2000, "output_max": 50, "seed": 2 ** 40 + 3}])
def test_frozen_generator_is_generate_trace(over):
    p = dict(traffic.trace_params(MIX), **over)
    p["n_requests"] = min(p["n_requests"], 2000)
    ins, outs, longs, arr = traffic.azure_trace(p)
    ref = generate_trace(TraceConfig(**p))
    assert [r.input_len for r in ref] == ins.tolist()
    assert [r.output_len for r in ref] == outs.tolist()
    assert [r.is_long for r in ref] == longs.tolist()
    assert [r.arrival for r in ref] == arr.tolist()


def test_every_seed_serves_the_same_blocks_in_another_order():
    a = list(traffic.run_requests(MIX, 10.0, 1))
    b = list(traffic.run_requests(MIX, 10.0, 2 ** 33 + 7))
    assert len(a) == len(b) == MIX["population"]
    assert [x[:3] for x in a] != [x[:3] for x in b]
    blk = MIX["block"]
    for lo in range(0, len(a), blk):
        hi = lo + blk
        assert Counter(x[:3] for x in a[lo:hi]) == \
            Counter(x[:3] for x in b[lo:hi])
        assert a[hi - 1][3] == pytest.approx(b[hi - 1][3], rel=1e-12)
    assert a == list(traffic.run_requests(MIX, 10.0, 1))
    assert all(y[3] >= x[3] for x, y in zip(a, a[1:]))


def test_rate_scales_the_clock_only():
    a = list(traffic.run_requests(MIX, 10.0, 3))
    b = list(traffic.run_requests(MIX, 20.0, 3))
    assert [x[:3] for x in a] == [x[:3] for x in b]
    assert np.allclose([x[3] / 2 for x in a], [x[3] for x in b])


def test_prompts_are_the_seeds_and_capped():
    class R:
        def __init__(self, rid, n, long):
            self.rid, self.input_len, self.is_long = rid, n, long
    p, q = traffic.Prompts(9, 100, 50), traffic.Prompts(9, 100, 50)
    assert len(p(R(0, 30, False))) == 30
    assert len(p(R(1, 900, False))) == 50
    assert len(p(R(2, 10, True))) == 50
    assert (p(R(0, 30, False)) == q(R(0, 30, False))).all()
    assert not (p(R(3, 40, False)) == traffic.Prompts(10, 100, 50)(
        R(3, 40, False))).all()
    assert int(max(t.max() for t in p.tokens.values())) < 100
