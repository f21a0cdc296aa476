"""The end-to-end arithmetic on hand-made stamps."""
from types import SimpleNamespace

import pytest

import run
import stats


def req(rid, arrival, start, first, finish, long=False):
    return SimpleNamespace(rid=rid, arrival=arrival, prefill_start=start,
                           first_token=first, finish=finish, is_long=long)


REQS = [req(0, 0.0, 0.0, 0.1, 0.3), req(1, 0.1, 0.2, 0.4, 0.5),
        req(2, 0.2, 0.5, 0.6, 1.2), req(3, 0.3, 0.3, 0.9, 2.5, long=True),
        req(4, 0.4, 1.4, 1.5, 1.6), req(5, 1.0, 1.1, 1.3, 1.4, long=True)]


def test_percentile_interpolates_between_order_statistics():
    assert stats.percentile([], 90) is None
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([0, 10, 20, 30, 40], 90) == pytest.approx(36.0)
    assert stats.percentile(list(range(11)), 50) == 5.0


def test_end_to_end_readers():
    r = SimpleNamespace(requests=REQS, window_end=1.25, setup_s=3.5)
    qd = [0.0, 0.1, 0.3, 1.0]               # the shorts 0, 1, 2, 4
    assert run.load_reader("sched.short_qd_p90_ms")(r) == pytest.approx(
        stats.percentile(qd, 90) * 1e3)
    assert stats.percentile(qd, 90) == pytest.approx(0.79)
    assert stats.short_ttft_s(REQS) == pytest.approx([0.1, 0.3, 0.4, 1.1])
    assert stats.long_jct_s(REQS) == pytest.approx([2.2, 0.4])
    # shorts finished by the window's end (1.25 s): 0, 1 and 2
    assert run.load_reader("short_rps")(r) == pytest.approx(3 / 1.25)
    assert run.load_reader("setup_s")(r) == 3.5
    s = stats.summary(qd)
    assert s["n"] == 4 and s["p90"] == pytest.approx(0.79)
    assert s["mean"] == pytest.approx(0.35)


def test_failures_count_each_request_once_by_its_first_cause():
    reqs = [req(0, 0.0, 0.1, 0.2, 0.3),                 # sound
            req(1, 0.0, 0.1, 0.2, None),                # unfinished
            req(2, 0.0, 0.1, 0.2, 0.3),                 # 1 token short
            req(3, 0.0, 0.1, 0.2, 0.3),                 # out of vocab
            req(4, 0.5, 0.1, 0.2, 0.3),                 # starts before arrival
            req(5, 0.0, 0.3, 0.2, 0.4),                 # first token first
            req(6, 0.0, 0.1, 0.2, 0.15)]                # finishes too early
    gen = {0: [1, 2], 1: [1, 2], 2: [1], 3: [1, 9], 4: [1, 2], 5: [3, 4],
           6: [5, 6]}
    f = stats.failures(reqs, gen, lambda r: 2, vocab=8)
    assert f == {"unfinished": 1, "token_count": 1, "out_of_vocab": 1,
                 "stamps": 3}
    assert stats.stamps_in_order(reqs[0])
    assert not stats.stamps_in_order(req(7, 0.0, None, 0.2, 0.3))
