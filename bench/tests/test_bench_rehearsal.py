"""`bench/run.py` end to end on the CPU at its tiny float32 size, and its
refusals: no result without a card, none for an unknown cell."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def bench_run(*args, timeout=240):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                          cwd=BENCH.parent, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("cell,trace", [("mistral_7b.azure_overload", "0"),
                                        ("phi3_14b.azure_overload", "1")])
def test_rehearsal_last_line_parses(cell, trace):
    p = bench_run("--workload", cell, "--seed", str(2 ** 31 + 5),
                  "--seconds", "2", "--trace", trace, "--rehearse", "1")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert KEYS <= set(out) and list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert out["device"]["platform"] == "cpu"
    names = set(out["metrics"])
    if trace == "0":
        assert names == {"short_rps", "setup_s"}
    else:               # the device trace's metrics need a card to read
        assert {"sched.short_qd_p90_ms", "backend.decode_tokens_per_iter",
                "engine.decode_ms_per_iter"} <= names
        assert not names & {"flash_attention_roofline", "step_mfu",
                            "device.idle_share"}
    # the compared numbers close standard error, each beside its limit
    tail = p.stderr.strip().splitlines()[-2:]
    assert [t.split(":")[0] for t in tail] == [
        "compared served_logit_gap", "compared failed_requests"]


def test_no_card_no_result():
    p = bench_run("--workload", "mistral_7b.azure_overload", "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_unknown_cell_no_result():
    p = bench_run("--workload", "nope", "--seed", "1", "--seconds", "1",
                  "--trace", "0", "--rehearse", "1")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and bench/ (no program)."""
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "mistral_7b.azure_overload", "--seed", "1", "--seconds",
                        "1", "--trace", "0", "--rehearse", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
