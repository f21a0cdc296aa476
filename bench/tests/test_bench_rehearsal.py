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


#: a model module of another kind, written beside ``models/dense.py`` in a
#: copy: a dense model with its own rehearsal (3 layers, 1 KV head)
TINY_MODEL = '''"""A dense model whose rehearsal runs 3 layers over 1 KV head."""
import sys

from models import dense
from models.dense import (decode_flops, draw, port_config, port_layout,
                          prefill_flops, reference_layout)


def sizes(cf, rehearse):
    c = dense.sizes(cf, rehearse)
    if rehearse:
        c.update(num_layers=3, num_kv_heads=1)
        c["layers"] = [(c["num_heads"], 1, c["head_dim"],
                        c["sliding_window"])] * 3
        print(f"tiny_dense: {len(c['layers'])} layers", file=sys.stderr)
    return c
'''


def tree(root):
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_kind_by_files_alone(tmp_path):
    """A configuration of a model kind the harness has no module for is
    added to a copy of the benchmark by new files and a BENCHMARK.json entry
    alone, and its rehearsal runs and comes out correct; the copy's own tests
    still pass beside it, and no file that was there before is touched.
    Of the copy's tests this runs all but this file and
    ``test_bench_control.py``, which drives one fixed cell."""
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = tree(tmp_path)
    b = tmp_path / "bench"
    (b / "models" / "tiny_dense.py").write_text(TINY_MODEL)
    cf = json.loads((b / "configs" / "mistral_7b.json").read_text())
    (b / "configs" / "tiny_gqa.json").write_text(json.dumps(
        dict(cf, model="tiny_dense")))
    shutil.copy(b / "workloads" / "mistral_7b.azure_overload.json",
                b / "workloads" / "tiny_gqa.azure_overload.json")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny_gqa", "source": cf["source"],
        "file": "bench/configs/tiny_gqa.json", "reduced": [],
        "why": "a model module the harness did not have"})
    bench["workloads"].append({
        "name": "tiny_gqa.azure_overload", "config": "tiny_gqa",
        "traffic": "azure_6_2", "chips": 1, "why": "files alone"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(BENCH.parent / "src"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "tiny_gqa.azure_overload", "--seed",
                        str(2 ** 31 + 23), "--seconds", "2", "--trace", "1",
                        "--rehearse", "1"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert "tiny_dense: 3 layers" in p.stderr
    t = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rA",
                        "-p", "no:cacheprovider", "-p", "no:randomly",
                        "bench/tests",
                        "--ignore=bench/tests/test_bench_rehearsal.py",
                        "--ignore=bench/tests/test_bench_control.py"],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=240)
    assert t.returncode == 0, t.stdout[-3000:] + t.stderr[-2000:]
    assert "PASSED bench/tests/test_bench_models.py::" in t.stdout
    after = tree(tmp_path)
    del before[Path("BENCHMARK.json")]
    assert {k: after[k] for k in before} == before
