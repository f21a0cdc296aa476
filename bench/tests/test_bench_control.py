"""The check's control and planted faults, through the harness at its tiny
CPU size: the run itself passes, and each of these comes out not correct.

* the control: the reference in fp8 (the step below the configuration's
  bf16) in the program's place, read at the served positions, through the
  run's own comparison;
* a token altered where the decode step produces it;
* a prefill step that hands its state back unchanged (a layer's residual
  update dropped, its KV kept);
* half of a decode batch, rounded up, left out (its lanes repeat their
  last token);
* a request served one token short of its target (the backend's own count
  of the target lowered by one).

On the card the control was read at the cells' own sizes (bench/limits.py;
PERF.md gives the readings).
"""
import json
from pathlib import Path

import pytest

import run
from repro_torch.serving.backend import EngineBackend
from repro_torch.serving.engine import ReplicaEngine

BENCH = Path(__file__).resolve().parent.parent
CELL = "mistral_7b.azure_overload"


def limit():
    own = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    return own["check"]["served_gap_limit"]


def serve(**kw):
    return run.serve(CELL, 2 ** 31 + 11, 2.0, False, rehearse=True, **kw)


def test_program_passes_and_control_fails():
    out = serve(control=True)
    assert out["failed"] == 0 and out["info"]["program_gap"] <= limit()
    assert out["correct"] is False
    assert out["compared"]["served_logit_gap"]["value"] > limit()
    assert out["compared"]["served_logit_gap"]["value"] == \
        out["info"]["served_gap"]


def test_one_token_short_is_not_correct(monkeypatch):
    orig = EngineBackend._target_new
    monkeypatch.setattr(EngineBackend, "_target_new",
                        lambda self, req: max(1, orig(self, req) - 1))
    out = serve()
    assert out["correct"] is False
    assert out["failed"] > 0 and out["info"]["failures"]["token_count"] > 0
    assert out["compared"]["failed_requests"]["value"] == out["failed"]


def altered_token(orig):
    def step(self, tokens):
        return {s: (t + 1) % self.cfg.vocab_size
                for s, t in orig(self, tokens).items()}
    return "decode_iteration", step


def unchanged_state(orig):
    def quantum(self, st):
        x, lo = st.x, st.layer
        st, done = orig(self, st)
        if lo == 0:
            st.x = x
        return st, done
    return "prefill_quantum", quantum


def half_batch(orig):
    def step(self, tokens):
        out = orig(self, tokens)
        kept = sorted(tokens)[: len(tokens) // 2]    # a lone lane: left out
        return {s: (t if s in kept else tokens[s]) for s, t in out.items()}
    return "decode_iteration", step


@pytest.mark.parametrize("fault", [altered_token, unchanged_state,
                                   half_batch])
def test_fault_is_not_correct(monkeypatch, fault):
    name, fn = fault(getattr(ReplicaEngine, name_of(fault)))
    monkeypatch.setattr(ReplicaEngine, name, fn)
    out = serve()
    assert out["correct"] is False
    assert out["compared"]["served_logit_gap"]["value"] > limit()


def name_of(fault):
    return fault(lambda *a: None)[0]
