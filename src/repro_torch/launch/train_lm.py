"""Train the reference's ~100M-parameter dense LM (``lm-100m``, 75.5M
parameters by count) on synthetic data, the counterpart of the
reference's ``examples/train_lm.py``: the data pipeline
(`SyntheticLMData`), AdamW (lr 1e-3, weight decay 0.01) and a checkpoint
round trip, on the card unless ``--device cpu``.  The loss must fall by
0.3 (the mean of the last 10 steps against the first), as the reference
asserts.

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 200]
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.hardware import resolve_device
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import init_params, param_count
from repro_torch.training import (adamw_init, adamw_update, load_checkpoint,
                                  restore_like, save_checkpoint)
from repro_torch.training.checkpoint import params_equal
from repro_torch.training.data import SyntheticLMData

#: ~100M params; a small vocab so the Markov structure is learnable within a
#: few hundred steps (the reference's example config)
LM_100M = ModelConfig(name="lm-100m", family="dense", num_layers=8,
                      d_model=1024, num_heads=16, num_kv_heads=4,
                      d_ff=2048, vocab_size=2048, dtype="float32")
MIN_DROP = 0.3


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, device,
          log=print) -> Dict[str, Any]:
    """`steps` AdamW steps over `SyntheticLMData` (seed 0) from the port's
    seeded weights.  Returns the losses, gradient norms, params and state."""
    params = init_params(cfg, seed=0, device=device)
    opt = adamw_init(params)
    data = SyntheticLMData(vocab=cfg.vocab_size, seq=seq, batch=batch, seed=0)
    losses: List[float] = []
    norms: List[float] = []
    t0 = time.perf_counter()
    for i, b in zip(range(steps), data):
        tb = {"tokens": torch.from_numpy(b["tokens"]).long().to(device)}
        loss, grads = loss_and_grads(cfg, params, tb, remat=False)
        params, opt, info = adamw_update(params, grads, opt, lr=1e-3,
                                         weight_decay=0.01)
        losses.append(float(loss))
        norms.append(float(info["grad_norm"]))
        if i % 25 == 0 or i == steps - 1:
            dt = time.perf_counter() - t0
            log(f"step {i:4d} loss={losses[-1]:.4f} gnorm={norms[-1]:7.3f} "
                f"tok/s={(i + 1) * batch * seq / max(dt, 1e-9):,.0f}")
    return {"losses": losses, "grad_norms": norms, "params": params, "opt": opt,
            "wall_s": time.perf_counter() - t0}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = LM_100M
    r = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, device=device)
    losses = r["losses"]
    print(f"model: {param_count(r['params']) / 1e6:.1f}M params")
    recent = sum(losses[-10:]) / min(len(losses), 10)
    if not recent < losses[0] - MIN_DROP:
        raise AssertionError(
            f"training must reduce loss ({losses[0]:.2f} -> {recent:.2f})")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.ckpt or tmp
        save_checkpoint(ckpt, r["params"], r["opt"], step=args.steps)
        p2, o2, s2 = load_checkpoint(ckpt)
        equal = (s2 == args.steps
                 and params_equal(restore_like(r["params"], p2), r["params"])
                 and params_equal(restore_like(r["opt"], o2), r["opt"]))
    if not equal:
        raise AssertionError("the checkpoint did not reload equal")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; checkpoint round-trip OK")
    out = {"params": param_count(r["params"]), "steps": args.steps,
           "batch": args.batch, "seq": args.seq, "loss_first": losses[0],
           "loss_last10_mean": recent, "loss_drop": losses[0] - recent,
           "wall_s": r["wall_s"], "checkpoint_equal": equal}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
