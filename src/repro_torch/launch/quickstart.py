"""Quickstart: build a ported architecture, run a forward pass, prefill and
greedily decode a few tokens through the model's serving API, and show the
PecSched SP planner for attention models.  By default it runs the FULL
config in bf16 on the card (random weights from a seed); ``--device cpu
--layers N`` runs a reduced f32 model on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --arch zamba2_2_7b
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu --layers 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import PORTED_ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.hardware import resolve_device
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.sp.planner import plan_fast_sp


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int, *,
                seed: int = 0, device="cpu") -> torch.Tensor:
    """Random prompt tokens (batch, prompt_len) from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=g).to(device)


def start(cfg: ModelConfig, params, prompt: torch.Tensor, max_len: int
          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """init_cache + prefill: (last-token logits (B, V), the filled cache)."""
    cache = init_cache(cfg, prompt.shape[0], max_len, device=prompt.device)
    return prefill(cfg, params, {"tokens": prompt}, cache)


def greedy(cfg: ModelConfig, params, cache: Dict[str, Any],
           logits: torch.Tensor, n_tokens: int
           ) -> Tuple[List[torch.Tensor], bool]:
    """The argmax of `logits`, then n_tokens - 1 greedy decode steps.
    Returns one (B,) tensor per generated token, and whether every logit
    seen (the given ones and each step's) was finite."""
    toks = [logits.argmax(-1)]
    finite = torch.isfinite(logits).all()
    for _ in range(n_tokens - 1):
        logits, cache = decode_step(cfg, params, cache, toks[-1])
        finite &= torch.isfinite(logits).all()
        toks.append(logits.argmax(-1))
    return toks, bool(finite)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b", choices=PORTED_ARCH_IDS)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="reduced f32 config with this many layers "
                         "(0 = the full config in its own dtype)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    full = get_config(args.arch)
    cfg = full
    if args.layers:
        cfg = dataclasses.replace(reduced_config(full, layers=args.layers),
                                  dtype="float32")
    print(f"arch={full.name} family={full.family} "
          f"params(full)={full.param_count() / 1e9:.2f}B "
          f"[run: {cfg.num_layers}L d={cfg.d_model} {cfg.dtype} on {device}]")
    params = init_params(cfg, seed=0, device=device)
    prompt = make_prompt(cfg, args.batch, args.prompt_len, seed=0, device=device)
    logits, _ = forward(cfg, params, {"tokens": prompt})
    finite = bool(torch.isfinite(logits).all())
    print(f"forward: logits {tuple(logits.shape)}, finite={finite}")

    lg, cache = start(cfg, params, prompt, args.prompt_len + args.tokens)
    toks, decode_finite = greedy(cfg, params, cache, lg, args.tokens)
    gen = torch.stack(toks, 1).tolist()
    print(f"greedy decode ({args.tokens} tokens): {gen}, "
          f"finite={decode_finite}")
    out: Dict[str, Any] = {"arch": args.arch,
                           "logits_finite": finite and decode_finite,
                           "generated": gen}

    # the paper's §5.3 planner on the FULL config
    if not full.attention_free:
        plan = plan_fast_sp(full, 262144, n_nodes=16, gpus_per_node=16, tp=16)
        print(f"fast-SP plan for 256K prefill on 16x16 chips: "
              f"attn={plan.attn_strategy} mlp={plan.mlp_strategy} "
              f"~{plan.est_time * 1e3:.1f} ms/layer")
        out["plan"] = [plan.attn_strategy, plan.mlp_strategy]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
