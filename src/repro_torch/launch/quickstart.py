"""Quickstart: build a ported architecture, run a forward pass, prefill and
greedily decode a few tokens through the model's serving API, and show the
PecSched SP planner for attention models.  By default it runs the FULL
config in bf16 on the card (random weights from a seed); ``--device cpu
--layers N`` runs a reduced f32 model on the CPU.  vlm models get seeded
patch embeddings before the prompt, audio models seeded encoder frames
and a BOS-only decoder prompt (the frontends are stubs, as in the
reference).

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

#: the decoder's start token for audio (the reference names no id)
BOS = 0


def make_prompt(cfg: ModelConfig, batch: int, prompt_len: int, *,
                seed: int = 0, device="cpu") -> torch.Tensor:
    """Random prompt tokens (batch, prompt_len) from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=g).to(device)


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int, *,
               seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """The model's inputs, as the reference's quickstart draws them: tokens
    (batch, prompt_len) from `make_prompt`; vlm adds "embeds" and audio
    "frames" (batch, frontend_tokens, d_model), standard normal from a CPU
    generator seeded seed + 1; audio's decoder prompt is BOS alone (batch,
    1), as `models.prefill` expects."""
    if cfg.family == "audio":
        out = {"tokens": torch.full((batch, 1), BOS, device=device)}
    else:
        out = {"tokens": make_prompt(cfg, batch, prompt_len, seed=seed,
                                     device=device)}
    if cfg.family in ("vlm", "audio"):
        g = torch.Generator().manual_seed(seed + 1)
        out["embeds" if cfg.family == "vlm" else "frames"] = torch.randn(
            (batch, cfg.frontend_tokens, cfg.d_model), generator=g).to(device)
    return out


def start(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], n_new: int
          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """init_cache (room for the prefill's positions and n_new more) +
    prefill, moe with the dropless capacity factor E: (last-token logits
    (B, V), the filled cache)."""
    tokens = batch["tokens"]
    n = tokens.shape[1] + (batch["embeds"].shape[1] if "embeds" in batch else 0)
    enc_len = batch["frames"].shape[1] if "frames" in batch else 0
    cache = init_cache(cfg, tokens.shape[0], n + n_new, enc_len=enc_len,
                       device=tokens.device)
    cf = float(cfg.num_experts) if cfg.family == "moe" else None
    return prefill(cfg, params, batch, cache, moe_cf=cf)


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
    batch = make_batch(cfg, args.batch, args.prompt_len, seed=0, device=device)
    logits, _ = forward(cfg, params, batch)
    finite = bool(torch.isfinite(logits).all())
    print(f"forward: logits {tuple(logits.shape)}, finite={finite}")

    lg, cache = start(cfg, params, batch, args.tokens)
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
