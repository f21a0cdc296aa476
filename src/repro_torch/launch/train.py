"""Training launcher, the counterpart of the reference's
``launch/train.py``: ``--arch <id>`` trains a reduced f32 config (the
default, as the reference) or, with ``--full``, the full config in its own
dtype, on the card unless ``--device cpu``.  ``--layers N`` cuts the depth
(of the reduced config, or of the full one at full width) and is printed.
Each step is `steps.build_train_step` over a host mesh
(`launch/mesh.make_host_mesh`: every visible card, or the CPU), as the
reference's launcher jits it over its mesh: the loss with remat over the
plain PyTorch attention and SSD, its gradients, one AdamW update.  On a
mesh of more than one rank the step is the partitioned FSDP step (every
family: `models/tp.FAMILIES`): the params, the optimizer state and each
batch are cut by ``shardings.param_specs(fsdp=True)``, `opt_specs` and
`batch_specs`.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mistral_7b --full
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b --device cpu --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import PORTED_ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.hardware import H100_SXM, resolve_device
from repro_torch.launch import partition
from repro_torch.launch import shardings as shd
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params, param_count
from repro_torch.training import adamw_init


def make_batch(cfg: ModelConfig, batch: int, seq: int, rng: np.random.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The reference's train batch, drawn in its order: random tokens
    (batch, seq); vlm "embeds" and audio "frames" (batch, frontend_tokens,
    d_model), standard normal in the model's dtype; labels the tokens
    shifted left, the last -1."""
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)))
    out = {"tokens": tokens.to(device)}
    for fam, name in (("vlm", "embeds"), ("audio", "frames")):
        if cfg.family == fam:
            out[name] = torch.from_numpy(rng.normal(
                size=(batch, cfg.frontend_tokens, cfg.d_model))).to(
                    device, getattr(torch, cfg.dtype))
    out["labels"] = torch.nn.functional.pad(out["tokens"][:, 1:], (0, 1), value=-1)
    return out


def step_flops(cfg: ModelConfig, params, batch: int, seq: int) -> Optional[float]:
    """Operations of one train step of a decoder-only model (dense, vlm):
    6 x N x tokens, N the parameters that enter a matmul (all but the
    embedding table), plus the attention's 12 x H x hd per visible (query,
    key) pair per layer (forward 4, backward 8).  None for other families
    (moe: the reference has no count to hold one against)."""
    if cfg.family not in ("dense", "vlm"):
        return None
    S = seq + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    n = param_count(params) - params["embed"].numel()
    w = cfg.sliding_window or S
    pairs = sum(min(i + 1, w) for i in range(S))
    return (6.0 * n * batch * S
            + 12.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim * pairs * batch)


def train(cfg: ModelConfig, params, *, steps: int, batch: int, seq: int, device,
          same_batch: bool = False, seed: int = 0, mesh=None,
          log=print) -> Dict[str, Any]:
    """`steps` train steps; a fresh batch each step (the reference's loop)
    or, with `same_batch`, the first one repeated; on a `mesh` of more
    than one rank partitioned (module doc), the params' pieces updated in
    place.  Returns the losses, gradient norms and wall seconds of each
    step (to the device's end), the params and the optimizer state (whole
    tensors)."""
    opt = adamw_init(params)
    step_fn = st.build_train_step(cfg, remat=True, mesh=mesh)
    rng = np.random.default_rng(seed)
    sharded = mesh is not None and mesh.n_ranks > 1
    if sharded:
        pspecs = shd.param_specs(cfg, params, mesh, fsdp=True)
        params = partition.shard_tree(params, pspecs, mesh)
        opt = partition.shard_tree(opt, shd.opt_specs(pspecs, opt), mesh)
        bspecs = shd.batch_specs(cfg, ShapeConfig("train", seq, batch, "train"), mesh)
    data = make_batch(cfg, batch, seq, rng, device)
    losses: List[float] = []
    norms: List[float] = []
    secs: List[float] = []
    for i in range(steps):
        if i and not same_batch:
            data = make_batch(cfg, batch, seq, rng, device)
        t0 = time.perf_counter()
        params, opt, info = step_fn(
            params, opt, partition.shard_tree(data, bspecs, mesh) if sharded else data)
        losses.append(float(info["loss"]))                 # waits for the card
        norms.append(float(info["grad_norm"]))
        secs.append(time.perf_counter() - t0)
        log(f"step {i:3d} loss={losses[-1]:.4f} gnorm={norms[-1]:.3f} "
            f"({secs[-1]:.3f} s)")
    if sharded:
        params, opt = partition.unshard_tree(params), partition.unshard_tree(opt)
    return {"losses": losses, "grad_norms": norms, "step_s": secs,
            "params": params, "opt": opt}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=PORTED_ARCH_IDS)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="the FULL config in its own dtype (default: reduced, f32)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: keep it)")
    ap.add_argument("--same-batch", action="store_true",
                    help="repeat the first batch every step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    full = get_config(args.arch)
    if args.full:
        cfg = (dataclasses.replace(full, num_layers=args.layers) if args.layers
               else full)
    else:
        cfg = dataclasses.replace(reduced_config(full, layers=args.layers or 2),
                                  dtype="float32")
    cut = (f", {cfg.num_layers} of {full.num_layers} layers"
           if args.full and cfg.num_layers != full.num_layers else "")
    mesh = make_host_mesh(devices=None if device.type == "cuda" else [device])
    print(f"training {cfg.name} ({cfg.num_layers}L d={cfg.d_model} {cfg.dtype}"
          f"{cut}) on {device}, mesh {mesh.shape} ({mesh.n_ranks} devices)")
    params = init_params(cfg, seed=0, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    r = train(cfg, params, steps=args.steps, batch=args.batch, seq=args.seq,
              device=device, same_batch=args.same_batch, mesh=mesh)
    wall = time.perf_counter() - t0
    timed = r["step_s"][1:] or r["step_s"]       # the first step warms up
    step_s = statistics.median(timed)
    flops = step_flops(cfg, r["params"], args.batch, args.seq)
    out = {"arch": args.arch, "layers": cfg.num_layers,
           "layers_full": full.num_layers, "d_model": cfg.d_model,
           "dtype": cfg.dtype, "params": param_count(r["params"]),
           "batch": args.batch, "seq": args.seq, "steps": args.steps,
           "losses": r["losses"], "grad_norms": r["grad_norms"],
           "step_s": step_s, "tokens_per_s": args.batch * args.seq / step_s,
           "wall_s": wall,
           "mfu": (flops / step_s / H100_SXM.flops
                   if flops is not None and device.type == "cuda" else None),
           "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                       if device.type == "cuda" else None)}
    print(f"{args.steps} steps in {wall:.1f}s")
    print(json.dumps(out))
    out["params_tree"], out["opt"] = r["params"], r["opt"]
    return out


if __name__ == "__main__":
    main()
