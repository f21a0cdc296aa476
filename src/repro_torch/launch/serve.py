"""Serving launcher: the PecSched mini-cluster over a synthetic request
stream.  By default it serves the FULL model config in bf16 on the card
(random weights from a seed); ``--device cpu --layers N`` runs a reduced f32
model on the CPU for small local runs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral_7b --n 24
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --layers 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs import PORTED_ARCH_IDS, get_config, reduced_config
from repro_torch.core.schedulers import POLICY_NAMES
from repro_torch.hardware import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import MiniCluster, ServeRequest

MAX_LEN = 2048          # engine context: longs of 1024-1536 tokens fit
MAX_NEW = 16


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral_7b", choices=PORTED_ARCH_IDS)
    ap.add_argument("--policy", default="pecsched", choices=POLICY_NAMES)
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="reduced f32 config with this many layers "
                         "(0 = the full config in its own dtype)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(reduced_config(cfg, layers=args.layers),
                                  dtype="float32")
    params = init_params(cfg, seed=0, device=device)
    mc = MiniCluster(cfg, params, n_engines=args.engines, policy=args.policy,
                     max_len=MAX_LEN, long_threshold=MAX_LEN // 4,
                     device=device)
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(args.n):
        t += float(rng.exponential(0.05))
        is_long = i % 6 == 5
        slen = (int(rng.integers(MAX_LEN // 2, MAX_LEN * 3 // 4)) if is_long
                else int(rng.integers(32, MAX_LEN // 8)))
        mc.submit(ServeRequest(rid=i, arrival=t, max_new=MAX_NEW,
                               is_long=is_long,
                               tokens=rng.integers(0, cfg.vocab_size,
                                                   slen).astype(np.int32)))
    mc.run()
    print(json.dumps(mc.metrics()))


if __name__ == "__main__":
    main()
