"""Weight bridge: the reference's parameter tree, as numpy arrays, into the
port's parameters.

The reference stacks every per-layer weight on a leading L axis and stores
linear weights as (in, out); the port keeps (in, out) and holds one dict per
layer, so conversion slices the L axis and copies.  This module takes numpy
only: the caller converts the reference's arrays (``np.asarray`` on each
leaf), which keeps the port free of any import of the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # numpy has no native bf16
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a private, writable copy


def _leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    return fn(np.asarray(tree))


def params_from_jax(tree: Dict[str, Any], *, device="cuda") -> Dict[str, Any]:
    """The reference's tree -> the port's params, each leaf keeping its
    dtype.  {"embed", "final_norm", "lm_head", "layers": {...} with a
    leading L axis on every leaf} [+ "shared": {...} unstacked (hybrid)];
    "layers" holds {"attn", "mlp", "ln1", "ln2"} (dense) or {"mamba", "ln"}
    (ssm, hybrid) and becomes one dict per layer."""
    layers = tree["layers"]
    n_layers = len(np.asarray(layers["ln1" if "ln1" in layers else "ln"]))
    p = {name: _tensor(tree[name], device)
         for name in ("embed", "final_norm", "lm_head")}
    p["layers"] = [_leaves(layers, lambda a, i=i: _tensor(a[i], device))
                   for i in range(n_layers)]
    if "shared" in tree:
        p["shared"] = _leaves(tree["shared"], lambda a: _tensor(a, device))
    return p
