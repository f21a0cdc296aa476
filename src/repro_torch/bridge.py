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


def _per_layer(stacked: Dict[str, Any], device) -> list:
    """A tree whose every leaf has a leading L axis -> one tree per layer
    (nested dicts, such as moe's "shared", sliced alike)."""
    n = len(np.asarray(stacked["ln1" if "ln1" in stacked else "ln"]))
    return [_leaves(stacked, lambda a, i=i: _tensor(a[i], device))
            for i in range(n)]


def params_from_jax(tree: Dict[str, Any], *, device="cuda") -> Dict[str, Any]:
    """The reference's tree -> the port's params, each leaf keeping its
    dtype (so moe's router stays f32).  {"embed", "final_norm", "lm_head",
    "layers": {...} with a leading L axis on every leaf} [+ "shared": {...}
    unstacked (hybrid)] [+ "encoder": {...} stacked and "enc_norm" (audio)];
    "layers" and "encoder" become one dict per layer."""
    p = {name: _tensor(tree[name], device)
         for name in ("embed", "final_norm", "lm_head", "enc_norm") if name in tree}
    for name in ("layers", "encoder"):
        if name in tree:
            p[name] = _per_layer(tree[name], device)
    if "shared" in tree:
        p["shared"] = _leaves(tree["shared"], lambda a: _tensor(a, device))
    return p
