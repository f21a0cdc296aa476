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


def params_from_jax(tree: Dict[str, Any], *, device="cuda") -> Dict[str, Any]:
    """{"embed", "final_norm", "lm_head", "layers": {"attn": {...},
    "mlp": {...}, "ln1", "ln2"} with leading L} -> the port's dense params."""
    layers = tree["layers"]
    n_layers = np.asarray(layers["ln1"]).shape[0]

    def layer(i: int) -> Dict[str, Any]:
        return {"attn": {k: _tensor(np.asarray(v)[i], device)
                         for k, v in layers["attn"].items()},
                "mlp": {k: _tensor(np.asarray(v)[i], device)
                        for k, v in layers["mlp"].items()},
                "ln1": _tensor(np.asarray(layers["ln1"])[i], device),
                "ln2": _tensor(np.asarray(layers["ln2"])[i], device)}
    return {"embed": _tensor(tree["embed"], device),
            "final_norm": _tensor(tree["final_norm"], device),
            "lm_head": _tensor(tree["lm_head"], device),
            "layers": [layer(i) for i in range(n_layers)]}
