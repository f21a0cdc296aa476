"""Weight bridge between the reference's parameter tree, as numpy arrays,
and the port's parameters.

The reference stacks every per-layer weight on a leading L axis and stores
linear weights as (in, out); the port keeps (in, out) and holds one dict per
layer, so conversion slices the L axis and copies (`params_from_jax`) or
stacks the per-layer trees back (`params_to_numpy`, also for gradients and
the optimizer state).
This module takes and gives numpy only: the caller converts the reference's
arrays (``np.asarray`` on each leaf), which keeps the port free of any
import of the reference.

bf16 leaves travel as their raw 2-byte payload, a ``|V2`` array, which is
what ``np.savez`` writes and ``np.load`` reads back for the reference's
bf16 arrays; numpy itself has no bf16.  `_tensor` also takes an
``ml_dtypes`` bfloat16 array, the reference's own ``np.asarray``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):                         # the bits, as they are
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)   # a private, writable copy


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host; bf16 as its ``|V2`` payload."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


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


def params_to_numpy(tree) -> Any:
    """The port's params, gradients or AdamWState -> the reference's
    layout as numpy, the inverse of `params_from_jax`: dicts stay dicts, a
    list of per-layer trees becomes one tree stacked on a leading axis
    (so an optimizer moment of a per-layer leaf becomes the reference's
    moment of the stacked leaf), a NamedTuple a dict of its fields (the
    reference's ``tree_leaves_with_path`` names them so)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: params_to_numpy(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack([params_to_numpy(v) for v in tree])
    return _numpy(tree)


def _stack(items: list):
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)
