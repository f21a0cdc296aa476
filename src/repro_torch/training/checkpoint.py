"""Checkpoints in the reference's file format (``repro/training/
checkpoint.py``): ``params.npz`` and ``opt.npz``, one array per leaf under
its "/"-joined path in the reference's STACKED layout (``layers/attn/wq``,
``moments/layers/mlp/w_gate/m``, ``step``), and ``meta.json`` with the
step.  A checkpoint written by either package loads in the other.

bf16 leaves are written and read as their 2-byte payload (``|V2``), byte
for byte what the reference's ``np.savez`` writes for a bf16 array, so no
``ml_dtypes`` is needed.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.bridge import _tensor, params_to_numpy


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A numpy tree -> {path: array}, dict keys in sorted order as JAX
    walks them."""
    if isinstance(tree, dict):
        out: Dict[str, np.ndarray] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def save_checkpoint(path: str, params, opt_state, *, step: int) -> None:
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "params.npz", **_flatten(params_to_numpy(params)))
    np.savez(d / "opt.npz", **_flatten(params_to_numpy(opt_state)))
    (d / "meta.json").write_text(json.dumps({"step": step}))


def load_checkpoint(path: str) -> Tuple[dict, Any, int]:
    """Returns (params_flat, opt_flat, step): flat {path: array} mappings;
    `restore_like` re-attaches them to a tree."""
    d = Path(path)
    params = dict(np.load(d / "params.npz"))
    opt = dict(np.load(d / "opt.npz"))
    step = json.loads((d / "meta.json").read_text())["step"]
    return params, opt, step


def restore_like(template, flat: dict):
    """A tree with `template`'s structure (params or AdamWState), each leaf
    from `flat` on the template leaf's device and in its dtype: a leaf in
    a per-layer list takes its layer's slice of the stacked array."""
    def build(t, key, index):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f), f"{key}{f}/", index)
                             for f in t._fields))
        if isinstance(t, dict):
            return {k: build(v, f"{key}{k}/", index) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, key, index + (i,)) for i, v in enumerate(t)]
        a = flat[key[:-1]]
        for i in index:
            a = a[i]
        x = _tensor(a, t.device)
        return x if x.dtype == t.dtype else x.to(t.dtype)
    return build(template, "", ())


def params_equal(a, b) -> bool:
    """Whether two trees hold equal tensors, leaf for leaf."""
    fa, fb = _flatten(params_to_numpy(a)), _flatten(params_to_numpy(b))
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and fa[k].tobytes() == fb[k].tobytes() for k in fa)
