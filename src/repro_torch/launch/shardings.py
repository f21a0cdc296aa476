"""Sharding specs for params, optimizer state, batches and caches, the
counterpart of the reference's ``launch/shardings.py``, over a `GangMesh`.

Profiles (the reference's DESIGN.md §5):
  train   — batch over (pod,data); TP over "model"; fsdp weight+optimizer
            sharding over (pod,data).
  prefill — batch over (pod,data); TP over "model"; fsdp only when the
            TP-sharded weights alone would not fit a device.
  decode  — batch over (pod,data) (seq over them instead when B == 1);
            KV-cache *sequence* sharded over "model"; TP weights over
            "model".

The reference stacks each per-layer weight on a leading L axis; the port
holds one tensor per layer under "layers" and "encoder".  A per-layer
leaf's spec is the reference's spec of the stacked leaf with its leading
None dropped, and byte totals sum every layer's leaf.  The port has no
``NamedSharding``: `shard_shapes` gives each leaf's per-device shape, as
``NamedSharding.shard_shape`` does, and `per_device_bytes` their bytes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.sharding import P, PartitionSpec, divides
from repro_torch.sp.common import as_axes
from repro_torch.training.optimizer import STACKED, AdamWState

#: one NVIDIA H100 80GB HBM3's memory (the reference sizes against 16e9, a
#: TPU v5e's)
HBM_PER_DEVICE = 80e9


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _ax(axes):
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def needs_fsdp(cfg: ModelConfig, mesh, kind: str) -> bool:
    if kind == "train":
        return True
    tp = mesh.shape["model"]
    weight_bytes = cfg.param_count() * 2
    # serving: keep TP-sharded weights under ~40% of a device so the KV
    # cache and transients have headroom; larger models go weight-sharded
    return weight_bytes / tp > 0.4 * HBM_PER_DEVICE


def walk(fn, tree, *others, path: Tuple = (), n_stack: int = 0):
    """``fn(path, leaf, n_stack, *others' leaves at that place)`` over a tree
    of dicts, NamedTuples and lists with tensor or spec leaves, rebuilt in
    its structure.  A list under a STACKED key ("layers", "encoder") is the
    reference's stacked axis: its leaves get n_stack = its length."""
    if isinstance(tree, dict):
        return {k: walk(fn, v, *(o[k] for o in others), path=path + (k,),
                        n_stack=(len(v) if k in STACKED and isinstance(v, list)
                                 else n_stack))
                for k, v in tree.items()}
    if isinstance(tree, PartitionSpec) or torch.is_tensor(tree):
        return fn(path, tree, n_stack, *others)
    if hasattr(tree, "_fields"):
        return type(tree)(*(walk(fn, getattr(tree, f), *(getattr(o, f) for o in others),
                                 path=path + (f,), n_stack=n_stack)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk(fn, v, *(o[i] for o in others), path=path + (i,),
                               n_stack=n_stack) for i, v in enumerate(tree))
    raise TypeError(f"walk: unexpected node {type(tree).__name__} at {path}")


def _param_spec(name: str, shape, mesh, ba) -> PartitionSpec:
    """The reference's spec of a leaf of `shape`, stacked (L, ...) or not."""
    nd = len(shape)

    def m(dim):  # "model" if the dim is shardable
        return "model" if divides(mesh, shape[dim], "model") else None

    def f(dim):  # fsdp axis if shardable
        return ba if (ba and divides(mesh, shape[dim], ba)) else None

    if name == "embed":
        return P(m(0), f(1))
    if name == "lm_head":
        return P(f(0), m(1))
    if name in ("wq", "wk", "wv"):
        return P(None, f(1), m(2)) if nd == 3 else P(f(0), m(1))
    if name == "wo":
        return P(None, m(1), f(2)) if nd == 3 else P(m(0), f(1))
    if name in ("bq", "bk", "bv"):
        return P(None, m(1)) if nd == 2 else P(m(0))
    if name in ("w_gate", "w_up", "w_down"):
        if nd == 4:   # MoE experts (L, E, a, b): expert-parallel on model
            return P(None, m(1), f(2), None)
        if nd == 3:
            if name == "w_down":
                return P(None, m(1), f(2))
            return P(None, f(1), m(2))
        if name == "w_down":
            return P(m(0), f(1))
        return P(f(0), m(1))
    if name == "router":
        return P(None, None, m(2)) if nd == 3 else P(None, m(1))
    if name == "in_proj":   # mamba: model-replicated (heads not divisible)
        return P(None, f(1), None) if nd == 3 else P(f(0), None)
    if name == "out_proj":
        return P(None, None, f(2)) if nd == 3 else P(None, f(1))
    return P(*([None] * nd))   # norms, conv, A_log, D, dt_bias...


def param_specs(cfg: ModelConfig, params, mesh, *, fsdp: bool) -> Any:
    """A spec tree matching the params tree (`steps.params_structs`)."""
    ba = _ax(batch_axes(mesh)) if fsdp else None

    def spec(path, x, n_stack):
        if n_stack:
            return P(*_param_spec(path[-1], (n_stack,) + tuple(x.shape), mesh, ba)[1:])
        return _param_spec(path[-1], tuple(x.shape), mesh, ba)
    return walk(spec, params)


def opt_specs(pspecs, opt_state: AdamWState) -> AdamWState:
    """AdamW state: moments mirror the param specs; factored vr/vc drop the
    factored dim from the param spec (the port's optimizer decides
    factoring, on the stacked size); step replicated."""
    def leaf(path, spec, n_stack, mom):
        if "v" in mom:
            return {"m": spec, "v": spec}
        parts = list(spec) + [None] * (mom["m"].dim() - len(spec))
        return {"m": spec, "vr": P(*parts[:-1]), "vc": P(*(parts[:-2] + parts[-1:]))}
    return AdamWState(step=P(), moments=walk(leaf, pspecs, opt_state.moments))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, PartitionSpec]:
    ba = _ax(batch_axes(mesh))
    B = shape.global_batch
    bspec = ba if (ba and divides(mesh, B, ba)) else None
    seq_axes = None
    if B == 1:  # long-context: shard the sequence instead
        seq_axes = _ax(batch_axes(mesh) + ("model",))
    out: Dict[str, PartitionSpec] = {}
    if shape.kind in ("train", "prefill"):
        tok_seq = seq_axes if seq_axes else None
        out["tokens"] = P(bspec, tok_seq)
        if shape.kind == "train":
            out["labels"] = P(bspec, tok_seq)
        if cfg.family == "vlm":
            out["embeds"] = P(bspec, None, None)
        if cfg.family == "audio":
            out["frames"] = P(bspec, tok_seq, None)
    else:  # decode: one token per sequence
        out["token"] = P(bspec)
    return out


def cache_specs(cfg: ModelConfig, cache, mesh, *, global_batch: int) -> Any:
    """KV caches: batch over (pod,data), SEQUENCE over 'model'. B==1 ->
    sequence over everything."""
    ba = batch_axes(mesh)
    bspec = _ax(ba) if divides(mesh, global_batch, _ax(ba)) else None
    seq = _ax(ba + ("model",)) if global_batch == 1 else "model"

    def spec(path, x, n_stack):
        name = path[-1] if path else ""
        shape = x.shape
        if name in ("k", "v", "sh_k", "sh_v", "cross_k", "cross_v"):
            # (L, B, KV, S, hd)
            s_ax = seq if divides(mesh, shape[3], seq) else None
            return P(None, bspec, None, s_ax, None)
        if name in ("len", "cross_len"):
            return P(bspec)
        if name == "conv":      # (L, B, K, Cd)
            return P(None, bspec, None, None)
        if name == "ssm":       # (L, B, nh, hd, ns)
            return P(None, bspec, None, None, None)
        return P(*([None] * len(shape)))
    return walk(spec, cache)


def shard_shape(shape, spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """One device's block of a tensor of `shape` under `spec`, as
    ``NamedSharding(mesh, spec).shard_shape(shape)``; raises where an
    axis does not divide its dim."""
    out = []
    for i, dim in enumerate(shape):
        size = mesh.axis_size(spec[i]) if i < len(spec) else 1
        if dim % size:
            raise ValueError(f"shard_shape: dim {i} of {tuple(shape)} does not "
                             f"divide over {as_axes(spec[i])} ({size})")
        out.append(dim // size)
    return tuple(out)


def shard_shapes(tree, specs, mesh) -> Any:
    """Each leaf's per-device shape, in the tree's structure."""
    return walk(lambda path, x, n, s: shard_shape(x.shape, s, mesh), tree, specs)


def per_device_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's blocks of every leaf."""
    total = []
    walk(lambda path, x, n, s: total.append(
        math.prod(shard_shape(x.shape, s, mesh)) * x.element_size()), tree, specs)
    return sum(total)
