"""Logical-axis sharding rules, the counterpart of the reference's
``models/sharding.py``: code names a tensor's dims by *logical* axes, and a
`ShardingRules` mapping (set per launch) resolves them to mesh axes.

The port's mesh is the single controller's `GangMesh`.  `resolve_spec` and
`resolve_first` resolve a spec as the reference does (axes that do not
divide a dim are dropped, a mesh axis serves one dim, the first eligible
one); `constrain` and `constrain_first`, the reference's sharding
constraints, resolve it and return the tensor unchanged: a whole-tensor
step has no partitioner to hand a spec to.  What the rules steer is the
partitioned prefill and serve steps, whose per-rank layouts
(`models/tp.plan`) are the specs the rules give the reference's call
sites; the whole-tensor decode attention (`layers._cached_decode_attention`:
a sharded "cache_seq" sends it to the sequence-sharded decode); and the
dry run's spec trees (`launch/shardings.py`).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.sp.common import as_axes

Axis = Union[str, None, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated) — element for element the reference's
    ``jax.sharding.PartitionSpec``, which also writes a one-name tuple as
    the name and an empty one as None."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            (p[0] if len(p) == 1 else (tuple(p) or None))
            if isinstance(p, (tuple, list)) else p for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def divides(mesh, dim: int, axes: Axis) -> bool:
    """Whether the mesh axes `axes` (a name, a tuple, None: none) split a
    dim of `dim` evenly with at least one element per part."""
    if not as_axes(axes):
        return False
    size = mesh.axis_size(axes)
    return dim % size == 0 and dim >= size


@dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names -> mesh axis (or tuple, or None=replicated)."""
    mesh: Any                      # sp.common.GangMesh
    rules: Dict[str, Axis] = field(default_factory=dict)

    def spec(self, logical_axes: Tuple[Optional[str], ...]) -> PartitionSpec:
        return P(*(None if ax is None else self.rules.get(ax)
                   for ax in logical_axes))


_current: contextvars.ContextVar[Optional[ShardingRules]] = \
    contextvars.ContextVar("sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    tok = _current.set(rules)
    try:
        yield rules
    finally:
        _current.reset(tok)


def current_rules() -> Optional[ShardingRules]:
    return _current.get()


def resolve_spec(shape, *logical_axes: Optional[str]) -> Optional[PartitionSpec]:
    """The spec the active rules give a tensor of `shape` whose dims carry
    `logical_axes` (None without rules).  Axes whose mesh extent does not
    divide the dim are dropped; a mesh axis serves at most one dim, the
    FIRST eligible one (call sites order logical axes by priority)."""
    rules = _current.get()
    if rules is None:
        return None
    resolved = []
    for dim, ax in zip(shape, logical_axes):
        mesh_ax = rules.rules.get(ax) if ax else None
        ok = divides(rules.mesh, dim, mesh_ax)
        resolved.append((ax, as_axes(mesh_ax)) if ok else (None, ()))
    used = set()
    fixed = [None] * len(resolved)
    for i, (ax, axes) in enumerate(resolved):
        if ax is not None and not (set(axes) & used):
            fixed[i] = ax
            used.update(axes)
    return rules.spec(tuple(fixed))


def resolve_first(shape, *options) -> Optional[PartitionSpec]:
    """`resolve_spec` of the first option whose every mapped mesh axis
    divides its dim (None without rules or without a valid option): e.g.
    attention prefers head sharding but falls back to sequence sharding
    when the head count does not divide the TP axis (qwen2: 28 heads on
    16).  A logical axis that maps to nothing makes its option invalid."""
    rules = _current.get()
    if rules is None:
        return None
    for opt in options:
        ok = True
        for dim, ax in zip(shape, opt):
            mesh_ax = rules.rules.get(ax) if ax else None
            if mesh_ax is None:
                if ax is not None:
                    ok = False
                    break
                continue
            if not divides(rules.mesh, dim, mesh_ax):
                ok = False
                break
        if ok:
            return resolve_spec(shape, *opt)
    return None


def constrain(x, *logical_axes: Optional[str]):
    """The reference's sharding constraint: resolves the spec and returns x
    unchanged (a whole-tensor step; the partitioned steps lay out their
    shards by `models/tp.plan`)."""
    resolve_spec(x.shape, *logical_axes)
    return x


def constrain_first(x, *options):
    """As `constrain`, over the first valid option (`resolve_first`)."""
    resolve_first(x.shape, *options)
    return x


# ---------------------------------------------------------------------------
# Standard rule sets (the reference's DESIGN.md §5). batch axes absorb "pod".
# ---------------------------------------------------------------------------
def standard_rules(mesh, *, long_context: bool = False, fsdp: bool = False,
                   seq_over_model: bool = True) -> ShardingRules:
    """Default logical->mesh mapping, the reference's table.

    seq_over_model: Megatron-style sequence parallelism of the residual
    stream over the TP axis.  cache_seq: the KV caches' sequence dim over
    the TP axis (B == 1 long context: over the batch axes too)."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    batch: Axis = batch_axes if len(batch_axes) > 1 else (batch_axes[0] if batch_axes else None)
    if long_context:
        seq: Axis = (batch_axes + ("model",)) if seq_over_model else batch
    else:
        seq = "model" if seq_over_model else None
    rules: Dict[str, Axis] = {
        "batch": batch,
        "seq": seq,
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "vocab": "model",
        "embed": None,
        "fsdp": batch if fsdp else None,
        "state": None,
        "cache_seq": (batch_axes + ("model",)) if long_context else ("model",),
    }
    return ShardingRules(mesh=mesh, rules=rules)
