"""Fast SP (the paper's §5.3): hybrid sequence parallelism for long prefill.

Outer: ring attention across the long mesh axis (one axis or several, read
major-first) — scalable neighbour exchange.
Inner: within the high-bandwidth axis, either the A2A layout swap (paper
Fig. 5(a)) or the all-gather layout (Fig. 5(b)); chosen per request by the
planner's comm/compute estimate (planner.py) — the paper's "select the
lower-latency option" rule.

Public entry: `fast_sp_attention(q, k, v, mesh=...)` on GLOBAL tensors —
shards them over the mesh, runs `fast_sp_attention_local` on the per-rank
lists and joins the result, as the reference wraps its local function in
``shard_map``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.sp.common import Axes, GangMesh, as_axes, finalize
from repro_torch.sp.inner import _merge_heads, head_slice, head_split
from repro_torch.sp.ring import ring_partials


def fast_sp_attention_local(q: List[torch.Tensor], k: List[torch.Tensor],
                            v: List[torch.Tensor], *, mesh: GangMesh,
                            outer_axes: Axes, inner_axis: Optional[str],
                            strategy: str = "a2a", causal: bool = True,
                            sliding_window: int = 0,
                            scale: Optional[float] = None) -> List[torch.Tensor]:
    """Per-rank lists q[r] (B,H,s_loc,D), k/v[r] (B,KV,s_loc,D); the global
    sequence is sharded over (outer_axes..., inner_axis), outer-major."""
    pi = mesh.axis_size(inner_axis)
    # ---- inner transform: local seq sub-shard -> full outer segment -------
    if pi == 1:
        qs, ks, vs = q, k, v
    elif strategy == "a2a":
        qs, ks, vs = head_split(mesh, q, k, v, inner_axis)    # (B, H/pi, seg, D)
    elif strategy == "allgather":
        qs, ks, vs = head_slice(mesh, q, k, v, inner_axis)
    else:
        raise ValueError(strategy)
    # ---- outer ring over the long axis -------------------------------------
    o, lse = ring_partials(qs, ks, vs, mesh=mesh, axes=outer_axes,
                           causal=causal, sliding_window=sliding_window,
                           scale=scale)
    out = [finalize(a, b, x.dtype) for a, b, x in zip(o, lse, q)]
    # ---- back to the input layout (both strategies: one A2A) ---------------
    return out if pi == 1 else _merge_heads(mesh, out, inner_axis)


def fast_sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh: GangMesh, strategy: str = "a2a",
                      causal: bool = True, sliding_window: int = 0,
                      scale: Optional[float] = None,
                      outer_axes: Sequence[str] = ("data",),
                      inner_axis: Optional[str] = "model") -> torch.Tensor:
    """GLOBAL q (B,H,S,D), k/v (B,KV,S,D).  The sequence is sharded over
    (outer_axes..., inner_axis), the axes the mesh has; heads are whole at
    entry (the inner transform re-shards them).  The result lies on the
    first rank's device."""
    outer = tuple(a for a in as_axes(outer_axes) if a in mesh.axis_names)
    inner = inner_axis if inner_axis in mesh.axis_names else None
    seq = outer + ((inner,) if inner else ())
    out = fast_sp_attention_local(
        mesh.shard(q, 2, seq), mesh.shard(k, 2, seq), mesh.shard(v, 2, seq),
        mesh=mesh, outer_axes=outer, inner_axis=inner, strategy=strategy,
        causal=causal, sliding_window=sliding_window, scale=scale)
    return mesh.unshard(out, 2, seq)
