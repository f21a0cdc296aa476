"""Ring attention across a mesh axis (the paper's cross-node SP layer).

Each rank holds one sequence segment of Q/K/V.  KV segments rotate around
the ring by `GangMesh.ppermute` (neighbour exchange); every hop the local Q
attends to the incoming KV segment with global position offsets, and the
partial results merge via LSE algebra (common.py).

The local attention is ``ops.attention(..., return_lse=True)``: on the card
the hand kernel B1 (``csrc/flash_attention.cu``), which gives 0 and LSE
-inf for a hop whose keys all lie after every query (a negative
``q_offset``); on the CPU its plain version.  Every hop runs, as in the
reference, whose ring calls its plain ``ops.xla_attention`` there.

Communication per hop = local KV bytes; total = (P-1) · KV-segment bytes.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.sp.common import Axes, GangMesh, finalize, merge_partials


def ring_partials(q: List[torch.Tensor], k: List[torch.Tensor],
                  v: List[torch.Tensor], *, mesh: GangMesh, axes: Axes,
                  causal: bool = True, sliding_window: int = 0,
                  scale: Optional[float] = None
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The ring over `axes` (one hop when they are empty): per rank the
    merged f32 output and LSE of its q segment against every KV segment.
    Segments are q[r].shape[2] long and lie in axis order.  The hops run one
    after another, each over every rank in rank order."""
    p = mesh.axis_size(axes)
    ranks = range(mesh.n_ranks)
    idx = [mesh.axis_index(r, axes) for r in ranks]
    seg = q[0].shape[2]
    o = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in q]
    lse = [torch.full(x.shape[:3], float("-inf"), device=x.device) for x in q]
    for step in range(p):
        for r in ranks:
            # q_offset: the GLOBAL q position relative to this kv segment's
            # start, so causal/window masks are globally correct
            kv_rank = (idx[r] - step) % p
            o_new, lse_new = ops.attention(
                q[r], k[r], v[r], causal=causal, sliding_window=sliding_window,
                q_offset=(idx[r] - kv_rank) * seg, scale=scale,
                return_lse=True)
            o[r], lse[r] = merge_partials(o[r], lse[r], o_new.float(), lse_new)
        if step < p - 1:
            k, v = mesh.ppermute(k, axes), mesh.ppermute(v, axes)
    return o, lse


def ring_attention_local(q: List[torch.Tensor], k: List[torch.Tensor],
                         v: List[torch.Tensor], *, mesh: GangMesh,
                         axis_name: str, causal: bool = True,
                         sliding_window: int = 0,
                         scale: Optional[float] = None) -> List[torch.Tensor]:
    """Per-rank lists: q/k/v[r] (B, H|KV, S_local, D) = rank r's segment;
    the global sequence is the concat of segments along the axis, in axis
    order.  Returns each rank's output segment."""
    o, lse = ring_partials(q, k, v, mesh=mesh, axes=axis_name, causal=causal,
                           sliding_window=sliding_window, scale=scale)
    return [finalize(a, b, x.dtype) for a, b, x in zip(o, lse, q)]
