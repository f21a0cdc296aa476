"""Distributed decode attention: one query token vs a sequence-sharded KV
cache (the long-context serve step).  Each shard computes a partial
decode attention over its KV slice in f32, then the partials merge with an
LSE-weighted all-reduce (pmax, then psum) — O(B·H·D) bytes on the wire
instead of migrating the (huge) KV: the paper's Fig. 7, "Req1's Q is copied
... outputs are merged via all-reduce".

Plain PyTorch, as the reference's is plain jnp: no kernel runs here.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.sp.common import Axes, GangMesh, as_axes


def distributed_decode_local(q: List[torch.Tensor], k: List[torch.Tensor],
                             v: List[torch.Tensor],
                             cache_len: List[torch.Tensor], *, mesh: GangMesh,
                             seq_axes: Axes,
                             sliding_window: int = 0) -> List[torch.Tensor]:
    """Per-rank lists: q[r] (B,H,D) replicated over `seq_axes`; k/v[r]
    (B,KV,S_loc,D) = rank r's KV slice; cache_len[r] (B,) GLOBAL valid
    length."""
    m, l, o = [], [], []
    for r in range(mesh.n_ranks):
        qr, kr, vr, cl = q[r], k[r], v[r], cache_len[r].long()
        d, s_loc = qr.shape[-1], kr.shape[2]
        start = mesh.axis_index(r, seq_axes) * s_loc
        # the window's first key: newest (cl - 1) - window + 1
        lo = ((cl - sliding_window).clamp_min(0) if sliding_window
              else torch.zeros_like(cl))
        n_rep = qr.shape[1] // kr.shape[1]
        kf = kr.repeat_interleave(n_rep, 1).float()
        vf = vr.repeat_interleave(n_rep, 1).float()
        logits = torch.einsum("bhd,bhkd->bhk", qr.float(), kf) * d ** -0.5
        kpos = start + torch.arange(s_loc, device=kr.device)[None]  # global
        valid = (kpos < cl[:, None]) & (kpos >= lo[:, None])
        logits = logits.masked_fill(~valid[:, None], float("-inf"))
        mr = logits.amax(-1)                                       # (B,H)
        m_safe = torch.where(torch.isneginf(mr), 0.0, mr)
        p = torch.exp(logits - m_safe[..., None])
        m.append(mr)
        l.append(p.sum(-1))
        o.append(torch.einsum("bhk,bhkd->bhd", p, vf))
    # LSE-weighted merge across shards
    g_m = mesh.pmax(m, seq_axes)
    w = [torch.where(torch.isneginf(mr), 0.0,
                     torch.exp(mr - torch.where(torch.isneginf(g), 0.0, g)))
         for mr, g in zip(m, g_m)]
    num = mesh.psum([a * b[..., None] for a, b in zip(o, w)], seq_axes)
    den = mesh.psum([a * b for a, b in zip(l, w)], seq_axes)
    return [(a / b.clamp_min(1e-38)[..., None]).to(x.dtype)
            for a, b, x in zip(num, den, q)]


def distributed_decode_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, cache_len: torch.Tensor, *,
                                 mesh: GangMesh,
                                 seq_axes: Sequence[str] = ("data",),
                                 sliding_window: int = 0,
                                 batch_axes: Sequence[str] = ()) -> torch.Tensor:
    """GLOBAL q (B,H,D); k/v (B,KV,S,D) sharded on seq over `seq_axes` and
    on batch over `batch_axes` (keeping B sharded avoids gathering the
    cache).  The result lies on the first rank's device."""
    axes = tuple(a for a in as_axes(seq_axes) if a in mesh.axis_names)
    ba = tuple(a for a in as_axes(batch_axes)
               if a in mesh.axis_names and a not in axes)
    if ba and q.shape[0] % mesh.axis_size(ba):
        ba = ()

    def cache_shards(t):
        """Rank r's batch rows and sequence slice, cut before the move."""
        nb, ns = mesh.axis_size(ba), mesh.axis_size(axes)
        return [t.tensor_split(nb, 0)[mesh.axis_index(r, ba)]
                .tensor_split(ns, 2)[mesh.axis_index(r, axes)].to(mesh.devices[r])
                for r in range(mesh.n_ranks)]

    out = distributed_decode_local(
        mesh.shard(q, 0, ba), cache_shards(k), cache_shards(v),
        mesh.shard(cache_len, 0, ba), mesh=mesh, seq_axes=axes,
        sliding_window=sliding_window)
    return mesh.unshard(out, 0, ba)
