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
    length.  Each operation runs on every rank's tensors before the next,
    as the ranks of an SPMD program run it, so ranks that share a device
    hold their partials at once as separate devices would; on a `uniform`
    mesh (a dry run's meta group) on rank 0's alone, its results every
    rank's."""
    ranks = range(1 if mesh.uniform else mesh.n_ranks)

    def each(fn, *lists):
        return [fn(r, *(x[r] for x in lists)) for r in ranks]

    def every(xs):
        return xs * (mesh.n_ranks // len(xs))
    d, s_loc = q[0].shape[-1], k[0].shape[2]
    n_rep = q[0].shape[1] // k[0].shape[1]
    cl = each(lambda r, c: c.long(), cache_len)
    # the window's first key: newest (cl - 1) - window + 1
    lo = each(lambda r, c: (c - sliding_window).clamp_min(0) if sliding_window
              else torch.zeros_like(c), cl)
    kf = each(lambda r, x: x.repeat_interleave(n_rep, 1), k)
    kf = each(lambda r, x: x.float(), kf)
    vf = each(lambda r, x: x.repeat_interleave(n_rep, 1), v)
    vf = each(lambda r, x: x.float(), vf)
    logits = each(lambda r, x, y: torch.einsum("bhd,bhkd->bhk", x.float(), y) * d ** -0.5,
                  q, kf)

    def valid(r, x, c, l0):
        kpos = (mesh.axis_index(r, seq_axes) * s_loc
                + torch.arange(s_loc, device=x.device)[None])             # global
        return (kpos < c[:, None]) & (kpos >= l0[:, None])
    logits = each(lambda r, lg, ok: lg.masked_fill(~ok[:, None], float("-inf")),
                  logits, each(valid, k, cl, lo))
    m = each(lambda r, lg: lg.amax(-1), logits)                           # (B,H)
    p = each(lambda r, lg, mr: torch.exp(lg - torch.where(torch.isneginf(mr), 0.0, mr)[..., None]),
             logits, m)
    l = each(lambda r, x: x.sum(-1), p)
    o = each(lambda r, x, y: torch.einsum("bhk,bhkd->bhd", x, y), p, vf)
    # LSE-weighted merge across shards
    g_m = mesh.pmax(every(m), seq_axes)
    w = each(lambda r, mr, g: torch.where(torch.isneginf(mr), 0.0,
                                          torch.exp(mr - torch.where(torch.isneginf(g), 0.0, g))),
             m, g_m)
    num = mesh.psum(every(each(lambda r, a, b: a * b[..., None], o, w)), seq_axes)
    den = mesh.psum(every(each(lambda r, a, b: a * b, l, w)), seq_axes)
    return every(each(lambda r, a, b, x: (a / b.clamp_min(1e-38)[..., None]).to(x.dtype),
                      num, den, q))


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
