"""Intra-node SP variants (the paper's §4.2 pair) over the high-bandwidth
mesh axis (the paper's NVLink domain: the cards of one host).

Both take per-rank lists q[r] (B, H, S_loc, D) / k,v[r] (B, KV, S_loc, D) —
a *sequence* sub-shard per rank — and return the attention output in the
same layout.

a2a_attention       — the all-to-all layout swap of the paper's Fig. 5(a)
                      (DeepSpeed-Ulysses style): seq-sharded -> head-sharded
                      full sequence -> attention -> swap back.
allgather_attention — the all-gather layout (Megatron-SP style): gather the
                      full sequence on every rank, compute the local head
                      slice, all-to-all the output back to sequence shards.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.sp.common import GangMesh


def _split_heads(mesh: GangMesh, x: List[torch.Tensor],
                 axis_name: str) -> List[torch.Tensor]:
    """(B, H, S_loc, D) seq-sharded -> (B, H/p, S, D) head-sharded (A2A)."""
    return mesh.all_to_all(x, axis_name, split_axis=1, concat_axis=2)


def _merge_heads(mesh: GangMesh, x: List[torch.Tensor],
                 axis_name: str) -> List[torch.Tensor]:
    """(B, H/p, S, D) head-sharded -> (B, H, S_loc, D) seq-sharded (A2A);
    also (B, H/p, S) -> (B, H, S_loc) for an LSE."""
    return mesh.all_to_all(x, axis_name, split_axis=2, concat_axis=1)


def _rep_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """Materialise per-q-head KV (the GQA corner where the KV heads do not
    divide the axis): (B, KV, S, D) -> (B, H, S, D)."""
    return k.repeat_interleave(h // k.shape[1], 1)


def head_split(mesh: GangMesh, q, k, v, axis_name: str):
    """The all-to-all layout: q, k and v head-sharded over the full
    sequence, KV repeated per q head first where its heads do not divide
    the axis."""
    p, h = mesh.axis_size(axis_name), q[0].shape[1]
    if k[0].shape[1] % p:
        k, v = [_rep_kv(t, h) for t in k], [_rep_kv(t, h) for t in v]
    return (_split_heads(mesh, q, axis_name), _split_heads(mesh, k, axis_name),
            _split_heads(mesh, v, axis_name))


def head_slice(mesh: GangMesh, q, k, v, axis_name: str):
    """The all-gather layout: every rank's full-sequence q and its own head
    slice of q, k and v.  Contiguous KV slices keep GQA groups aligned
    (hp/kvp == H/KV); with fewer KV heads than ranks the KV is repeated per
    q head and sliced like q (replicated KV work)."""
    p = mesh.axis_size(axis_name)
    h, kvh = q[0].shape[1], k[0].shape[1]
    hp = h // p
    qg = mesh.all_gather(q, axis_name, axis=2)
    kg = mesh.all_gather(k, axis_name, axis=2)
    vg = mesh.all_gather(v, axis_name, axis=2)
    qs, ks, vs = [], [], []
    for r in range(mesh.n_ranks):
        i = mesh.axis_index(r, axis_name)
        qs.append(qg[r][:, i * hp:(i + 1) * hp])
        if kvh % p == 0:
            kvp = kvh // p
            ks.append(kg[r][:, i * kvp:(i + 1) * kvp])
            vs.append(vg[r][:, i * kvp:(i + 1) * kvp])
        else:
            ks.append(_rep_kv(kg[r], h)[:, i * hp:(i + 1) * hp])
            vs.append(_rep_kv(vg[r], h)[:, i * hp:(i + 1) * hp])
    return qs, ks, vs


def _attend(qs, ks, vs, *, causal, sliding_window, q_offset, scale,
            return_lse):
    return [ops.attention(q, k, v, causal=causal, sliding_window=sliding_window,
                          q_offset=q_offset, scale=scale, return_lse=return_lse)
            for q, k, v in zip(qs, ks, vs)]


def _back(mesh: GangMesh, outs, axis_name: str, return_lse: bool):
    """Each rank's output (and LSE) back to sequence shards, head-complete."""
    if return_lse:
        o, lse = zip(*outs)
        return (_merge_heads(mesh, list(o), axis_name),
                _merge_heads(mesh, list(lse), axis_name))
    return _merge_heads(mesh, outs, axis_name)


def a2a_attention(q, k, v, *, mesh: GangMesh, axis_name: str,
                  causal: bool = True, sliding_window: int = 0,
                  q_offset: int = 0, scale: Optional[float] = None,
                  return_lse: bool = False):
    outs = _attend(*head_split(mesh, q, k, v, axis_name), causal=causal,
                   sliding_window=sliding_window, q_offset=q_offset,
                   scale=scale, return_lse=return_lse)
    return _back(mesh, outs, axis_name, return_lse)


def allgather_attention(q, k, v, *, mesh: GangMesh, axis_name: str,
                        causal: bool = True, sliding_window: int = 0,
                        q_offset: int = 0, scale: Optional[float] = None,
                        return_lse: bool = False):
    outs = _attend(*head_slice(mesh, q, k, v, axis_name), causal=causal,
                   sliding_window=sliding_window, q_offset=q_offset,
                   scale=scale, return_lse=return_lse)
    return _back(mesh, outs, axis_name, return_lse)
