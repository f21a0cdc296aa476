"""Gang-scheduled sequence-parallel prefill: the mesh plumbing and the layer
quanta the EngineBackend runs when a scheduling policy requests fast SP for
a long input (paper §5.3, live on real engines).

A *gang* is N replicas atomically claimed by the policy for one long
prefill.  On the execution side the gang maps onto a (ring, sp)
`GangMesh`: the sequence is sharded outer-major across both axes, the outer
axis runs ring attention (neighbour ppermute), and the inner axis runs the
planner-chosen strategy — `SPPlan.inner_impl`: "a2a" (Ulysses) or
"allgather" (Megatron-SP) — the hybrid of `sp/hybrid.py`, driven quantum by
quantum so the scheduler can preempt between quanta.

Quantum semantics: `layers_per_quantum` is calibrated for single-replica
execution; a gang of degree N advances `layers_per_quantum * N` layers per
quantum at equal per-device compute, so SP prefill completes in ~N x fewer
engine quanta while preemption latency (one quantum) stays bounded.

The mesh is single-controller: this process drives every rank.  A layer
quantum runs `model.serve_layer` for each rank in a thread of its own
(`sp.common.lockstep`), and the layer's core attention (the `attn_fn` hook) meets
the other ranks there: one thread runs the hybrid SP attention over every
rank's q/k/v and hands each rank its output.  A rank is any torch device:
``["cpu"] * 8`` on the CPU (the twin of XLA's forced host devices),
``[cuda:0] * k`` on one card, one card per rank on a multi-GPU host.  The
gang's devices are the backend's `sp_devices`; `gang_degree` clips a claim
to their count, so with one device the long runs the single-replica path.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import model as mdl
from repro_torch.sp.common import GangMesh, lockstep
from repro_torch.sp.hybrid import fast_sp_attention_local
from repro_torch.sp.planner import HardwareSpec, SPPlan, plan_fast_sp

OUTER_AXIS = "ring"          # cross-"node" ring attention
INNER_AXIS = "sp"            # high-bandwidth inner domain (a2a / allgather)

SEQ_AXES = (OUTER_AXIS, INNER_AXIS)


def gang_degree(requested: int, *, n_devices: int, cap: int = 0) -> int:
    """Realisable gang size: the replicas the policy claimed, clipped to the
    gang's device count (and an optional cap).  Degrees whose inner axis
    would not divide the head count fall back to a pure-ring mesh, so any
    degree >= 2 is realisable; < 2 means "no gang, single-replica path"."""
    n = min(requested, n_devices)
    if cap:
        n = min(n, cap)
    return n if n >= 2 else 1


def _mesh_shape(degree: int, num_heads: int) -> Tuple[int, int]:
    """(outer, inner): inner 2 when it divides both the degree and the head
    count (exercising the a2a/allgather strategies), else pure ring."""
    if degree % 2 == 0 and num_heads % 2 == 0:
        return degree // 2, 2
    return degree, 1


def make_gang_mesh(degree: int, num_heads: int,
                   devices: Sequence) -> GangMesh:
    """The gang's (ring, sp) mesh over the first `degree` of `devices`."""
    if len(devices) < degree:
        raise ValueError(f"a gang of {degree} needs {degree} devices, "
                         f"{len(devices)} given")
    return GangMesh(list(devices)[:degree], _mesh_shape(degree, num_heads),
                    SEQ_AXES)


def plan_for_gang(cfg: ModelConfig, input_len: int, mesh: GangMesh,
                  hw: HardwareSpec) -> SPPlan:
    """The paper's four-combination search, shaped to this gang's mesh:
    outer axis ~ nodes, inner axis ~ GPUs per node, priced on `hw`.
    `input_len` is the request's CLUSTER-scale length — strategy choice
    must reflect the real request even when the engine executes a
    scale-model prompt."""
    outer, inner = mesh.shape[OUTER_AXIS], mesh.shape[INNER_AXIS]
    return plan_fast_sp(cfg, input_len, n_nodes=outer,
                        gpus_per_node=max(inner, 1), tp=max(inner, 1), hw=hw)


@dataclass
class GangPrefillState:
    """Suspension state of a gang-SP prefill (§5.1 x §5.3): each rank's
    sequence shard of the intermediate + per-layer sequence-sharded KV,
    resumable between quanta with bit-identical results."""
    rid: int
    tokens: np.ndarray                   # (1, S_pad) int32, padded
    s_real: int                          # unpadded prompt length
    x: List[torch.Tensor]                # per rank (1, S_pad / degree, d)
    layer: int                           # next layer to execute
    degree: int
    plan: SPPlan
    # per layer, per rank (1, KV, S_pad / degree, hd)
    kv_k: List[List[torch.Tensor]] = field(default_factory=list)
    kv_v: List[List[torch.Tensor]] = field(default_factory=list)


class GangSPRunner:
    """Gang-SP prefill pipeline for one (model, mesh, strategy).

    The EngineBackend keeps one runner per (degree, strategy), shared by
    every long request the gang shape serves.  The weights are held once
    per distinct device of the mesh, not once per rank: ranks that share a
    card share its copy (the caller's own tree where it already lies
    there)."""

    def __init__(self, cfg: ModelConfig, params, mesh: GangMesh, strategy: str):
        assert strategy in ("a2a", "allgather"), strategy
        self.cfg = cfg
        self.mesh = mesh
        self.strategy = strategy
        self.degree = mesh.axis_size(SEQ_AXES)
        self._params = {}
        leaves = mdl.param_leaves(params)
        for dev in mesh.devices:
            if dev not in self._params:
                self._params[dev] = (params if all(t.device == dev for t in leaves)
                                     else mdl.tree_like(params,
                                                        [t.to(dev) for t in leaves]))
        self._attn = functools.partial(
            fast_sp_attention_local, mesh=mesh, outer_axes=OUTER_AXIS,
            inner_axis=INNER_AXIS, strategy=strategy)

    def _rank_params(self, rank: int):
        return self._params[self.mesh.devices[rank]]

    # ------------------------------------------------------------------
    def start(self, rid: int, tokens: np.ndarray,
              plan: SPPlan) -> GangPrefillState:
        """Embed + pad the prompt to a multiple of the gang degree (pad
        tokens sit AFTER the real ones; causality keeps them out of every
        real row's attention, and their KV is sliced away at scatter).
        Each rank embeds its own shard on its own device."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        s_real = int(toks.shape[0])
        toks = np.pad(toks, (0, (-s_real) % self.degree))[None]
        shards = np.split(toks, self.degree, axis=1)
        dtype = getattr(torch, self.cfg.dtype)
        x = []
        for r, dev in enumerate(self.mesh.devices):
            ids = torch.from_numpy(shards[r].astype(np.int64)).to(dev)
            x.append(self._rank_params(r)["embed"][ids].to(dtype))
        return GangPrefillState(rid=rid, tokens=toks, s_real=s_real, x=x,
                                layer=0, degree=self.degree, plan=plan)

    def quantum(self, st: GangPrefillState,
                layers: int) -> Tuple[GangPrefillState, bool]:
        """Advance up to `layers` layers (the gang-scaled quantum).  Each
        rank runs the layer body, `model.serve_layer` — projections, RoPE,
        residuals and MLP shared with the single-replica engine path — on
        its shard with GLOBAL RoPE positions, and its core attention is the
        hybrid SP attention over every rank (the `attn_fn` hook)."""
        cfg = self.cfg
        lo = st.layer
        hi = min(lo + layers, cfg.num_layers)

        def body(rank, meet):
            x = st.x[rank]
            B, s_loc, _ = x.shape
            positions = (rank * s_loc + torch.arange(s_loc, device=x.device)
                         )[None].expand(B, s_loc)

            def attn_fn(qh, kh, vh, *, causal, sliding_window):
                return meet(qh, kh, vh, causal, sliding_window)

            kvs = []
            for li in range(lo, hi):
                x, kv = mdl.serve_layer(cfg, self._rank_params(rank), li, x,
                                        positions, attn_fn=attn_fn)
                kvs.append(kv)
            return x, kvs

        def collective(args):
            q, k, v, causal, window = zip(*args)
            return self._attn(list(q), list(k), list(v), causal=causal[0],
                              sliding_window=window[0])

        outs = lockstep(self.degree, body, collective)
        st.x = [x for x, _ in outs]
        for i in range(hi - lo):
            st.kv_k.append([kvs[i].k for _, kvs in outs])
            st.kv_v.append([kvs[i].v for _, kvs in outs])
        st.layer = hi
        return st, hi == cfg.num_layers

    def logits(self, st: GangPrefillState) -> torch.Tensor:
        """First-token logits (1, V) of the last real position, on the rank
        that holds it."""
        assert st.layer == self.cfg.num_layers
        s_loc = st.x[0].shape[1]
        rank, row = divmod(st.s_real - 1, s_loc)
        p = self._rank_params(rank)
        last = L.rms_norm(st.x[rank][:, row:row + 1], p["final_norm"],
                          self.cfg.norm_eps)
        return torch.matmul(last, p["lm_head"].to(last.dtype))[:, -1]

    def gather_kv(self, st: GangPrefillState, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sequence-sharded per-layer KV joined on `device` as
        (L, KV, S, hd) tensors, pad rows dropped — the §5.3 scatter back to
        the home replica."""
        def join(per_layer):
            return torch.stack([torch.cat([t.to(device) for t in ranks], 2)[0]
                                for ranks in per_layer])[:, :, :st.s_real]
        return join(st.kv_k), join(st.kv_v)
