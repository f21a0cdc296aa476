"""Per-rank bodies of every family (dense, vlm, moe, ssm, hybrid, audio)
under the sharding rules: what `models/layers.py`, `models/moe.py`,
`models/mamba2.py` and `models/model.py` become when XLA's SPMD
partitioner splits the reference's steps under `standard_rules`, written
out for one rank of a `GangMesh`.  The caller (`launch/partition.py`) runs one body per rank in
lockstep; a body reaches the other ranks only through its `Rank`'s
collectives.

The layouts come from the reference's call sites through `resolve_spec` /
`resolve_first` (`plan`), not from a fixed plan:

* the residual stream ("batch", "seq", None): each rank holds its batch
  rows and its piece of the sequence, and all-gathers the sequence before
  each norm and projection;
* Q, K, V column-parallel over "heads" / "kv_heads" where the rules give
  heads; where the head count does not divide the axis, the reference's
  second option: the query's rows over "seq" (B1 at their q_offset) with
  K and V whole; where a rank's query heads read K/V heads they do not
  pair evenly with, B1 gets each query head's K/V head (`_kv_for`);
* ``wo`` and ``w_down`` row-parallel: their partial sums reduce-scattered
  onto the residual's sequence, or all-reduced where it is not sharded;
  ``w_gate`` / ``w_up`` over "ff";
* the embedding over "vocab" (each rank looks up the ids of its rows of the
  table, zeros elsewhere, and the ranks sum), the lm head over "vocab"
  with the padded vocabulary masked on each rank's slice;
* FSDP leaves (sharded over the batch axes) all-gathered before their
  layer;
* the prefill's K/V, head-sharded, moved by an all-to-all into the
  cache's layout (`launch/shardings.cache_specs`: sequence over "model",
  or over the batch axes and "model" for one sequence), written as
  `model._write_prefix` writes (the ring roll past the cache's length);
  the serve step writes a token's K/V on the rank whose slice holds its
  position and decodes with `sp.decode.distributed_decode_local` over the
  cache's sequence axes;
* the moe block (`_moe`) with its experts over "experts" ("model"): each
  rank computes the f32 router logits of its router columns and
  all-gathers them, so every rank routes the whole routing group (the
  reference's capacity, slots and drops); the groups ("batch", None, None)
  are the rank's own rows where the batch axes cut them, else the rank
  all-gathers the routing input over the batch axes (the serve step: one
  group of every sequence) and runs only its own rows; the rank's experts
  run their SwiGLU on their kept rows and the partial sums over the
  expert ranks, rounded to the activations' dtype as the reference's
  combine einsum yields them, are reduce-scattered onto the residual's
  sequence; where the experts do not divide "model" every rank runs every
  expert and no sum is taken; the shared expert is column- and
  row-parallel like the dense MLP;
* the Mamba2 layer (`_mamba`) with in_proj and out_proj whole over
  "model" (the reference's `param_specs`): every model rank runs in_proj,
  the conv and the gate over the whole gathered sequence of its batch
  rows, as XLA does; the scan input ("batch", None, "heads", None) first,
  ("batch", "seq", None, None) second (reference `mamba2.py:70`): the
  rank scans its heads (B3 on them, y and the prefill's final state
  all-gathered over the heads), or its rows (B3 from a zero state, the
  ranks' final states and summed dt·A all-gathered over the rows' axes,
  the state entering the rank's rows passed from them and added to y, the
  norm and out_proj on the rank's rows), or, where neither divides (one
  sequence under the long-context rules), every head of the whole
  sequence; the serve step runs `mamba2_step` on the rank's batch rows
  with every head and no collective; the state cache is whole over
  "model" and cut over the batch axes;
* the hybrid's shared attention and MLP block as a dense layer (no
  window), its K/V into ``sh_k`` / ``sh_v`` in the cache's layout;
* the audio encoder-decoder: the encoder's residual whole over "model"
  (the reference constrains none of it; its compiled prefill all-reduces
  wo's and w_down's sums), its attention not causal with RoPE on the
  frame positions; the decoder's embedding over "seq", each decoder
  layer's residual gathered and whole inside (its row-parallel sums
  all-reduced), cut back to the rank's rows at the layer's end; the cross
  attention's K and V projected by each rank from the encoder's output
  for its K/V heads' columns (no RoPE, not causal, every frame) and moved
  into the cross cache by the prefill's all-to-all; the serve step's
  cross decode over the rank's slice of the cross cache
  (`distributed_decode_local`, where the reference leaves the partitioning
  of its plain decode to XLA);
* the train step's loss (`loss_rank`, under the fsdp rules) on the logits
  as the reference constrains them, the sequence gathered and the
  vocabulary over "model": each slice's max and sum of exponentials
  merged across the vocab ranks, the labels' logits taken where their
  slice lies; moe adds 0.01 x the load-balance loss, its per-expert means
  taken over every group; remat per layer, per hybrid segment, per
  encoder and decoder layer (`Rank.remat` of the residual and the
  encoder's output, whose gradient the decoder layers' sum).

A dim that its axes do not divide stays whole, as the rules leave it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import model as mdl
from repro_torch.models import moe as MOE
from repro_torch.models.sharding import (resolve_first, resolve_spec,
                                         standard_rules, use_rules)
from repro_torch.sp.common import as_axes
from repro_torch.sp.decode import distributed_decode_local

Axes = Tuple[str, ...]
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


@dataclass(frozen=True)
class Plan:
    """The mesh axes of one step's layouts (() = whole)."""
    batch: Axes        # the batch rows: residual, tokens, cache
    seq: Axes          # the residual's sequence (prefill)
    tok_seq: Axes      # the tokens' sequence (`shardings.batch_specs`)
    q_heads: Axes      # q's heads, or
    q_rows: Axes       # q's rows (the fallback), or neither: q whole
    kv_heads: Axes
    cache_seq: Axes    # the KV cache's sequence
    moe_batch: Axes = ()   # moe: the routing groups' axes ("batch", None, None)
    moe_group: int = 0     # moe: tokens per routing group
    ssd_heads: Axes = ()   # ssm, hybrid: the scan's heads, or
    ssd_rows: Axes = ()    # its rows (the fallback), or neither: the scan whole
    enc: Optional["Plan"] = None   # audio: the encoder's layouts (residual whole)
    cross_seq: Axes = ()   # audio: the cross cache's sequence


def plan(cfg: ModelConfig, mesh, *, batch: int, seq: int, long_context: bool,
         tok_spec=None, cache_spec=None, frames: int = 0, cross_spec=None) -> Plan:
    """The layouts the reference's call sites give a step of `batch`
    sequences of `seq` positions (1: the serve step) under
    ``standard_rules(mesh, long_context=...)``; `tok_spec` and
    `cache_spec` are the tokens' and the "k" cache's specs.  audio: `seq`
    is the decoder's positions (1: the prefill's BOS row, laid out as a
    prefill where `frames` is given), `frames` the encoder's (0: the serve
    step), whose layouts go under `enc` with its residual whole;
    `cross_spec` is the "cross_k" cache's spec.  One sequence cut over the
    long-context rules' axes raises: its decoder's BOS token divides over
    no mesh of more than one rank."""
    if cfg.family != "audio":
        return _plan(cfg, mesh, batch, seq, long_context, seq == 1, tok_spec, cache_spec)
    p = _plan(cfg, mesh, batch, seq, long_context, not frames, tok_spec, cache_spec)
    if frames and p.tok_seq and mesh.axis_size(p.tok_seq) > 1:
        raise ValueError(
            f"partitioned audio prefill: the batch specs cut the decoder's {seq} BOS "
            f"token(s) of one sequence over {p.tok_seq} ({mesh.axis_size(p.tok_seq)} "
            "ranks) under the long-context rules, which no mesh of more than one rank "
            "divides (the reference's jit refuses that input sharding; long_500k is "
            "skipped for encoder-decoders)")
    enc = None
    if frames:
        enc = dataclasses.replace(_plan(cfg, mesh, batch, frames, long_context, False),
                                  seq=(), tok_seq=p.tok_seq)
    return dataclasses.replace(
        p, enc=enc, cross_seq=as_axes(cross_spec[3]) if cross_spec is not None else ())


def _plan(cfg: ModelConfig, mesh, batch: int, seq: int, long_context: bool, serve: bool,
          tok_spec=None, cache_spec=None) -> Plan:
    """`plan` of one stack of layers; `serve`: one token per sequence."""
    B, S, d = batch, seq, cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    with use_rules(standard_rules(mesh, long_context=long_context)):
        xs = resolve_spec((B, S, d), "batch", "seq", None)
        qs = (resolve_first((B, H, S, hd), ("batch", "heads", None, None),
                            ("batch", None, "seq", None))
              or resolve_first((B, H, S, hd), (None, "heads", None, None),
                               (None, None, "seq", None)))
        ks = (resolve_first((B, KV, S, hd), ("batch", "kv_heads", None, None),
                            ("batch", None, None, None))
              or resolve_first((B, KV, S, hd), (None, "kv_heads", None, None),
                               (None, None, None, None)))
        if cfg.family == "moe":
            G, Tg = MOE.groups(B * S)
            gs = resolve_spec((G, Tg, d), "batch", None, None)
        if cfg.family in ("ssm", "hybrid"):
            xh = resolve_first((B, S, cfg.ssm_heads, cfg.ssm_headdim),
                               ("batch", None, "heads", None), ("batch", "seq", None, None))
    p = Plan(batch=as_axes(xs[0]), seq=as_axes(xs[1]) if S > 1 else (),
             tok_seq=as_axes(tok_spec[1]) if tok_spec is not None and len(tok_spec) > 1
             else (),
             q_heads=as_axes(qs[1]) if qs is not None and not serve else (),
             q_rows=as_axes(qs[2]) if qs is not None and not serve else (),
             kv_heads=as_axes(ks[1]) if ks is not None and not serve else (),
             cache_seq=as_axes(cache_spec[3]) if cache_spec is not None else ())
    if cfg.family == "moe":
        p = dataclasses.replace(p, moe_batch=as_axes(gs[0]), moe_group=Tg)
    if cfg.family in ("ssm", "hybrid") and xh is not None and S > 1:
        p = dataclasses.replace(p, ssd_heads=as_axes(xh[2]), ssd_rows=as_axes(xh[1]))
    for what, spec in (("tokens", tok_spec), ("cache", cache_spec)):
        ax = () if spec is None else as_axes(spec[0 if what == "tokens" else 1])
        if spec is not None and ax != p.batch:
            raise ValueError(f"partitioned step: the {what}' batch axes {ax} are "
                             f"not the residual's {p.batch}")
    for what, rows in (("q", p.q_rows), ("the scan", p.ssd_rows)):
        if rows and rows != p.seq:
            raise ValueError(f"partitioned step: {what}'s rows over {rows}, the "
                             f"residual's over {p.seq}")
    return p


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------
def _model(entry) -> Axes:
    """The "model" part of a spec entry."""
    return tuple(a for a in as_axes(entry) if a == "model")


def _weight(rk, w: torch.Tensor, spec) -> torch.Tensor:
    """`w` all-gathered over every axis but "model" (its FSDP axes)."""
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in as_axes(entry) if a != "model")
        if axes:
            w = rk.all_gather(w, axes, axis=dim)
    return w


def _col(rk, x, p, ps, w: str, b: str = ""):
    """(x @ w + b, the axes of its columns) for a column-parallel w."""
    y = L.linear(x, _weight(rk, p[w], ps[w]), p.get(b))
    return y, _model(ps[w][-1])


def _to_cols(rk, t, have: Axes, want: Axes):
    """t's last dim, sharded over `have`, sharded over `want` instead."""
    if have == want:
        return t
    return rk.local(rk.all_gather(t, have, axis=-1), -1, want)


def _to_rows(rk, t, cols: Axes, rows: Axes):
    """(b, S, C / |cols|) column pieces to (b, S / |rows|, C) row pieces:
    an all-to-all where `rows` ends with `cols`."""
    if cols and rows[-len(cols):] == cols:
        t = rk.local(t, 1, rows[:-len(cols)])
        return rk.all_to_all(t, cols, split_axis=1, concat_axis=-1)
    return rk.local(rk.all_gather(t, cols, axis=-1), 1, rows)


def _reduce_to(rk, y, summed: Axes, seq: Axes, done: Axes = ()):
    """The sum over `summed` of the partial sums `y` (b, S, d), cut to the
    rank's piece of the sequence over `seq`, of which `y` is already cut
    over the leading axes `done`: a reduce-scatter where `seq` ends with
    `summed`, else an all-reduce and a local cut."""
    if seq[:len(done)] != done:
        raise ValueError(f"partitioned step: {done} does not lead {seq}")
    rest = seq[len(done):]
    if summed and rest[-len(summed):] == summed:
        return rk.psum_scatter(rk.local(y, 1, rest[:-len(summed)]), summed, 1)
    return rk.local(rk.psum(y, summed), 1, rest)


def _row(rk, h, h_cols: Axes, p, ps, w: str, seq: Axes):
    """h @ w for a row-parallel w, h's last dim sharded over `h_cols`, in
    the residual's layout."""
    rows = _model(ps[w][0])
    h = _to_cols(rk, h, h_cols, rows)
    return _reduce_to(rk, L.linear(h, _weight(rk, p[w], ps[w])), rows, seq)


def _kv_for(k, v, h0: int, nh: int, n_rep: int, kv0: int):
    """The K/V heads (b, n, S, hd) that B1 pairs with the rank's query heads
    [h0, h0 + nh) (query head j with key head j // (nh / n)), from the
    rank's K/V heads (b, nkv, S, hd) from `kv0` on: the slice of the heads
    they read where those pair evenly with them, else each query head's own
    K/V head repeated per query head (as `sp/inner._rep_kv` repeats where
    the heads do not divide the axis), e.g. phi3_14b's 40 q / 10 KV heads
    over 4 ranks, 10 query heads reading 3 K/V heads."""
    reads = [(h0 + j) // n_rep - kv0 for j in range(nh)]
    if reads[0] < 0 or reads[-1] >= k.shape[1]:
        raise ValueError(f"partitioned step: query heads [{h0}, {h0 + nh}) read "
                         f"key heads [{reads[0] + kv0}, {reads[-1] + kv0 + 1}), the rank "
                         f"holds [{kv0}, {kv0 + k.shape[1]})")
    lo, n = reads[0], reads[-1] - reads[0] + 1
    if nh % n == 0 and all(r - lo == j // (nh // n) for j, r in enumerate(reads)):
        return k[:, lo:lo + n], v[:, lo:lo + n]
    idx = torch.tensor(reads, device=k.device)
    return k.index_select(1, idx), v.index_select(1, idx)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def _embed(rk, cfg, p, ps, ids, prefix=None):
    """(the lookup of `ids`, the table's vocab axes): a rank holding a slice
    of the table looks up the ids in it and gives zeros for the others
    (their sum over the vocab axes is the lookup); `prefix` (vlm patch
    embeddings) is counted once, on the axes' first rank."""
    dt = getattr(torch, cfg.dtype)
    table = _weight(rk, p["embed"], ps["embed"])
    va = _model(ps["embed"][0])
    if va:
        n = table.shape[0]
        ids = ids - rk.index(va) * n
        hit = (ids >= 0) & (ids < n)
        e = torch.where(hit[..., None], table[ids.clamp(0, n - 1)],
                        torch.zeros((), dtype=table.dtype, device=table.device))
    else:
        e = table[ids]
    e = e.to(dt)
    if prefix is not None:
        prefix = prefix.to(dt)
        if va and rk.index(va):
            prefix = torch.zeros_like(prefix)
        e = torch.cat([prefix, e], 1)
    return e, va


def _lm_head(rk, cfg, p, ps, x):
    """Final norm and the lm head over the rank's vocab slice, the padded
    vocabulary masked (`model._mask_padded_vocab` at the slice's offset)."""
    x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    w = _weight(rk, p["lm_head"], ps["lm_head"])
    v0 = rk.index(_model(ps["lm_head"][1])) * w.shape[1]
    return mdl._mask_padded_vocab(cfg, torch.matmul(x, w.to(x.dtype)), v0)


def _mlp(rk, p, ps, h, seq: Axes):
    g, cols = _col(rk, h, p, ps, "w_gate")
    u, _ = _col(rk, h, p, ps, "w_up")
    return _row(rk, F.silu(g) * u, cols, p, ps, "w_down", seq)


def _moe(rk, cfg: ModelConfig, pl: Plan, p, ps, h, seq: Axes, cf=None, *,
         balance: bool = False, impl: str = "auto"):
    """The moe block (`moe.moe_block`) of the rank's normalised rows h (b,
    S, d), the whole sequence: (its output in the residual's layout over
    `seq`, with `balance` the load-balance loss of every group, else None:
    a step that does not train drops it, as XLA drops dead code).  The
    router's columns give f32 logits all-gathered over its "model" axes,
    so every rank routes (`moe.route_logits`, capacity factor `cf`) the
    groups it holds whole: its own rows' where the groups are cut over the
    batch axes as the rows are, else every row, gathered over the batch
    axes.  The rank's experts run on its own rows' kept assignments
    (`moe.expert_partial`); their f32 sums, rounded to h's dtype (the
    reference's combine einsum yields it), are summed over the expert
    axes onto the residual's sequence (`_reduce_to`): a reduce-scatter,
    or, with the experts whole, a local cut.  The load-balance means are
    psummed over the batch axes where each rank routed its own groups.
    impl: the experts' grouped GEMM's (`ops.grouped_gemm`)."""
    b, S, d = h.shape
    own = pl.moe_batch == pl.batch
    xr = h if own else rk.all_gather(h, pl.batch, axis=0)
    logits = torch.matmul(xr.reshape(-1, pl.moe_group, d).float(),
                          _weight(rk, p["router"], ps["router"]).float())
    r = MOE.route_logits(cfg, rk.all_gather(logits, _model(ps["router"][-1]), axis=-1),
                         capacity_factor=cf)
    experts = {k: _weight(rk, p[k], ps[k]) for k in ("w_gate", "w_up", "w_down")}
    ea = _model(ps["w_gate"][0])
    t0 = 0 if own else rk.index(pl.batch) * b * S
    y = MOE.expert_partial(cfg, experts, r, xr.reshape(-1, d),
                           e0=rk.index(ea) * experts["w_gate"].shape[0],
                           tokens=(t0, t0 + b * S), impl=impl)
    y = _reduce_to(rk, y.reshape(b, S, d).to(h.dtype), ea, seq)
    if "shared" in p:
        y = y + _mlp(rk, p["shared"], ps["shared"], h, seq)
    if not balance:
        return y, None
    me, ce = MOE.balance_terms(cfg, r)
    if own and pl.batch:
        n = rk.size(pl.batch)
        me, ce = rk.psum(me, pl.batch) / n, rk.psum(ce, pl.batch) / n
    return y, cfg.num_experts * (me * ce).sum()


def _attention(rk, cfg, pl: Plan, p, ps, h, positions, *, impl, causal: bool = True,
               seq=None, enc=None):
    """Prefill attention of the rank's normalised rows `h` (b, S, d), the
    whole sequence: (its output in the residual's layout over `seq`
    (default the plan's), (K, V) as (b, KV / |kv_heads|, Sk, hd)).  `enc`:
    the encoder's output (b, F, d), whole, from which the cross attention
    projects K and V (no RoPE on q or K, not causal, every frame)."""
    b, S, _ = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    seq = pl.seq if seq is None else seq
    q, qc = _col(rk, h, p, ps, "wq", "bq")
    h0, nh, q0 = 0, H, 0
    if pl.q_heads:
        q = _to_cols(rk, q, qc, pl.q_heads)
        nh = H // rk.size(pl.q_heads)
        h0 = rk.index(pl.q_heads) * nh
    elif pl.q_rows:
        q = _to_rows(rk, q, qc, pl.q_rows)
        q0 = rk.index(pl.q_rows) * q.shape[1]
    else:
        q = rk.all_gather(q, qc, axis=-1)
    sq = q.shape[1]
    q = q.reshape(b, sq, nh, hd)
    src = h if enc is None else enc
    k, kc = _col(rk, src, p, ps, "wk", "bk")
    v, vc = _col(rk, src, p, ps, "wv", "bv")
    k, v = _to_cols(rk, k, kc, pl.kv_heads), _to_cols(rk, v, vc, pl.kv_heads)
    nkv, Sk = KV // rk.size(pl.kv_heads), src.shape[1]
    k = k.reshape(b, Sk, nkv, hd)
    if enc is None:
        q = L.rope(q, positions[q0:q0 + sq], cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    kh, vh = k.transpose(1, 2), v.reshape(b, Sk, nkv, hd).transpose(1, 2)
    ka, va = _kv_for(kh, vh, h0, nh, H // KV, rk.index(pl.kv_heads) * nkv)
    # the reference's moe layer, hybrid shared block and encoder-decoder
    # give their attention no window
    window = cfg.sliding_window if cfg.family in ("dense", "vlm") else 0
    o = ops.attention(q.transpose(1, 2), ka, va, causal=causal and enc is None,
                      sliding_window=window, q_offset=q0, impl=impl)
    o = o.transpose(1, 2).reshape(b, sq, nh * hd)
    if pl.q_rows:
        rows = _model(ps["wo"][0])
        if rows and pl.q_rows[-len(rows):] == rows:
            # back to column pieces over the rows of the leading axes
            o = rk.all_to_all(o, rows, split_axis=-1, concat_axis=1)
            out = L.linear(o, _weight(rk, p["wo"], ps["wo"]))
            return _reduce_to(rk, out, rows, seq, done=pl.q_rows[:-len(rows)]), (kh, vh)
        o = rk.all_gather(o, pl.q_rows, axis=1)
    return _row(rk, o, pl.q_heads, p, ps, "wo", seq), (kh, vh)


def _mamba(rk, cfg: ModelConfig, pl: Plan, p, ps, x, *, impl: str, state: bool = False):
    """One Mamba2 layer (`model._mamba_layer`) on the rank's residual rows
    x: (x, with `state` the layer's (conv, ssm) state of the rank's batch
    rows, else None).  in_proj and out_proj are whole over "model", so the
    rank runs in_proj, the conv and the gate over the whole gathered
    sequence (`mamba2.mamba2_in`).  The scan takes the plan's layout: the
    rank's heads, x, dt, A and D cut to them (`ssd_heads`), y and the final
    state all-gathered over them; or its rows (`ssd_rows`, the residual's),
    scanned from a zero state, each rank's final state and summed dt·A
    all-gathered over the rows' axes, the state entering its rows passed
    from the earlier ranks' (`mamba2.pass_states`) and added to y
    (`mamba2.enter_state`), the norm and out_proj run on its rows alone;
    or whole.  A rank's gradient reaches each weight through its own
    heads or rows and its own residual rows only, so the sums over the
    ranks count each contribution once."""
    w = {k: _weight(rk, v, ps["mamba"][k]) for k, v in p["mamba"].items()}
    h = L.rms_norm(rk.all_gather(x, pl.seq, axis=1), p["ln"], cfg.norm_eps)
    b, S, _ = h.shape
    nh, hd = cfg.ssm_heads, cfg.ssm_headdim
    z, xh, Bm, Cm, dt, A, conv = M.mamba2_in(cfg, w, h)
    if pl.ssd_rows:
        s = S // rk.size(pl.ssd_rows)
        r = rk.index(pl.ssd_rows)
        rows = slice(r * s, (r + 1) * s)
        dt, Cm = dt[:, rows], Cm[:, rows]
        y, last = M.mamba2_scan(cfg, w, xh[:, rows], dt, A, Bm[:, rows], Cm, impl=impl)
        states = rk.all_gather(last[None], pl.ssd_rows, axis=0)
        totals = rk.all_gather((dt * A).sum(1)[None], pl.ssd_rows, axis=0)
        y = M.enter_state(y, dt, A, Cm, M.pass_states(states, totals, r))
        out = M.mamba2_out(cfg, w, y.reshape(b, s, nh * hd), z[:, rows])
        return x + out, ((conv, M.pass_states(states, totals)) if state else None)
    if pl.ssd_heads:
        n = nh // rk.size(pl.ssd_heads)
        y, last = M.mamba2_scan(cfg, w, xh, dt, A, Bm, Cm, impl=impl,
                                heads=(rk.index(pl.ssd_heads) * n, n))
        y = rk.all_gather(y.reshape(b, S, n * hd), pl.ssd_heads, axis=-1)
        if state:
            last = rk.all_gather(last, pl.ssd_heads, axis=1)
    else:
        y, last = M.mamba2_scan(cfg, w, xh, dt, A, Bm, Cm, impl=impl)
        y = y.reshape(b, S, nh * hd)
    out = M.mamba2_out(cfg, w, y, z)
    return x + rk.local(out, 1, pl.seq), ((conv, last) if state else None)


def _write_prefix(rk, pl: Plan, dst, src, ca=None) -> None:
    """dst, the rank's (b, KV, S_max / |ca|, hd) slice of one layer's cache
    (`ca`: its sequence's axes, default the plan's cache_seq), <- its
    positions of the prefill's K or V, src (b, KV / |kv_heads|, S, hd): the
    slots `model._prefix_slots` gives the whole cache (padded to S_max),
    cut to the rank's slice by an all-to-all over the head axes; a prefix
    within the first slice gathered over the head axes instead."""
    kh, ca = pl.kv_heads, pl.cache_seq if ca is None else ca
    s_loc = dst.shape[2]
    s_max = s_loc * rk.size(ca)
    slots = mdl._prefix_slots(src, s_max)
    n_slots = slots.shape[2]
    if n_slots <= s_loc:
        # the prefix lies in the first slice (the audio decoder's BOS row):
        # its rows gathered over the head axes, written where that slice is
        piece = rk.all_gather(slots, kh, axis=1)
        if rk.index(ca) == 0:
            dst[:, :, :n_slots] = piece
        return
    full = F.pad(slots, (0, 0, 0, s_max - n_slots))
    if kh and ca[-len(kh):] == kh:
        piece = rk.all_to_all(rk.local(full, 2, ca[:-len(kh)]), kh,
                              split_axis=2, concat_axis=1)
    else:
        piece = rk.local(rk.all_gather(full, kh, axis=1), 2, ca)
    n = max(0, min(n_slots - rk.index(ca) * s_loc, s_loc))
    dst[:, :, :n] = piece[:, :, :n]


def _write_token(rk, ca: Axes, dst, new, pos) -> None:
    """dst (b, KV, S_loc, hd), the rank's slice over `ca` of one layer's
    cache, <- new (b, KV, hd) at the global positions `pos` (b,) it holds;
    the rows whose position lies on another rank keep their slot."""
    s_loc = dst.shape[2]
    local = pos.long() - rk.index(ca) * s_loc
    own = (local >= 0) & (local < s_loc)
    idx = local.clamp(0, s_loc - 1)
    rows = torch.arange(dst.shape[0], device=dst.device)
    dst[rows, :, idx] = torch.where(own[:, None, None], new.to(dst.dtype),
                                    dst[rows, :, idx])


# ---------------------------------------------------------------------------
# per-rank steps
# ---------------------------------------------------------------------------
def _embed_rows(rk, cfg: ModelConfig, pl: Plan, p, ps, batch: Dict[str, Any]):
    """(the rank's rows of the embedded prompt (b, S / |seq|, d) — vlm: the
    patch embeddings first —, the tokens gathered over their sequence)."""
    tokens = rk.all_gather(batch["tokens"], pl.tok_seq, axis=1)
    e, va = _embed(rk, cfg, p, ps, tokens,
                   batch["embeds"] if cfg.family == "vlm" else None)
    return _reduce_to(rk, e, va, pl.seq), tokens


def _layer(rk, cfg: ModelConfig, pl: Plan, p, ps, x, positions, *, impl: str,
           balance: bool = False):
    """One dense or moe layer (`model._dense_layer`, `_moe_layer`) on the
    rank's residual rows: (x, the layer's (K, V) heads of the rank, with
    `balance` moe's load-balance loss, else None).  moe routes with the
    config's capacity factor, as the reference's prefill and train steps
    do."""
    eps = cfg.norm_eps
    h = L.rms_norm(rk.all_gather(x, pl.seq, axis=1), p["ln1"], eps)
    h, kv = _attention(rk, cfg, pl, p["attn"], ps["attn"], h, positions, impl=impl)
    x = x + h
    h = L.rms_norm(rk.all_gather(x, pl.seq, axis=1), p["ln2"], eps)
    if cfg.family == "moe":
        y, lb = _moe(rk, cfg, pl, p["moe"], ps["moe"], h, pl.seq, balance=balance,
                     impl=impl)
        return x + y, kv, lb
    return x + _mlp(rk, p["mlp"], ps["mlp"], h, pl.seq), kv, None


def _enc_layer(rk, cfg: ModelConfig, pl: Plan, p, ps, x, positions, *, impl: str):
    """One encoder layer (`model._encoder_layer`) on the rank's batch rows x
    (b, F, d), whole over "model" as the reference leaves the encoder's
    residual (`pl`: the encoder's plan): attention not causal, RoPE on the
    frame positions, wo's and w_down's partial sums all-reduced."""
    eps = cfg.norm_eps
    h, _ = _attention(rk, cfg, pl, p["attn"], ps["attn"], L.rms_norm(x, p["ln1"], eps),
                      positions, impl=impl, causal=False)
    x = x + h
    return x + _mlp(rk, p["mlp"], ps["mlp"], L.rms_norm(x, p["ln2"], eps), ())


def _encode(rk, cfg: ModelConfig, pl: Plan, p, ps, frames, *, impl: str,
            remat: bool = False):
    """The encoder over the rank's batch rows of `frames` (gathered over
    their sequence) and `enc_norm`: the encoder's output (b, F, d), whole;
    with `remat` each layer under `rk.remat` (the reference's
    ``jax.checkpoint`` of its scanned body)."""
    x = rk.all_gather(frames, pl.enc.tok_seq, axis=1).to(getattr(torch, cfg.dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    for li, (pl_, ps_) in enumerate(zip(p["encoder"], ps["encoder"])):
        def layer(rk, x, pl_=pl_, ps_=ps_):
            return _enc_layer(rk, cfg, pl.enc, pl_, ps_, x, positions, impl=impl)
        x = rk.remat(f"encoder layer {li}", layer, x) if remat else layer(rk, x)
    return L.rms_norm(x, p["enc_norm"], cfg.norm_eps)


def _dec_layer(rk, cfg: ModelConfig, pl: Plan, p, ps, x, enc, positions, *, impl: str):
    """One decoder layer (`model._decoder_layer`) on the rank's residual
    rows x, the encoder's output `enc` (b, F, d): (x, its self (K, V) heads,
    its cross (K, V) heads).  The residual is gathered over its sequence
    and whole over "model" inside the layer (the reference constrains
    neither its attention's input nor its MLP's), the row-parallel sums
    all-reduced, and cut back to the rank's rows at the end."""
    eps = cfg.norm_eps
    x = rk.all_gather(x, pl.seq, axis=1)
    h, kv = _attention(rk, cfg, pl, p["attn"], ps["attn"], L.rms_norm(x, p["ln1"], eps),
                       positions, impl=impl, seq=())
    x = x + h
    h, cross = _attention(rk, cfg, pl, p["xattn"], ps["xattn"],
                          L.rms_norm(x, p["ln2"], eps), positions, impl=impl, seq=(),
                          enc=enc)
    x = x + h
    x = x + _mlp(rk, p["mlp"], ps["mlp"], L.rms_norm(x, p["ln3"], eps), ())
    return rk.local(x, 1, pl.seq), kv, cross


def prefill_rank(rk, cfg: ModelConfig, pl: Plan, p, ps, batch: Dict[str, Any],
                 cache: Dict[str, Any], *, impl: str = "auto"):
    """One rank's `model.prefill`: (its (b, V / |vocab|) last-token
    logits, its cache with the K/V slices written in place and "len" set;
    audio: the encoder's output projected into the cross cache's slices
    and "cross_len" set)."""
    audio = cfg.family == "audio"
    enc = _encode(rk, cfg, pl, p, ps, batch["frames"], impl=impl) if audio else None
    x, _ = _embed_rows(rk, cfg, pl, p, ps, batch)
    b, S = x.shape[0], x.shape[1] * rk.size(pl.seq)
    positions = torch.arange(S, device=x.device)
    every = cfg.attn_every if cfg.family == "hybrid" else 0
    for li, (pl_, ps_) in enumerate(zip(p["layers"], ps["layers"])):
        if audio:
            names, i = ("k", "v"), li
            x, (k, v), (ck, cv) = _dec_layer(rk, cfg, pl, pl_, ps_, x, enc, positions,
                                              impl=impl)
            _write_prefix(rk, pl, cache["cross_k"][li], ck, pl.cross_seq)
            _write_prefix(rk, pl, cache["cross_v"][li], cv, pl.cross_seq)
        elif cfg.family in ("ssm", "hybrid"):
            # the state cache is whole over "model": every rank writes the
            # same values
            x, (conv, last) = _mamba(rk, cfg, pl, pl_, ps_, x, impl=impl, state=True)
            cache["ssm"].conv[li].copy_(conv)
            cache["ssm"].ssm[li].copy_(last)
            if not every or (li + 1) % every:
                continue
            names, i = ("sh_k", "sh_v"), (li + 1) // every - 1
            x, (k, v), _ = _layer(rk, cfg, pl, p["shared"], ps["shared"], x, positions,
                                  impl=impl)
        else:
            names, i = ("k", "v"), li
            x, (k, v), _ = _layer(rk, cfg, pl, pl_, ps_, x, positions, impl=impl)
        _write_prefix(rk, pl, cache[names[0]][i], k)
        _write_prefix(rk, pl, cache[names[1]][i], v)
    last = rk.all_gather(x[:, -1:], pl.seq, axis=1)[:, -1]
    cache = dict(cache, len=torch.full((b,), S, dtype=torch.int32, device=x.device))
    if audio:
        cache["cross_len"] = torch.full((b,), enc.shape[1], dtype=torch.int32,
                                        device=x.device)
    return _lm_head(rk, cfg, p, ps, last), cache


def _nll(rk, va: Axes, logits, labels):
    """Summed f32 negative log-likelihood of the labels >= 0 of the rank's
    rows (`model._chunk_nll`), its logits the vocabulary slice of the
    ranks of `va`: the slices' max (held constant, as ``log_softmax``
    holds it) and sum of exponentials merged by pmax and psum, the label's
    logit taken on the rank whose slice holds it and psummed."""
    lg = logits.float()
    n = lg.shape[-1]
    m = rk.pmax(lg.amax(-1, keepdim=True).detach(), va)
    lse = m[..., 0] + torch.log(rk.psum(torch.exp(lg - m).sum(-1), va))
    local = labels.long() - rk.index(va) * n
    hit = (labels >= 0) & (local >= 0) & (local < n)
    picked = torch.where(hit, torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0],
                         torch.zeros((), dtype=lg.dtype, device=lg.device))
    return ((lse - rk.psum(picked, va)) * (labels >= 0)).sum()


def _train_units(cfg: ModelConfig, pl: Plan, p, ps, positions, *, impl: str):
    """(tag, fn(rank, x, *more)) per unit of the reference's remat: a layer
    (moe: fn gives the residual and the layer's load-balance loss); a
    hybrid segment of `attn_every` Mamba2 layers and the shared block; an
    audio decoder layer, `more` the encoder's output (the encoder's layers:
    `_encode`)."""
    if cfg.family == "audio":
        for li, (pl_, ps_) in enumerate(zip(p["layers"], ps["layers"])):
            def dec(rk, x, enc, pl_=pl_, ps_=ps_):
                return _dec_layer(rk, cfg, pl, pl_, ps_, x, enc, positions, impl=impl)[0]
            yield f"decoder layer {li}", dec
        return
    if cfg.family not in ("ssm", "hybrid"):
        for li, (pl_, ps_) in enumerate(zip(p["layers"], ps["layers"])):
            def layer(rk, x, pl_=pl_, ps_=ps_):
                x, _, lb = _layer(rk, cfg, pl, pl_, ps_, x, positions, impl=impl,
                                  balance=True)
                return x if lb is None else (x, lb)
            yield f"layer {li}", layer
        return
    hybrid = cfg.family == "hybrid"
    every = cfg.attn_every if hybrid else 1
    for si in range(len(p["layers"]) // every):
        def unit(rk, x, lis=range(si * every, (si + 1) * every)):
            for li in lis:
                x, _ = _mamba(rk, cfg, pl, p["layers"][li], ps["layers"][li], x, impl=impl)
            if hybrid:
                x, _, _ = _layer(rk, cfg, pl, p["shared"], ps["shared"], x, positions,
                                 impl=impl)
            return x
        yield f"{'segment' if hybrid else 'layer'} {si}", unit


def loss_rank(rk, cfg: ModelConfig, pl: Plan, p, ps, batch: Dict[str, Any], *,
              impl: str = "torch", remat: bool = True, loss_chunk: int = 512):
    """One rank's `model.loss_fn`: the global mean next-token cross entropy
    (every rank a copy).  The layers as `prefill_rank`'s without the cache
    writes, each unit of the reference's remat (`_train_units`: a layer, a
    hybrid segment) under `rk.remat` with `remat`; the logits as the reference
    constrains them, ("batch", None, "vocab"): the sequence gathered (vlm:
    the patch prefix cut off) and the vocabulary over the lm head's axes,
    the padded vocabulary masked on each slice; the f32 loss per chunk of
    the largest divisor of S at or below `loss_chunk`, each under
    `rk.remat` (`_nll`); the sum and the count of valid labels psummed over
    the batch axes before the division.  A rank's labels are gathered over
    their sequence axes (one sequence: every rank holds every row).  moe
    adds 0.01 x the mean over layers of each layer's load-balance loss
    (`_moe`), which the remat returns beside the residual.  audio: the
    encoder first (`_encode`, a remat per layer), its output an input of
    every decoder layer's remat; the loss over the decoder's positions."""
    more = ((_encode(rk, cfg, pl, p, ps, batch["frames"], impl=impl, remat=remat),)
            if cfg.family == "audio" else ())
    x, tokens = _embed_rows(rk, cfg, pl, p, ps, batch)
    S = x.shape[1] * rk.size(pl.seq)
    positions = torch.arange(S, device=x.device)
    lbs = []
    for tag, unit in _train_units(cfg, pl, p, ps, positions, impl=impl):
        x = rk.remat(tag, unit, x, *more) if remat else unit(rk, x, *more)
        if cfg.family == "moe":
            x, lb = x
            lbs.append(lb)
    x = rk.all_gather(x, pl.seq, axis=1)[:, S - tokens.shape[1]:]
    logits = _lm_head(rk, cfg, p, ps, x)
    labels = batch.get("labels")
    labels = (F.pad(tokens[:, 1:], (0, 1), value=-1) if labels is None
              else rk.all_gather(labels, pl.tok_seq, axis=1))
    va = _model(ps["lm_head"][1])
    St = logits.shape[1]
    ck = min(loss_chunk, St)
    while St % ck:
        ck -= 1
    sums = []
    for i in range(0, St, ck):
        def nll(rk, lg, lb=labels[:, i:i + ck]):
            return _nll(rk, va, lg, lb)
        lg = logits[:, i:i + ck]
        sums.append(rk.remat(f"loss chunk {i}", nll, lg)
                    if torch.is_grad_enabled() and lg.requires_grad else nll(rk, lg))
    total = rk.psum(torch.stack(sums).sum(), pl.batch)
    count = rk.psum((labels >= 0).sum(), pl.batch)
    loss = total / count.clamp_min(1)
    return loss + 0.01 * torch.stack(lbs).mean() if lbs else loss


def _decode(rk, ca: Axes, q, k, v, lens, *, window: int, impl: str):
    """Decode attention of q (b, H, hd) over the rank's slices k, v (b, KV,
    S_max / |ca|, hd) of a cache whose sequence is cut over `ca`: each
    rank's f32 partial merged by LSE across `ca`
    (`distributed_decode_local`), or B2 over a whole cache."""
    if not ca:
        return ops.decode_attention(q, k, v, lens, sliding_window=window, impl=impl)

    def decode(mesh, q, k, v, lens):
        return distributed_decode_local(q, k, v, lens, mesh=mesh, seq_axes=ca,
                                        sliding_window=window)
    return rk.meet(ca, "decode", decode, q, k, v, lens)


def _decode_layer(rk, cfg: ModelConfig, pl: Plan, p, ps, x, kc, vc, clen, *,
                  impl: str, ring_buffer: bool, cross=None):
    """One dense, vlm, moe or audio decoder layer of the serve step, or the
    hybrid's shared block, on the rank's batch rows x (b, d): the token's
    K/V written into kc / vc, the rank's (b, KV, S_max / |cache_seq|, hd)
    slices of the layer's cache, where they hold its position.  audio:
    `cross` = (the rank's slices of the layer's cross K and V over the
    plan's cross_seq, cross_len), read by the cross attention."""
    eps, theta = cfg.norm_eps, cfg.rope_theta
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b = x.shape[0]
    ca = pl.cache_seq
    window = 0 if ring_buffer else cfg.sliding_window
    a, as_ = p["attn"], ps["attn"]
    h = L.rms_norm(x, p["ln1"], eps)
    # every head on every rank: the decode reads q whole, the cache holds
    # every K/V head
    q, k, v = (rk.all_gather(*_col(rk, h, a, as_, w, "b" + w[1]), axis=-1)
               for w in ("wq", "wk", "wv"))
    q = L.rope(q.reshape(b, 1, H, hd), clen[:, None], theta)[:, 0]
    k = L.rope(k.reshape(b, 1, KV, hd), clen[:, None], theta)[:, 0]
    s_max = kc.shape[2] * rk.size(ca)
    pos = clen % s_max if ring_buffer else clen
    _write_token(rk, ca, kc, k, pos)
    _write_token(rk, ca, vc, v.reshape(b, KV, hd), pos)
    eff = torch.clamp(clen + 1, max=s_max) if ring_buffer else clen + 1
    o = _decode(rk, ca, q, kc, vc, eff, window=window, impl=impl)
    x = x + _row(rk, o.reshape(b, H * hd), (), a, as_, "wo", ())
    h = L.rms_norm(x, p["ln2"], eps)
    if cfg.family == "moe":
        cf = min(float(cfg.decode_capacity_factor), float(cfg.num_experts))
        return x + _moe(rk, cfg, pl, p["moe"], ps["moe"], h[:, None], (), cf,
                        impl=impl)[0][:, 0]
    if cross is not None:
        xk, xv, xlen = cross
        q = rk.all_gather(*_col(rk, h, p["xattn"], ps["xattn"], "wq", "bq"), axis=-1)
        o = _decode(rk, pl.cross_seq, q.reshape(b, H, hd), xk, xv, xlen, window=0,
                    impl=impl)
        x = x + _row(rk, o.reshape(b, H * hd), (), p["xattn"], ps["xattn"], "wo", ())
        h = L.rms_norm(x, p["ln3"], eps)
    return x + _mlp(rk, p["mlp"], ps["mlp"], h, ())


def serve_rank(rk, cfg: ModelConfig, pl: Plan, p, ps, cache: Dict[str, Any],
               token: torch.Tensor, *, impl: str = "auto", ring_buffer: bool = False):
    """One rank's `model.decode_step`: (its (b, V / |vocab|) logits, its
    cache with the token's K/V written where its slice holds the position
    and "len" advanced).  moe routes the batch as one group (T = B) with
    the capacity factor min(decode_capacity_factor, E).  ssm and hybrid:
    `mamba2.mamba2_step` of the rank's batch rows with every head (its
    weights whole over "model", no collective inside), the new states
    written once every rank has read the old ones (the state cache is
    whole over "model", so the ranks of one batch slice share it).  audio:
    each decoder layer's cross attention over the rank's slice of the cross
    cache, nothing written there."""
    e, va = _embed(rk, cfg, p, ps, token)
    x = rk.psum(e, va)
    clen = cache["len"]
    kw = dict(impl=impl, ring_buffer=ring_buffer)
    if cfg.family not in ("ssm", "hybrid"):
        for li, (pl_, ps_) in enumerate(zip(p["layers"], ps["layers"])):
            cross = ((cache["cross_k"][li], cache["cross_v"][li], cache["cross_len"])
                     if cfg.family == "audio" else None)
            x = _decode_layer(rk, cfg, pl, pl_, ps_, x, cache["k"][li], cache["v"][li],
                              clen, cross=cross, **kw)
        return _lm_head(rk, cfg, p, ps, x), dict(cache, len=clen + 1)
    every = cfg.attn_every if cfg.family == "hybrid" else 0
    conv, ssm = cache["ssm"]
    new = []
    for li, (pl_, ps_) in enumerate(zip(p["layers"], ps["layers"])):
        w = {k: _weight(rk, v, ps_["mamba"][k]) for k, v in pl_["mamba"].items()}
        h, st = M.mamba2_step(cfg, w, L.rms_norm(x, pl_["ln"], cfg.norm_eps),
                              M.SSMState(conv[li], ssm[li]))
        new.append(st)
        x = x + h
        if every and (li + 1) % every == 0:
            si = (li + 1) // every - 1
            x = _decode_layer(rk, cfg, pl, p["shared"], ps["shared"], x, cache["sh_k"][si],
                              cache["sh_v"][si], clen, **kw)
    rk.barrier()
    for li, st in enumerate(new):
        conv[li].copy_(st.conv)
        ssm[li].copy_(st.ssm)
    return _lm_head(rk, cfg, p, ps, x), dict(cache, len=clen + 1)
