"""The shard_map boundary for whole steps: the counterpart of what XLA's
SPMD partitioner does to the reference's ``launch/steps.py`` under a mesh.

`shard_tree` cuts a tree (params, batch, cache, token) by the spec trees of
`launch/shardings.py` into one local tree per rank of a `GangMesh`; where a
rank lies on the tensor's device its piece is a view, with no copy, so a
full-width model's shards on ranks that share one card cost no memory.
`unshard_tree` joins the pieces back.  `run_lockstep` runs one body per
rank (`sp.common.lockstep`); a body reaches the other ranks only through
its `Rank`'s collectives, which the mesh counts by kind.  `prefill` and
`serve` are the partitioned prefill and serve steps of every family
(`models/tp.FAMILIES`: moe with its experts over "model"; ssm and hybrid
with the Mamba2 scan over "model" by heads or rows, the hybrid's shared
block tensor-parallel; audio's encoder, decoder and cross cache),
`loss_and_grads` and `train` their FSDP train step;
`steps.build_prefill_step`, `build_serve_step` and `build_train_step` run
them when given `Sharded` arguments.  Under
autograd the ranks' pieces form one graph (each collective one node over
every rank's tensor, `sp.common.collective`), `Rank.remat` checkpoints
one layer of every rank at once, and one backward runs from the caller's
thread.

A mesh whose ranks are all "meta" (the production meshes of the dry run)
computes shapes only, and this module alone knows it: its `Sharded` holds
rank 0's tree alone and only rank 0's body runs.  Each collective then
runs on a `_MetaGroup`, the mesh of its own axes with every member holding
rank 0's shapes (which SPMD gives every member): one member's result,
computed once and handed to all, its bytes counted for rank 0, as the
reference's ``collective_bytes_from_hlo`` counts one device's program.
The group is `uniform`: under autograd a collective is one node over rank
0's tensor (`sp.common.collective`), and the sequence-sharded decode
(`sp.decode.distributed_decode_local`) computes one member's partial and
hands it to all before the group's pmax and psums, so what rank 0's body
holds and computes is what one device of the SPMD program does (the dry
run's per-device account, `launch/dryrun.py`).
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.shardings import walk
from repro_torch.models import tp
from repro_torch.models.sharding import P, PartitionSpec
from repro_torch.sp.common import Axes, GangMesh, as_axes, collective, lockstep
from repro_torch.training import optimizer


@dataclass
class Sharded:
    """A tree cut over `mesh`: `local[r]` is rank r's tree (on a meta mesh
    rank 0's alone), `specs` the spec tree it was cut by."""
    local: List[Any]
    specs: Any
    mesh: GangMesh


def _piece(x: torch.Tensor, spec, mesh: GangMesh, rank: int) -> torch.Tensor:
    """Rank `rank`'s block of `x` under `spec`, on its device."""
    for dim, entry in enumerate(spec):
        axes = as_axes(entry)
        if axes:
            n = mesh.axis_size(axes)
            if x.shape[dim] % n:
                raise ValueError(f"shard_tree: dim {dim} of {tuple(x.shape)} does not "
                                 f"divide over {axes} ({n})")
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.axis_index(rank, axes) * size, size)
    return x.to(mesh.devices[rank])


def _is_meta(mesh: GangMesh) -> bool:
    return all(d.type == "meta" for d in mesh.devices)


def shard_tree(tree, specs, mesh: GangMesh) -> Sharded:
    """`tree` (a tensor or a tree of them) cut by `specs` over `mesh`."""
    ranks = [0] if _is_meta(mesh) else range(mesh.n_ranks)
    if torch.is_tensor(tree):
        return Sharded([_piece(tree, specs, mesh, r) for r in ranks], specs, mesh)
    return Sharded([walk(lambda path, x, n, s, r=r: _piece(x, s, mesh, r), tree, specs)
                    for r in ranks], specs, mesh)


def _global_shape(local: torch.Tensor, spec, mesh: GangMesh):
    return tuple(n * (mesh.axis_size(spec[d]) if d < len(spec) else 1)
                 for d, n in enumerate(local.shape))


def _join(spec, pieces: List[torch.Tensor], mesh: GangMesh) -> torch.Tensor:
    """The whole tensor of `pieces` (one per rank) under `spec`, on rank
    0's device: each block from the rank at coordinate 0 of every axis the
    spec does not use."""
    used = {a for e in spec for a in as_axes(e)}
    out = pieces[0].new_empty(_global_shape(pieces[0], spec, mesh), device=mesh.devices[0])
    for r, x in enumerate(pieces):
        if any(mesh.axis_index(r, a) for a in mesh.axis_names if a not in used):
            continue
        idx = tuple(slice(mesh.axis_index(r, spec[d]) * n, (mesh.axis_index(r, spec[d]) + 1) * n)
                    if d < len(spec) and as_axes(spec[d]) else slice(None)
                    for d, n in enumerate(x.shape))
        out[idx] = x.to(out.device)
    return out


def unshard_tree(sharded: Sharded):
    """The inverse of `shard_tree`: the whole tree on rank 0's device."""
    if _is_meta(sharded.mesh):
        raise ValueError("unshard_tree: a meta mesh holds rank 0's shapes only")
    if torch.is_tensor(sharded.local[0]):
        return _join(sharded.specs, sharded.local, sharded.mesh)
    return walk(lambda path, spec, n, *pieces: _join(spec, list(pieces), sharded.mesh),
                sharded.specs, *sharded.local)


class _MetaGroup(GangMesh):
    """The meta mesh of one collective's axes, every member holding the same
    shapes: each collective computes one member's result (tiled, as
    `GangMesh`'s), counts its bytes for rank 0 of `parent` (a group of one
    counts nothing) and hands it to every member.  A result is a storage of
    its own, as on a device."""

    uniform = True

    def __init__(self, parent: GangMesh, axes: Tuple[str, ...]):
        shape = tuple(parent.shape[a] for a in axes)
        super().__init__([torch.device("meta")] * math.prod(shape), shape, axes)
        self.parent = parent

    def _one(self, kind: str, out: torch.Tensor) -> List[torch.Tensor]:
        if self.n_ranks > 1:
            n = out.numel() * out.element_size()
            self.parent.collective_bytes[0][kind] += n
            self.parent.collective_bytes[0]["total"] += n
        return [out] * self.n_ranks

    def ppermute(self, xs, axes):
        return self._one("collective-permute", xs[0].clone())

    def all_to_all(self, xs, axes, *, split_axis: int, concat_axis: int):
        piece = xs[0].tensor_split(self.axis_size(axes), split_axis)[0]
        return self._one("all-to-all", torch.cat([piece] * self.axis_size(axes), concat_axis))

    def all_gather(self, xs, axes, *, axis: int):
        return self._one("all-gather", torch.cat([xs[0]] * self.axis_size(axes), axis))

    def psum(self, xs, axes):
        return self._one("all-reduce", xs[0].clone())

    pmax = psum

    def psum_scatter(self, xs, axes, *, scatter_dimension: int):
        piece = xs[0].tensor_split(self.axis_size(axes), scatter_dimension)[0]
        return self._one("reduce-scatter", piece.clone(memory_format=torch.contiguous_format))


#: a meta mesh's groups, one per tuple of axes (the backward of a
#: collective counts on its group after the forward's call has returned)
_META_GROUPS: "weakref.WeakKeyDictionary[GangMesh, dict]" = weakref.WeakKeyDictionary()


def _meta_group(mesh: GangMesh, axes: Tuple[str, ...]) -> _MetaGroup:
    groups = _META_GROUPS.setdefault(mesh, {})
    if axes not in groups:
        groups[axes] = _MetaGroup(mesh, axes)
    return groups[axes]


class _Remat(torch.autograd.Function):
    """`stage` (every rank's tensor -> every rank's result) run without
    autograd, its inputs kept; the backward runs it again under autograd
    (the ranks in lockstep once more) and backpropagates through that run
    from the thread that runs the backward, the parameters' gradients
    accumulating into their `.grad`: ``jax.checkpoint`` around one layer
    of every rank.  `anchor`, an empty tensor that requires grad, makes
    the results require grad where no input does (the encoder's first
    layer, on the frames): the parameters the stage closes over are not
    inputs here."""

    @staticmethod
    def forward(ctx, stage, anchor, *xs):
        ctx.stage = stage
        ctx.save_for_backward(*xs)
        return tuple(stage(list(xs)))

    @staticmethod
    def backward(ctx, *grads):
        xs = [x.detach().requires_grad_(x.requires_grad) for x in ctx.saved_tensors]
        with torch.enable_grad():
            ys = ctx.stage(xs)
        pairs = [(y, g) for y, g in zip(ys, grads) if y.requires_grad]
        torch.autograd.backward([y for y, _ in pairs], [g for _, g in pairs])
        return (None, None, *(x.grad if x.requires_grad else None for x in xs))


def _remat(stage, *xs):
    """`_Remat` of `stage` over `xs`."""
    anchor = torch.empty(0, requires_grad=torch.is_grad_enabled())
    return _Remat.apply(stage, anchor, *xs)


class Rank:
    """One rank's handle inside `run_lockstep`: its index over mesh axes,
    its block of a tensor, and the collectives it joins with the other
    ranks of its groups (``jax.lax`` semantics, tiled).  A collective over
    axes of extent 1 is the identity and counts nothing."""

    def __init__(self, mesh: GangMesh, rank: int, meet=None):
        self.mesh, self.rank, self._meet = mesh, rank, meet

    def size(self, axes: Axes) -> int:
        return self.mesh.axis_size(axes)

    def index(self, axes: Axes) -> int:
        return self.mesh.axis_index(self.rank, axes)

    def local(self, x: torch.Tensor, dim: int, axes: Axes) -> torch.Tensor:
        """The rank's piece of `x` along `dim` over `axes` (a view)."""
        n = self.size(axes)
        if n == 1:
            return x
        size = x.shape[dim] // n
        return x.narrow(dim, self.index(axes) * size, size)

    def meet(self, axes: Axes, tag: str, fn: Callable, *args):
        """``fn(mesh, *lists)[rank]``: `fn` run once over every rank's
        `args` (a list per argument), as the mesh's own collectives take
        them.  On a meta mesh, over the mesh of `axes` alone, every member
        holding this rank's args (`_MetaGroup`)."""
        if self._meet is not None:
            return self._meet(tag, fn, args)
        sub = _meta_group(self.mesh, as_axes(axes))
        return fn(sub, *([a] * sub.n_ranks for a in args))[0]

    def _collective(self, name: str, x, axes: Axes, **kw):
        axes = as_axes(axes)
        if self.size(axes) == 1:
            return x
        return self.meet(axes, f"{name} over {axes}",
                         lambda m, xs: collective(m, name, xs, axes, **kw), x)

    def barrier(self) -> None:
        """Wait until every rank has come here."""
        self.meet(self.mesh.axis_names, "barrier", lambda m: [None] * m.n_ranks)

    def remat(self, tag: str, fn: Callable, *xs: torch.Tensor):
        """``fn(rank, *xs)`` (a tensor, or a tuple of tensors: a moe layer's
        residual and its load-balance loss), every rank's call run in
        lockstep as one activation checkpoint (`_Remat`): the ranks meet
        here, the call of every rank runs without autograd, and the
        backward runs them all again and gives each of `xs` its gradient
        (an audio decoder layer's residual and the encoder's output: a
        tensor `fn` closed over would take its gradient from inside the
        backward, once per layer).  A per-rank checkpoint could not: its
        saved-tensor hooks are the rank thread's, and its recompute would
        reach the collectives one rank at a time."""
        single, n = [], len(xs)

        def outs(rk, *ys):
            out = fn(rk, *ys)
            single.append(torch.is_tensor(out))
            return (out,) if torch.is_tensor(out) else tuple(out)
        if self._meet is None:
            got = _remat(lambda ys: list(outs(self, *ys)), *xs)
        else:
            def stage(mesh, fns, *inputs):
                ranks = len(fns)
                flat = _remat(lambda ys: [t for o in run_lockstep(
                    mesh, lambda rk: fns[rk.rank](rk, *ys[rk.rank * n:(rk.rank + 1) * n]))
                    for t in o], *(a[r] for r in range(ranks) for a in inputs))
                k = len(flat) // ranks
                return [flat[r * k:(r + 1) * k] for r in range(ranks)]
            got = self.meet((), tag, stage, outs, *xs)
        return got[0] if single[0] else tuple(got)

    def all_gather(self, x, axes: Axes, *, axis: int):
        return self._collective("all_gather", x, axes, axis=axis)

    def psum(self, x, axes: Axes):
        return self._collective("psum", x, axes)

    def pmax(self, x, axes: Axes):
        return self._collective("pmax", x, axes)

    def psum_scatter(self, x, axes: Axes, scatter_dimension: int):
        return self._collective("psum_scatter", x, axes,
                                scatter_dimension=scatter_dimension)

    def all_to_all(self, x, axes: Axes, *, split_axis: int, concat_axis: int):
        return self._collective("all_to_all", x, axes, split_axis=split_axis,
                                concat_axis=concat_axis)


def run_lockstep(mesh: GangMesh, body: Callable[[Rank], Any]) -> list:
    """``[body(Rank(mesh, r)) for r in ranks]``, the bodies in lockstep
    (`sp.common.lockstep`) under the caller's grad mode (a thread starts
    with grad enabled, whatever its creator's); on a meta mesh rank 0's
    alone.  Every rank must reach the same collectives in the same order:
    one that meets another raises."""
    grad = torch.is_grad_enabled()
    if _is_meta(mesh):
        return [body(Rank(mesh, 0))]

    def run(r, meet):
        with torch.set_grad_enabled(grad):
            return body(Rank(mesh, r, meet))

    def collective(calls):
        tags = {tag for tag, _, _ in calls}
        if len(tags) != 1:
            raise RuntimeError(f"run_lockstep: the ranks meet at different "
                               f"collectives: {sorted(tags)}")
        fn = calls[0][1]
        return fn(mesh, *(list(a) for a in zip(*(args for _, _, args in calls))))
    return lockstep(mesh.n_ranks, run, collective)


# ---------------------------------------------------------------------------
# the partitioned steps
# ---------------------------------------------------------------------------
def _mesh_of(*trees: Sharded) -> GangMesh:
    mesh = trees[0].mesh
    if any(t.mesh is not mesh for t in trees):
        raise ValueError("partitioned step: the arguments are cut over different meshes")
    if not _is_meta(mesh) and any(len(t.local) != mesh.n_ranks for t in trees):
        raise ValueError("partitioned step: an argument lacks a rank's tree")
    return mesh


def _kv_spec(cache: Sharded):
    """The spec of the attention cache the plan lays out: "k", the hybrid's
    shared block's "sh_k", none for ssm."""
    return cache.specs.get("k", cache.specs.get("sh_k"))


def _frames(cfg: ModelConfig, batch: Sharded) -> int:
    """audio: the encoder's frames per sequence (0 for the other families)."""
    if cfg.family != "audio":
        return 0
    return _global_shape(batch.local[0]["frames"], batch.specs["frames"], batch.mesh)[1]


def prefill(cfg: ModelConfig, params: Sharded, batch: Sharded, cache: Sharded, *,
            impl: str = "auto", long_context: bool = False):
    """`model.prefill` partitioned: (last-token logits (B, V) sharded over
    the batch and vocab axes, the cache) as `Sharded`.  The caches' pieces
    are written in place."""
    mesh = _mesh_of(params, batch, cache)
    tok = batch.local[0]["tokens"]
    B, S = _global_shape(tok, batch.specs["tokens"], mesh)
    if cfg.family == "vlm":
        S += batch.local[0]["embeds"].shape[1]
    pl = tp.plan(cfg, mesh, batch=B, seq=S, long_context=long_context,
                 tok_spec=batch.specs["tokens"], cache_spec=_kv_spec(cache),
                 frames=_frames(cfg, batch), cross_spec=cache.specs.get("cross_k"))
    with torch.no_grad():
        outs = run_lockstep(mesh, lambda rk: tp.prefill_rank(
            rk, cfg, pl, params.local[rk.rank], params.specs, batch.local[rk.rank],
            cache.local[rk.rank], impl=impl))
    return (Sharded([o[0] for o in outs], _logits_spec(pl, params), mesh),
            Sharded([o[1] for o in outs], cache.specs, mesh))


def serve(cfg: ModelConfig, params: Sharded, cache: Sharded, token: Sharded, *,
          impl: str = "auto", ring_buffer: bool = False, long_context: bool = False):
    """`model.decode_step` partitioned: (logits (B, V) sharded over the
    batch and vocab axes, the cache) as `Sharded`."""
    mesh = _mesh_of(params, cache, token)
    (B,) = _global_shape(token.local[0], token.specs, mesh)
    pl = tp.plan(cfg, mesh, batch=B, seq=1, long_context=long_context,
                 tok_spec=token.specs, cache_spec=_kv_spec(cache),
                 cross_spec=cache.specs.get("cross_k"))
    with torch.no_grad():
        outs = run_lockstep(mesh, lambda rk: tp.serve_rank(
            rk, cfg, pl, params.local[rk.rank], params.specs, cache.local[rk.rank],
            token.local[rk.rank], impl=impl, ring_buffer=ring_buffer))
    return (Sharded([o[0] for o in outs], _logits_spec(pl, params), mesh),
            Sharded([o[1] for o in outs], cache.specs, mesh))


def _logits_spec(pl: tp.Plan, params: Sharded) -> PartitionSpec:
    """(batch, vocab): the batch's axes, the lm head's column axes."""
    return P(pl.batch, tuple(a for a in as_axes(params.specs["lm_head"][1])
                             if a == "model"))


def _train_plan(cfg: ModelConfig, params: Sharded, batch: Sharded) -> tp.Plan:
    """The layouts of the train step: the reference's fsdp rules, not long
    context (its ``build_train_step`` default)."""
    B, S = _global_shape(batch.local[0]["tokens"], batch.specs["tokens"], params.mesh)
    if cfg.family == "vlm":
        S += batch.local[0]["embeds"].shape[1]
    return tp.plan(cfg, params.mesh, batch=B, seq=S, long_context=False,
                   tok_spec=batch.specs["tokens"], frames=_frames(cfg, batch))


def loss_and_grads(cfg: ModelConfig, params: Sharded, batch: Sharded, *,
                   impl: str = "torch", remat: bool = True):
    """`steps.loss_and_grads` partitioned: (the loss, the gradients as a
    `Sharded` cut like the params).  One autograd graph spans the ranks
    (the collectives join their pieces, `sp.common.collective`), each
    rank's pieces of the params are leaves of their own, and one backward
    runs from this thread over one rank's copy of the global loss (a
    backward over every copy would scale the gradients by the ranks).
    Each gradient is then summed over the axes its leaf is not cut over: a
    replicated leaf's gradient is partial on each rank (its heads, its
    batch rows); over the axes a leaf is cut over, the backward of its
    all-gather has reduce-scattered it already."""
    mesh = _mesh_of(params, batch)
    pl = _train_plan(cfg, params, batch)
    leaves = [walk(lambda path, x, n: x.detach().requires_grad_(True), t)
              for t in params.local]
    with torch.enable_grad():
        losses = run_lockstep(mesh, lambda rk: tp.loss_rank(
            rk, cfg, pl, leaves[rk.rank], params.specs, batch.local[rk.rank],
            impl=impl, remat=remat))
        losses[0].backward()

    def reduce(rk):
        return walk(lambda path, x, n, spec: rk.psum(
            torch.zeros_like(x) if x.grad is None else x.grad,
            tuple(a for a in mesh.axis_names if a not in
                  {b for e in spec for b in as_axes(e)})),
            leaves[rk.rank], params.specs)
    with torch.no_grad():
        grads = run_lockstep(mesh, reduce)
    return losses[0].detach(), Sharded(grads, params.specs, mesh)


def _writers(params: Sharded, opt_state: Sharded):
    """(per rank, whether it writes a tensor in place; per leaf, whether
    ranks share a storage of it): ranks that share a device share the
    storage of a leaf and its moments where the leaf is not cut over every
    axis (`shard_tree`'s views), and each storage is written once, by the
    first rank that holds it."""
    per_rank = [optimizer.leaf_targets(p, o.moments)
                for p, o in zip(params.local, opt_state.local)]
    if _is_meta(params.mesh):
        return [lambda x: True], [False] * len(per_rank[0])
    seen, mine, shared = set(), [set() for _ in params.local], []
    for i in range(len(per_rank[0])):
        hit = False
        for r, targets in enumerate(per_rank):
            for x in targets[i]:
                key = (x.device, x.data_ptr(), tuple(x.shape), x.stride())
                hit |= key in seen
                if key not in seen:
                    seen.add(key)
                    mine[r].add(id(x))
        shared.append(hit)
    return [lambda x, m=m: id(x) in m for m in mine], shared


def train(cfg: ModelConfig, params: Sharded, opt_state: Sharded, batch: Sharded, *,
          impl: str = "torch", remat: bool = True):
    """`steps.build_train_step`'s step partitioned as XLA partitions the
    reference's under its fsdp rules: `loss_and_grads`, then AdamW on each
    rank's shards (`optimizer.adamw_update_sharded`: the global grad norm,
    the factored moments' means over the axes their dims are cut over),
    each storage written once.  Returns (params, opt_state, {"loss",
    "grad_norm"}), the params the same pieces updated in place."""
    mesh = _mesh_of(params, opt_state, batch)
    loss, grads = loss_and_grads(cfg, params, batch, impl=impl, remat=remat)
    own, shared = _writers(params, opt_state)
    outs = run_lockstep(mesh, lambda rk: optimizer.adamw_update_sharded(
        rk, params.local[rk.rank], grads.local[rk.rank], opt_state.local[rk.rank],
        params.specs, own=own[rk.rank], shared=shared))
    return (params, Sharded([o[1] for o in outs], opt_state.specs, mesh),
            {"loss": loss, "grad_norm": outs[0][2]["grad_norm"]})
