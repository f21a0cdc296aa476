"""Shared SP utilities: LSE-merging of partial attention results, and the
single-controller device mesh the SP layers run on.

Any attention over a KV *subset* yields (o, lse).  Results over disjoint KV
subsets merge exactly via log-sum-exp algebra — the primitive behind ring
attention (sequential merges) and distributed decode (all-reduce merge).

`GangMesh` stands in for the reference's ``jax.sharding.Mesh`` +
``shard_map``: one process drives every rank.  A rank is a `torch.device`
(several ranks may share one), per-rank code runs in this process, and each
collective takes a list with one tensor per rank and gives one back, with
the ``jax.lax`` semantics the reference relies on.  A collective moves a
tensor with ``.to(dst)``: a peer copy between distinct cards, no copy at
all between ranks that share a device.  Every collective adds, for each
rank of a group of two or more, the bytes of that rank's result to the
rank's count under the reference's HLO names (`KINDS`), as
``collective_bytes_from_hlo`` counts one device's program.

`collective` runs one of them as a single autograd node over every rank's
tensor (the graph of a partitioned train step spans the ranks): its
backward runs the dual collective over the ranks' gradients, all-gather
and reduce-scatter each other's, psum its own, an all-to-all the reverse
one, so the backward's bytes are counted as the reference's HLO holds
them, under the dual's kind.

`lockstep` runs one body per rank, each in a thread of its own, meeting at
the collectives: the runner of the gang's layer quanta and of the
partitioned steps (`launch/partition.py`).
"""
from __future__ import annotations

import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

Axes = Union[str, Sequence[str], None]

#: the collectives by the names of the reference's HLO count
#: (``launch/dryrun.py`` ``_COLLECTIVES``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def merge_partials(o1: torch.Tensor, lse1: torch.Tensor,
                   o2: torch.Tensor, lse2: torch.Tensor):
    """Merge two partial attentions over disjoint KV sets.
    o (B,H,S,D) f32, lse (B,H,S) f32 with -inf == empty."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w1 = torch.where(torch.isneginf(lse1), 0.0, torch.exp(lse1 - m_safe))
    w2 = torch.where(torch.isneginf(lse2), 0.0, torch.exp(lse2 - m_safe))
    den = w1 + w2
    den_safe = den.clamp_min(1e-38)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / den_safe[..., None]
    lse = torch.where(den > 0, m_safe + torch.log(den_safe), float("-inf"))
    return o, lse


def finalize(o: torch.Tensor, lse: torch.Tensor, dtype) -> torch.Tensor:
    """Zero out rows that attended to nothing (fully masked)."""
    return torch.where(torch.isneginf(lse)[..., None], 0.0, o).to(dtype)


def as_axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


class GangMesh:
    """`devices` (one per rank) shaped `shape` over `axis_names`, ranks in
    row-major order: rank r sits at ``np.unravel_index(r, shape)``.  Over a
    tuple of axes, a rank's index is its coordinates on them read
    major-first, as ``jax.lax.axis_index`` reads a tuple.  `uniform`: every
    rank holds the same tensors (a dry run's meta group), so work done per
    rank runs on rank 0's alone and its result stands for every rank's."""

    uniform = False

    def __init__(self, devices: Sequence, shape: Sequence[int],
                 axis_names: Sequence[str]):
        shape, names = tuple(int(s) for s in shape), tuple(axis_names)
        devs = [torch.device(d) for d in devices]
        if len(shape) != len(names) or math.prod(shape) != len(devs):
            raise ValueError(f"GangMesh: {len(devs)} devices do not fill a "
                             f"mesh of shape {shape} over axes {names}")
        # "cuda" and "cuda:0" are one device: name every card by its index
        self.devices = [torch.device("cuda", torch.cuda.current_device())
                        if d.type == "cuda" and d.index is None else d
                        for d in devs]
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self._coords = [dict(zip(names, (int(c) for c in
                                         np.unravel_index(r, shape))))
                        for r in range(len(devs))]
        self.reset_bytes()

    def reset_bytes(self) -> None:
        """Set every rank's collective byte count to 0."""
        self.collective_bytes: List[Dict[str, int]] = [
            dict.fromkeys(KINDS + ("total",), 0) for _ in self.devices]

    def _count(self, kind: str, out: List[torch.Tensor], groups) -> None:
        for g in groups:
            if len(g) < 2:
                continue
            for r in g:
                n = out[r].numel() * out[r].element_size()
                self.collective_bytes[r][kind] += n
                self.collective_bytes[r]["total"] += n

    @property
    def n_ranks(self) -> int:
        return len(self.devices)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in as_axes(axes))

    def axis_index(self, rank: int, axes: Axes) -> int:
        idx = 0
        for a in as_axes(axes):
            idx = idx * self.shape[a] + self._coords[rank][a]
        return idx

    def groups(self, axes: Axes) -> List[List[int]]:
        """The ranks a collective over `axes` joins: those that agree on
        every other axis, each group ordered by its index over `axes`."""
        axes = as_axes(axes)
        out = {}
        for r in range(self.n_ranks):
            key = tuple(c for a, c in self._coords[r].items() if a not in axes)
            out.setdefault(key, []).append(r)
        return [sorted(g, key=lambda r: self.axis_index(r, axes))
                for g in out.values()]

    # ---- collectives over per-rank lists --------------------------------
    def ppermute(self, xs: List[torch.Tensor], axes: Axes) -> List[torch.Tensor]:
        """The neighbour shift ``perm = [(i, (i + 1) % p)]``: rank i's
        tensor lands on rank (i + 1) % p of its group."""
        out = [None] * self.n_ranks
        groups = self.groups(axes)
        for g in groups:
            for i, r in enumerate(g):
                out[r] = xs[g[i - 1]].to(self.devices[r])
        self._count("collective-permute", out, groups)
        return out

    def all_to_all(self, xs: List[torch.Tensor], axes: Axes, *,
                   split_axis: int, concat_axis: int) -> List[torch.Tensor]:
        """Tiled all-to-all: each rank cuts its tensor into p pieces along
        `split_axis`, sends piece i to rank i of its group, and joins what
        it receives along `concat_axis` in the senders' order."""
        out = [None] * self.n_ranks
        groups = self.groups(axes)
        for g in groups:
            p = len(g)
            pieces = [xs[r].tensor_split(p, split_axis) for r in g]
            for i, r in enumerate(g):
                out[r] = torch.cat([pieces[j][i].to(self.devices[r])
                                    for j in range(p)], concat_axis)
        self._count("all-to-all", out, groups)
        return out

    def all_gather(self, xs: List[torch.Tensor], axes: Axes, *,
                   axis: int) -> List[torch.Tensor]:
        """Tiled all-gather: every rank gets its group's tensors joined
        along `axis` in group order."""
        out = [None] * self.n_ranks
        groups = self.groups(axes)
        for g in groups:
            for r in g:
                out[r] = torch.cat([xs[j].to(self.devices[r]) for j in g], axis)
        self._count("all-gather", out, groups)
        return out

    def _reduce(self, xs, axes, op):
        out = [None] * self.n_ranks
        groups = self.groups(axes)
        for g in groups:
            for r in g:
                acc = xs[g[0]].to(self.devices[r])
                for j in g[1:]:
                    acc = op(acc, xs[j].to(self.devices[r]))
                out[r] = acc
        self._count("all-reduce", out, groups)
        return out

    def psum(self, xs: List[torch.Tensor], axes: Axes) -> List[torch.Tensor]:
        return self._reduce(xs, axes, torch.add)

    def pmax(self, xs: List[torch.Tensor], axes: Axes) -> List[torch.Tensor]:
        return self._reduce(xs, axes, torch.maximum)

    def psum_scatter(self, xs: List[torch.Tensor], axes: Axes, *,
                     scatter_dimension: int) -> List[torch.Tensor]:
        """Tiled reduce-scatter (``jax.lax.psum_scatter(..., tiled=True)``):
        the sum over the group, of which rank i keeps piece i along
        `scatter_dimension`; each rank adds up only its own piece."""
        out = [None] * self.n_ranks
        groups = self.groups(axes)
        for g in groups:
            pieces = [xs[r].tensor_split(len(g), scatter_dimension) for r in g]
            for i, r in enumerate(g):
                acc = pieces[0][i].to(self.devices[r])
                for j in range(1, len(g)):
                    acc = acc + pieces[j][i].to(self.devices[r])
                out[r] = acc.contiguous()
        self._count("reduce-scatter", out, groups)
        return out

    # ---- global arrays <-> per-rank shards (the shard_map boundary) ------
    def shard(self, x: torch.Tensor, axis: int,
              axes: Axes) -> List[torch.Tensor]:
        """Cut `x` into equal pieces along `axis` over `axes` (replicated
        over the other axes); rank r gets piece ``axis_index(r, axes)``."""
        if not as_axes(axes):
            return [x.to(d) for d in self.devices]
        pieces = x.tensor_split(self.axis_size(axes), axis)
        return [pieces[self.axis_index(r, axes)].to(self.devices[r])
                for r in range(self.n_ranks)]

    def unshard(self, xs: List[torch.Tensor], axis: int,
                axes: Axes) -> torch.Tensor:
        """The inverse of `shard`: the pieces of the group that holds rank
        0, joined along `axis` on rank 0's device."""
        g = next(g for g in self.groups(axes) if 0 in g)
        return torch.cat([xs[r].to(self.devices[0]) for r in g], axis)


def _dual(name: str, kw: dict):
    """(the collective whose result is the gradient of `name`'s inputs,
    its keywords), given the gradients of `name`'s results."""
    if name == "all_gather":
        return "psum_scatter", {"scatter_dimension": kw["axis"]}
    if name == "psum_scatter":
        return "all_gather", {"axis": kw["scatter_dimension"]}
    if name == "all_to_all":
        return "all_to_all", {"split_axis": kw["concat_axis"],
                              "concat_axis": kw["split_axis"]}
    if name == "psum":
        return "psum", {}
    raise NotImplementedError(f"collective: {name} has no gradient here")


class _Collective(torch.autograd.Function):
    """`run` over every rank's tensor as one node; its backward `back` over
    the ranks' gradients (a result no rank reads gets zeros)."""

    @staticmethod
    def forward(ctx, run, back, *xs):
        ctx.back = back
        return tuple(run(list(xs)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.back(list(grads)))


def collective(mesh: GangMesh, name: str, xs: List[torch.Tensor], axes: Axes,
               **kw) -> List[torch.Tensor]:
    """``mesh.<name>(xs, axes, **kw)``; under autograd, where a rank's
    tensor requires grad, one node over every rank's tensor whose backward
    runs the dual collective (`_dual`) on `mesh`, counted as any other
    (on a `uniform` mesh, a node over rank 0's tensor alone)."""
    run = getattr(mesh, name)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in xs)):
        return run(xs, axes, **kw)
    dual, dual_kw = _dual(name, kw)
    back = getattr(mesh, dual)
    if mesh.uniform:
        # one node over rank 0's tensor: its result and gradient every rank's
        n = mesh.n_ranks
        return list(_Collective.apply(lambda ys: run(ys * n, axes, **kw)[:1],
                                      lambda gs: back(gs * n, axes, **dual_kw)[:1],
                                      xs[0])) * n
    return list(_Collective.apply(lambda ys: run(ys, axes, **kw),
                                  lambda gs: back(gs, axes, **dual_kw), *xs))


def lockstep(n: int, body: Callable, collective: Callable) -> list:
    """``[body(rank, meet) for rank in range(n)]``, each body in a thread of
    its own.  A body calls ``meet(*args)`` where the ranks must meet: it
    blocks until every rank has called it, one thread then runs
    ``collective`` over the list of every rank's args, and each rank's call
    returns its own item of the result.  A rank that raises breaks the
    barrier, so the others raise too instead of waiting forever; the first
    error that is not that echo is raised here."""
    args: list = [None] * n
    result: list = []

    def run_collective():
        result[:] = collective(args)

    barrier = threading.Barrier(n, action=run_collective)

    def run(rank):
        def meet(*a):
            args[rank] = a
            barrier.wait()
            return result[rank]
        try:
            return body(rank, meet)
        except BaseException:
            barrier.abort()
            raise

    with ThreadPoolExecutor(max_workers=n) as pool:
        futures = [pool.submit(run, r) for r in range(n)]
    errors = [f.exception() for f in futures if f.exception() is not None]
    if errors:
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return [f.result() for f in futures]
