"""Dry run, the counterpart of the reference's ``launch/dryrun.py``: for one
(architecture x input shape x mesh), whether the step fits a device and
what it computes, without allocating it.

The reference lowers and compiles the step for 512 fake XLA devices and
reads the compiler's memory and cost analyses of the SPMD-partitioned
executable: one device's program.  The port has no compiler's analyses;
its analogue is an account of the partitioned step (`launch/partition.py`)
on meta ranks shaped like the mesh, where tensors have shapes and dtypes
and no storage and rank 0's body alone runs, its collectives on
`partition._MetaGroup` (every member holding rank 0's shapes, one
member's result handed to all):

* arguments: the per-device bytes of what the step takes (train: params,
  optimizer state, batch; prefill: params, batch, cache; serve: params,
  cache, token), from the spec trees of `launch/shardings.py` — exact;
* temp: rank 0's peak live bytes of the storages its body creates while
  it runs (``impl="torch"``, as the reference lowers with "xla"), counted
  under a dispatch mode when created and freed on release (views and
  in-place writes add nothing: the port writes the cache and the
  optimizer state in place; rank 0's shards, views of the whole meta
  arguments, never count), less its new outputs': the FSDP-gathered
  layer, the sequence-gathered activations, the decode's f32 partial over
  the rank's slice of the cache, the work the port repeats on every rank
  (Mamba2's in_proj, conv and gate; the moe routing), and on moe the
  reference's one-hot dispatch restricted to the rank's experts
  (`moe.expert_partial` on meta: what the reference's program holds, not
  what the port's index dispatch on the card holds), which `temp_scope`
  says;
* output / alias: the reference's donations (params and optimizer for
  train, the cache for prefill and serve): alias is the per-device bytes
  of the donated leaves the step returns in place, output that plus rank
  0's new outputs;
* per_device_total = arg + temp + max(out - alias, 0), and fits against
  `shardings.HBM_PER_DEVICE` (80 GB, one H100);
* cost: rank 0's FLOPs (``torch.utils.flop_counter``) and the bytes every
  non-view ATen op reads and writes, unfused: one device's program, as
  the reference's ``cost_analysis`` reads it (which counts a scanned layer
  loop's body once; the port counts every layer);
* collectives: rank 0's result bytes of each kind, as the reference's
  ``collective_bytes_from_hlo`` parses them from one device's program —
  the train step's backward too, each collective's dual
  (`sp.common.collective`), with FSDP over the batch axes ("pod", "data"
  on the multi-pod mesh).

Beside these the record keeps the whole (unpartitioned) step's account
(`step_account`): its temp over n (`memory["temp_whole_step_over_n"]`, the
estimate the record held before the partitioned steps existed, and the
per-device total it gave, `per_device_total_whole_step_over_n`) and its
FLOPs and bytes over every device (`cost_whole_step`).  On a mesh of one
rank both describe the same device and the record reads the whole step.

The prefill and serve steps run at full depth: every q-column of the plain
attention and every plain SSD scan after the first of its shapes is
replayed from the first one's account (`_Account.replaying`; prefill_32k
runs 1,024 tiles per attention layer, zamba2's scan 512 chunks per layer).
A train step runs them under autograd, which a replay cannot join, so it
runs at 2 and 3 units of depth (a unit: one layer; a hybrid segment of
`attn_every` Mamba2 layers and the shared block; an audio encoder and
decoder layer in the model's ratio) and its temp, new outputs, FLOPs,
bytes and collective bytes are extrapolated linearly to the full depth:
the peak (in the backward or the optimizer update) grows by the same
bytes with every unit, and every unit moves the same bytes.  One pair of
runs serves the per-device account and the collectives.

A train step's optimizer state at 2 and 3 units is the full depth's cut to
them (`_opt_at_depth`): the optimizer factors a leaf by its stacked size,
so a leaf whole at 3 units may be factored at the full depth, and its
factored moments' temporaries and means are what the full step holds and
moves.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b \\
        --shape train_4k [--multi-pod] [--out build/dryrun_torch] [--parts 8]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import replay as kernel_replay
from repro_torch.launch import partition
from repro_torch.launch import shardings as shd
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as mdl
from repro_torch.sp.common import GangMesh
from repro_torch.training import optimizer

OUT = Path("build/dryrun_torch")


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Account(TorchDispatchMode):
    """Under this mode: `flops` sums the FLOP formulas of
    ``torch.utils.flop_counter`` (matmuls) over every ATen op;
    `bytes_accessed` the operand and result bytes of every non-view op;
    `peak` is the most bytes the storages created under the mode held at
    once.  A storage counts once, from the op that creates it until its
    last tensor is released; the storages of `args` (the step's arguments)
    never count.  With `parts`, `parts` holds the largest groups of the
    storages live at the peak, (bytes, "op dtype[shape]", count)."""

    def __init__(self, args, parts: int = 0):
        super().__init__()
        self._args = {t.untyped_storage()._cdata for t in _tensors(args)}
        self._owned: Dict[int, tuple] = {}    # storage id -> (weakref, bytes, what)
        self.live = self.peak = self.bytes_accessed = self.flops = 0
        self._n_parts, self.parts = parts, []

    def _free(self, sid: int, n: int) -> None:
        self.live -= n
        self._owned.pop(sid, None)

    def _rise(self, live: int, extra=()) -> None:
        """`live` bytes held at once (and `extra`, (what, bytes) not among
        the owned storages): the peak where it is more."""
        if live <= self.peak:
            return
        self.peak = live
        if self._n_parts:
            groups: Dict[str, list] = {}
            for what, n in [(v[2], v[1]) for v in self._owned.values()] + list(extra):
                g = groups.setdefault(what, [0, 0])
                g[0], g[1] = g[0] + n, g[1] + 1
            self.parts = sorted(((n, what, c) for what, (n, c) in groups.items()),
                                reverse=True)[:self._n_parts]

    def _adopt(self, t: torch.Tensor, what: str) -> None:
        st_ = t.untyped_storage()
        sid = st_._cdata
        if sid in self._args or sid in self._owned:
            return
        n = st_.nbytes()
        self.live += n
        self._owned[sid] = (weakref.ref(st_, lambda _, s=sid, n=n: self._free(s, n)), n,
                            f"{what} {str(t.dtype)[6:]}{list(t.shape)}" if self._n_parts else "")
        self._rise(self.live)

    def owned_bytes(self, tensors) -> int:
        """Bytes of the distinct created storages behind `tensors`."""
        sids = {t.untyped_storage()._cdata for t in tensors}
        return sum(self._owned[s][1] for s in sids if s in self._owned)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        results = _tensors(out)
        if not func.is_view:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in _tensors((args, kwargs)) + results)
        for t in results:
            self._adopt(t, func._overloadpacket.__name__)
        return out

    @contextlib.contextmanager
    def replaying(self):
        """Within (through the kernels' hook, `kernels/replay.py`): a call
        of the plain attention's q-column or the plain SSD scan made
        without autograd on "meta" tensors whose shapes and dtypes, and
        whose keyword options the values, equal a call already run is
        replayed from that call's account — its FLOPs and bytes added, its
        rise above the live bytes at entry held against the peak, fresh
        outputs of its shapes adopted — instead of run again.  Both give
        fresh outputs, and their other positional arguments (a column's
        query offset) move values only."""
        seen: Dict[tuple, dict] = {}

        def sig(v):
            return (tuple(v.shape), v.dtype, v.device) if torch.is_tensor(v) else v

        def hook(name, run, args, kw):
            tensors = _tensors((args, kw))
            if torch.is_grad_enabled() or any(t.device.type != "meta" for t in tensors):
                return run(*args, **kw)
            key = (name, tuple(sig(a) for a in args if torch.is_tensor(a)),
                   tuple(sorted((k, sig(v)) for k, v in kw.items())))
            if key not in seen:
                live, peak, parts = self.live, self.peak, self.parts
                flops, nbytes = self.flops, self.bytes_accessed
                self.peak = live
                out = run(*args, **kw)
                seen[key] = dict(rise=self.peak - live, flops=self.flops - flops,
                                 bytes=self.bytes_accessed - nbytes,
                                 outs=[(t.shape, t.dtype) for t in _tensors(out)],
                                 tree=tree_flatten(out)[1])
                if peak >= self.peak:
                    self.peak, self.parts = peak, parts
                return out
            rec = seen[key]
            self._rise(self.live + rec["rise"], [(f"{name} (replayed)", rec["rise"])])
            self.flops += rec["flops"]
            self.bytes_accessed += rec["bytes"]
            with _disable_current_modes():
                outs = [torch.empty(s, dtype=d, device="meta") for s, d in rec["outs"]]
            for t in outs:
                self._adopt(t, f"{name} (replayed)")
            return tree_unflatten(outs, rec["tree"])
        with kernel_replay.replay_with(hook):
            yield


def _units(cfg: ModelConfig):
    """(units of depth in cfg, cfg cut to k units)."""
    if cfg.family == "hybrid":
        return (cfg.num_layers // cfg.attn_every,
                lambda k: dataclasses.replace(cfg, num_layers=k * cfg.attn_every))
    if cfg.family == "audio":
        g = math.gcd(cfg.encoder_layers, cfg.num_layers)
        return g, lambda k: dataclasses.replace(
            cfg, encoder_layers=k * cfg.encoder_layers // g,
            num_layers=k * cfg.num_layers // g)
    return cfg.num_layers, lambda k: dataclasses.replace(cfg, num_layers=k)


def _opt_at_depth(cfg: ModelConfig, full: Optional[ModelConfig]):
    """The optimizer state of `full` (the model at its full depth; None:
    cfg itself) cut to cfg's depth, every stacked subtree ("layers",
    "encoder") to cfg's length.  The optimizer factors a leaf by its
    stacked size, so a leaf whole at 2 or 3 units may be factored at the
    full depth (mistral_7b's wq and wo: at 32 layers, not at 3), and a
    step run at a cut depth must carry the full depth's moments."""
    params = st.params_structs(cfg)
    if full is None:
        return st.opt_structs(params)
    opt = st.opt_structs(st.params_structs(full))
    return opt._replace(moments=dict(opt.moments, **{
        k: opt.moments[k][:len(params[k])] for k in optimizer.STACKED if k in params}))


def _step_args(cfg: ModelConfig, shape: ShapeConfig, full: Optional[ModelConfig] = None):
    """(step, its arguments, the donated arguments by name) on meta; a
    train step's optimizer state that of `full` cut to cfg's depth."""
    params, batch = st.params_structs(cfg), st.batch_structs(cfg, shape)
    if shape.kind == "train":
        opt = _opt_at_depth(cfg, full)
        return (st.build_train_step(cfg), (params, opt, batch),
                {"params": params, "opt": opt})
    cache = st.cache_structs(cfg, shape)
    if shape.kind == "prefill":
        return (st.build_prefill_step(cfg, shape, impl="torch"),
                (params, batch, cache), {"cache": cache})
    return (st.build_serve_step(cfg, shape, impl="torch"),
            (params, cache, batch["token"]), {"cache": cache})


def _norm(path) -> tuple:
    """A leaf's path without list indices: one name for every layer's."""
    return tuple(c for c in path if not isinstance(c, int))


def _measure(fn, args, local, donated, parts: int = 0) -> Dict[str, Any]:
    """``fn(*args)`` run once under an `_Account` whose arguments are
    `local` (the step's own trees, or rank 0's shards of them): temp (the
    peak less the new outputs), new-output bytes, FLOPs, bytes accessed,
    and the donated leaves of `donated` (trees by name) it does not return
    in place, by path; with `parts`, the largest groups live at the peak
    (`_Account`).  A `partition.Sharded` result counts rank 0's tree."""
    donated_sids = []       # before the step, which may rebind dict entries
    shd.walk(lambda path, x, n: donated_sids.append(
        (_norm(path), x.untyped_storage()._cdata)), donated)
    with _Account(local, parts) as acc, acc.replaying():
        out = fn(*args)
    out_leaves = _tensors([o.local[0] if isinstance(o, partition.Sharded) else o
                           for o in out])
    out_sids = {t.untyped_storage()._cdata for t in out_leaves}
    new_out = acc.owned_bytes(out_leaves)
    replaced = {path for path, sid in donated_sids if sid not in out_sids}
    got = {"temp": acc.peak - new_out, "new_out": new_out,
           "flops": acc.flops, "bytes": acc.bytes_accessed,
           "replaced": replaced}
    return dict(got, parts=acc.parts) if parts else got


def _run(cfg: ModelConfig, shape: ShapeConfig,
         full: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """One meta run of the whole (unpartitioned) step (train: with `full`'s
    moments cut to cfg's depth, `_opt_at_depth`): `_measure`'s figures."""
    fn, args, donated = _step_args(cfg, shape, full)
    return _measure(fn, args, args, donated)


#: the figures a run at 2 and 3 units extrapolates
_LINEAR = ("temp", "new_out", "flops", "bytes")


def _depths(cfg: ModelConfig, shape: ShapeConfig, run) -> Dict[str, Any]:
    """``run(c, cfg)`` of cfg; a train step deeper than 3 units at 2 and 3
    units (c: cfg cut to them), its figures (and its "collectives" by
    kind, where it counts them) extrapolated linearly to cfg's depth."""
    n, cut = _units(cfg)
    if shape.kind != "train" or n <= 3:
        return dict(run(cfg, cfg), units=n, units_run=[n])
    two, three = run(cut(2), cfg), run(cut(3), cfg)

    def line(a, b):
        return b + (n - 3) * (b - a)
    out = {k: line(two[k], three[k]) for k in _LINEAR}
    if "collectives" in three:
        out["collectives"] = {k: line(two["collectives"][k], v)
                              for k, v in three["collectives"].items()}
    if "parts" in three:
        out["parts"] = three["parts"]       # at 3 units
    return dict(out, replaced=two["replaced"], units=n, units_run=[2, 3])


@functools.lru_cache(maxsize=8)
def step_account(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """`_run` of the whole step at the config's depth (`_depths`: a train
    step deeper than 3 units at 2 and 3 units, with the full depth's
    moments cut to them, extrapolated).  The same on every mesh, so the
    matrix's second mesh reads it from the cache (callers must not mutate
    it)."""
    return _depths(cfg, shape, lambda c, full: _run(c, shape, full if c is not cfg else None))


def _rank_run(cfg: ModelConfig, shape: ShapeConfig, mesh: GangMesh,
              max_len: Optional[int], full: ModelConfig, parts: int = 0) -> Dict[str, Any]:
    """One run of the partitioned step on meta ranks shaped like `mesh`
    (rank 0's body alone), under one `_Account` whose arguments are rank
    0's shards: `_measure`'s figures for one device, and rank 0's
    collective bytes by kind ("collectives").  A train step's moments are
    `full`'s cut to cfg's depth (`_opt_at_depth`): a factored leaf's means
    move bytes and its temporaries count.  A prefill writes a cache of
    `max_len` positions where given, else the shape's; `parts`: `_measure`'s."""
    mesh = GangMesh([torch.device("meta")] * mesh.n_ranks, tuple(mesh.shape.values()),
                    mesh.axis_names)
    params = st.params_structs(cfg)
    pspecs = shd.param_specs(cfg, params, mesh, fsdp=shd.needs_fsdp(cfg, mesh, shape.kind))
    batch = st.batch_structs(cfg, shape)
    bspecs = shd.batch_specs(cfg, shape, mesh)
    args = {"params": partition.shard_tree(params, pspecs, mesh)}
    if shape.kind == "train":
        opt = _opt_at_depth(cfg, full)
        args["opt"] = partition.shard_tree(opt, shd.opt_specs(pspecs, opt), mesh)
        args["batch"] = partition.shard_tree(batch, bspecs, mesh)
        fn, order, donated = st.build_train_step(cfg), ("params", "opt", "batch"), ("params", "opt")
    else:
        cache = (st.cache_structs(cfg, shape) if max_len is None
                 else mdl.init_cache(cfg, shape.global_batch, max_len, device="meta",
                                     enc_len=st.cache_lengths(cfg, shape)[1]))
        args["cache"] = partition.shard_tree(cache, shd.cache_specs(
            cfg, cache, mesh, global_batch=shape.global_batch), mesh)
        donated = ("cache",)
        if shape.kind == "prefill":
            args["batch"] = partition.shard_tree(batch, bspecs, mesh)
            fn, order = st.build_prefill_step(cfg, shape, impl="torch"), ("params", "batch", "cache")
        else:
            args["token"] = partition.shard_tree(batch["token"], bspecs["token"], mesh)
            fn, order = st.build_serve_step(cfg, shape, impl="torch"), ("params", "cache", "token")
    got = _measure(fn, [args[k] for k in order], [args[k].local[0] for k in order],
                   {k: args[k].local[0] for k in donated}, parts)
    return dict(got, collectives=dict(mesh.collective_bytes[0]))


def rank_account(cfg: ModelConfig, shape: ShapeConfig, mesh: GangMesh, *,
                 max_len: Optional[int] = None, parts: int = 0) -> Dict[str, Any]:
    """One device's account of the partitioned step of `shape` on `mesh`
    (`_rank_run` at the config's depth, a train step deeper than 3 units
    at 2 and 3 units extrapolated, `_depths`): temp, new_out, flops,
    bytes, replaced, and the collective bytes by kind; with `parts` the
    largest groups of storages live at rank 0's peak (a train step's at 3
    units)."""
    return _depths(cfg, shape, lambda c, full: _rank_run(c, shape, mesh, max_len, full,
                                                         parts))


def collective_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh: GangMesh, *,
                     max_len: Optional[int] = None) -> Dict[str, int]:
    """Per device, the bytes of each kind of collective (and "total") the
    partitioned step of `shape` moves on `mesh` (prefill: into a cache of
    `max_len` positions where given, else the shape's; train: forward,
    remat and backward, the gradients' sums and the optimizer's): counted
    on meta ranks (`rank_account`)."""
    return rank_account(cfg, shape, mesh, max_len=max_len)["collectives"]


def mesh_tag(mesh) -> str:
    """pod16x16 / pod2x16x16 for the production meshes, host<d>x<m> else."""
    kind = "pod" if mesh.devices[0].type == "meta" else "host"
    return kind + "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def run_combo(arch: str, shape: Union[str, ShapeConfig], *, multi_pod: bool = False,
              out_dir: Optional[Path] = None, layers: Optional[int] = None,
              mesh=None, parts: int = 0) -> Dict[str, Any]:
    """The record of one (arch, shape, mesh): the reference's keys (arch,
    shape, mesh, kind, ok / skipped + reason, fsdp, memory, cost,
    collectives, n_devices) with the port's account: one device's
    (`rank_account`) on a mesh of more than one rank, the whole step's
    (`step_account`) beside it.  `shape` is a name of INPUT_SHAPES or a
    ShapeConfig; `layers` cuts the depth (audio: the decoder's, the
    encoder's in the model's ratio); `mesh` (default: the production mesh)
    may be a host mesh; with `parts`, the record's memory also lists the
    largest groups of storages live at rank 0's peak (`temp_parts`).
    Written to out_dir/<tag>.json when out_dir is given."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers, encoder_layers=(
            layers * cfg.encoder_layers // cfg.num_layers))
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape.name, "mesh": mesh_tag(mesh),
                           "kind": shape.kind, "ok": False}
    ok, reason = st.supports_shape(cfg, shape)
    if not ok:
        rec.update(skipped=True, reason=reason)
        return _write(rec, out_dir)
    t0 = time.perf_counter()
    rec.update(seq_len=shape.seq_len, global_batch=shape.global_batch,
               layers=cfg.num_layers)
    fsdp = shd.needs_fsdp(cfg, mesh, shape.kind)
    rec["fsdp"] = fsdp
    params = st.params_structs(cfg)
    pspecs = shd.param_specs(cfg, params, mesh, fsdp=fsdp)
    batch = st.batch_structs(cfg, shape)
    bspecs = shd.batch_specs(cfg, shape, mesh)
    args = {"params": (params, pspecs)}
    if shape.kind == "train":
        opt = st.opt_structs(params)
        args.update(opt=(opt, shd.opt_specs(pspecs, opt)), batch=(batch, bspecs))
    else:
        cache = st.cache_structs(cfg, shape)
        args["cache"] = (cache, shd.cache_specs(cfg, cache, mesh,
                                                global_batch=shape.global_batch))
        if shape.kind == "prefill":
            args["batch"] = (batch, bspecs)
        else:
            args["token"] = (batch["token"], bspecs["token"])
    arg_bytes = {k: shd.per_device_bytes(t, s, mesh) for k, (t, s) in args.items()}
    whole = step_account(cfg, shape)
    rank = rank_account(cfg, shape, mesh, parts=parts)
    n_dev = mesh.n_ranks
    acct = whole if n_dev == 1 else rank
    donated = ("params", "opt") if shape.kind == "train" else ("cache",)
    in_place = []       # the donated leaves the step writes, not replaces

    def donated_leaf(path, x, n, spec):
        if _norm((name,) + path) not in acct["replaced"]:
            in_place.append(shd.per_device_bytes(x, spec, mesh))
    for name in donated:
        shd.walk(donated_leaf, *args[name])
    alias = sum(in_place)
    arg = sum(arg_bytes.values())
    out = alias + acct["new_out"]
    total = arg + acct["temp"] + max(out - alias, 0)
    scope = "the step's peak live intermediates on meta"
    if n_dev > 1:
        scope = (f"rank 0's peak live intermediates less its new outputs, the "
                 f"partitioned step run on {n_dev} meta ranks (launch/partition.py)")
        if cfg.family == "moe":
            scope += ("; experts dispatched through the reference's one-hot restricted "
                      "to the rank's experts, which the card's index dispatch does not hold")
    rec["memory"] = {
        "argument_size_in_bytes": arg, "output_size_in_bytes": out,
        "alias_size_in_bytes": alias, "temp_size_in_bytes": acct["temp"],
        "per_device_total": total, "fits": total <= shd.HBM_PER_DEVICE,
        "arguments": arg_bytes, "temp_scope": scope,
        "temp_whole_step_over_n": whole["temp"] // n_dev,
        "per_device_total_whole_step_over_n": (arg + whole["temp"] // n_dev
                                               + whole["new_out"] // n_dev)}
    if parts:
        rec["memory"]["temp_parts"] = [{"bytes": n, "what": what, "count": c}
                                       for n, what, c in rank["parts"]]
    rec["hbm_per_device"] = shd.HBM_PER_DEVICE
    rec["cost"] = {"flops": float(acct["flops"]), "bytes accessed": float(acct["bytes"]),
                   "scope": "one device's program, unfused"}
    rec["cost_whole_step"] = {"flops": float(whole["flops"]),
                              "bytes accessed": float(whole["bytes"]),
                              "scope": "the whole step over every device, unfused"}
    rec["collectives"] = rank["collectives"]
    rec["collectives_scope"] = ("one device's collective result bytes, counted by "
                                "the partitioned step on meta ranks")
    rec["account"] = {"units": acct["units"], "units_run": acct["units_run"],
                      "seconds": time.perf_counter() - t0}
    rec["ok"] = True
    rec["n_devices"] = n_dev
    return _write(rec, out_dir)


def _write(rec: Dict[str, Any], out_dir: Optional[Path]) -> Dict[str, Any]:
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{tag(rec)}.json").write_text(json.dumps(rec, indent=1))
    return rec


def tag(rec: Dict[str, Any]) -> str:
    return f"{rec['arch']}.{rec['shape']}.{rec['mesh']}"


def run_logged(arch: str, shape: str, *, multi_pod: bool, out_dir: Optional[Path],
               log=print, parts: int = 0) -> Dict[str, Any]:
    """`run_combo`, a failure recorded as a FAIL record with its traceback,
    and the reference's OK / SKIP / FAIL line."""
    t0 = time.perf_counter()
    try:
        rec = run_combo(arch, shape, multi_pod=multi_pod, out_dir=out_dir, parts=parts)
    except Exception as e:     # recorded and counted as FAIL by the caller
        rec = _write({"arch": arch, "shape": shape,
                      "mesh": "pod2x16x16" if multi_pod else "pod16x16", "ok": False,
                      "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-4000:]}, out_dir)
    secs = time.perf_counter() - t0
    if rec.get("ok"):
        mem = rec["memory"]
        log(f"OK   {tag(rec):60s} {secs:6.1f}s mem/dev={mem['per_device_total'] / 1e9:.2f}GB "
            f"fits={mem['fits']} flops={rec['cost']['flops']:.3e}")
    elif rec.get("skipped"):
        log(f"SKIP {tag(rec):60s} {rec['reason']}")
    else:
        log(f"FAIL {tag(rec):60s} {rec['error']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--parts", type=int, default=0, metavar="N",
                    help="list the N largest groups of storages live at rank 0's peak")
    args = ap.parse_args(argv)
    rec = run_logged(args.arch, args.shape, multi_pod=args.multi_pod,
                     out_dir=Path(args.out), parts=args.parts)
    if rec.get("ok"):
        print(json.dumps(rec["memory"], indent=1))
        print(json.dumps(rec["cost"], indent=1))
    elif not rec.get("skipped"):
        print(rec["traceback"])
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
