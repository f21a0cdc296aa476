"""The partitioned FSDP train step (`launch/partition.train`,
`models/tp.loss_rank`, `training/optimizer.adamw_update_sharded`) of the
dense and vlm families on meshes of CPU ranks, reduced f32 configs, the
reference's weights bridged.

* Configs: a llama-like dense model (8 q / 2 KV heads), a qwen2-like one
  (QKV bias, 6 heads: the sequence fallback wherever 6 does not divide
  "model"), a phi3-like one (40 q / 10 KV heads, a vocabulary of 500
  padded to 512: the padded slice masked on the last vocab rank) and a
  vlm; meshes ["cpu"] x 4 shaped (1, 4), (2, 2), (4, 1) and ["cpu"] x 8
  shaped (2, 4), and one sequence (B == 1, the sequence over every axis).
  The labels drop positions unevenly across rows, so a loss divided by a
  rank's own count of valid labels would differ.
* Two train steps from `Sharded` arguments against the reference's
  ``build_train_step`` without a mesh (jitted) and against the port's
  whole-tensor step: loss and grad norm to 1e-5 relative, the params to
  1e-5 but for AdamW's ±lr sign flips (`_assert_params_close`); each
  gradient of `partition.loss_and_grads` against `steps.loss_and_grads`
  to 1e-5 in relative norm; factored moments over sharded leaves
  (FACTOR_THRESHOLD patched in both packages) held to the reference and
  their moments to the whole-tensor step's.
* The traps: every distinct storage written once by the optimizer (ranks
  on one device share a replicated leaf's storage); the remat's forward
  without grad in every rank thread and its recompute with it; the
  backward's collectives run in the caller's thread; a gradient
  reduce-scatter that drops the last rank's partial reads far above the
  limit on the leaves it touches and nowhere else.
* The collective bytes: the dry run's count on meta ranks
  (`dryrun.collective_bytes` of a train shape) equals every CPU rank's.
* `launch/train.py` on a host mesh of four ranks shards, and equals its
  run on whole tensors.
* In ONE subprocess with four forced XLA devices (this file run as a
  script): the reference's train step jitted under the dry run's fsdp in-
  and out-shardings on (2, 2), its loss and grad norm against the port's
  partitioned step, and its collective bytes from the compiled HLO.

The partitioned train step on the card against the CPU ranks' is in
tests/test_torch_cuda.py, which imports no JAX.

    PYTHONPATH=src python tests/test_torch_partition_train.py --bytes

prints the reference's collective bytes of its partitioned train step
beside the port's for the reduced dense model on (2, 2), and on (2, 2) and
(1, 4) its ``memory_analysis().temp_size_in_bytes`` and
``cost_analysis()["flops"]`` (as parsed, and scaled by the layer loop's
trip count) beside the dry run's per-device temp and FLOPs
(`dryrun.rank_account`).
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch import steps as jst
from repro.models import model as jmdl
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, partition
from repro_torch.launch import shardings as shd
from repro_torch.launch import steps, train
from repro_torch.models import model as mdl
from repro_torch.models import tp
from repro_torch.sp import common
from repro_torch.sp.common import GangMesh
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
LR = 3e-4
B, S = 4, 32
#: name -> (arch, reduced_config keywords, config overrides)
CONFIGS = {
    "dense": ("llama31_70b", dict(layers=2, n_heads=8, n_kv=2), {}),
    "qwen2": ("qwen2_7b", dict(layers=2, d_model=192, n_heads=6, n_kv=2), {}),
    "phi3": ("phi3_14b", dict(layers=2, d_model=320, n_heads=40, n_kv=10),
             dict(vocab_size=500)),
    "vlm": ("internvl2_76b", dict(layers=2), {}),
}
MESHES = [(1, 4), (2, 2), (4, 1), (2, 4)]
CASES = ([(name, m) for name in ("dense", "qwen2", "vlm") for m in MESHES]
         + [("phi3", (1, 4)), ("phi3", (2, 4))])
#: between a per-layer and a stacked 2-D leaf of the dense and qwen2
#: configs, above every 1-D stack: wq and the MLP factored, wk / wv not
FACTOR_THRESHOLD = 40_000


def _configs(name):
    arch, kw, over = CONFIGS[name]
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch), **kw), dtype="float32",
                               **over)
    cfg = dataclasses.replace(reduced_config(get_config(arch), **kw), dtype="float32", **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _mesh(shape, cls=GangMesh):
    return cls(["cpu"] * (shape[0] * shape[1]), shape, ("data", "model"))


def _batches(cfg, batch=B, n=2):
    """`n` numpy train batches from a seed: tokens (vlm: patch embeddings
    first, as `steps.batch_structs` sizes them), labels the tokens shifted
    left with the last and, in the first row, every third position -1."""
    rng = np.random.default_rng(5)
    n_prefix = min(cfg.frontend_tokens, S // 2) if cfg.family == "vlm" else 0
    out = []
    for _ in range(n):
        tok = rng.integers(0, cfg.vocab_size, (batch, S - n_prefix)).astype(np.int32)
        b = {"tokens": tok}
        if n_prefix:
            b["embeds"] = rng.standard_normal((batch, n_prefix, cfg.d_model)).astype(np.float32)
        lab = np.pad(tok[:, 1:], ((0, 0), (0, 1)), constant_values=-1)
        lab[0, ::3] = -1
        b["labels"] = lab
        out.append(b)
    return out


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _train_shape(batch=B):
    return ShapeConfig(f"train_{batch}x{S}", S, batch, "train")


def _clone(tree):
    return mdl.tree_like(tree, [x.clone() for x in mdl.param_leaves(tree)])


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jcfg, cfg = _configs(name)
        tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
        out[name] = (jcfg, tree, cfg, params_from_jax(tree, device="cpu"))
    return out


_REFERENCE = {}


def _reference(models, name, batch=B):
    """The reference's jitted train step without a mesh, two steps:
    ([(loss, grad_norm)], the params after them, numpy)."""
    key = (name, batch, opt.FACTOR_THRESHOLD)
    if key not in _REFERENCE:
        jcfg, tree, _, _ = models[name]
        p = jax.tree.map(jnp.asarray, tree)
        s = jopt.adamw_init(p)
        step = jax.jit(jst.build_train_step(jcfg, remat=True))
        infos = []
        for b in _batches(jcfg, batch):
            p, s, info = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            infos.append((float(info["loss"]), float(info["grad_norm"])))
        _REFERENCE[key] = (infos, jax.tree.map(np.asarray, p))
    return _REFERENCE[key]


_WHOLE = {}


def _whole(models, name, batch=B):
    """The port's whole-tensor step, two steps: ([(loss, grad_norm)], the
    params and optimizer state after them, the gradients of the first
    batch)."""
    key = (name, batch, opt.FACTOR_THRESHOLD)
    if key not in _WHOLE:
        _, _, cfg, params = models[name]
        p = _clone(params)
        s = opt.adamw_init(p)
        bs = _batches(cfg, batch)
        _, grads = steps.loss_and_grads(cfg, p, _torch(bs[0]))
        step = steps.build_train_step(cfg)
        infos = []
        for b in bs:
            p, s, info = step(p, s, _torch(b))
            infos.append((float(info["loss"]), float(info["grad_norm"])))
        _WHOLE[key] = (infos, p, s, grads)
    return _WHOLE[key]


def _shard(cfg, params, mesh, batch=B):
    """(params, optimizer state) cut by the fsdp specs over `mesh` (views
    of a copy of `params`), and a function cutting a numpy batch."""
    params = _clone(params)
    state = opt.adamw_init(params)
    pspecs = shd.param_specs(cfg, params, mesh, fsdp=True)
    bspecs = shd.batch_specs(cfg, _train_shape(batch), mesh)
    return (partition.shard_tree(params, pspecs, mesh),
            partition.shard_tree(state, shd.opt_specs(pspecs, state), mesh),
            lambda b: partition.shard_tree(_torch(b), bspecs, mesh))


def _partitioned(cfg, params, mesh, batch=B):
    """Two partitioned train steps: ([(loss, grad_norm)], the params and
    the optimizer state after them, unsharded, the collective bytes of the
    first step)."""
    p, s, cut = _shard(cfg, params, mesh, batch)
    step = steps.build_train_step(cfg)
    infos, counts = [], []
    for b in _batches(cfg, batch):
        mesh.reset_bytes()
        p, s, info = step(p, s, cut(b))
        counts.append(dict(mesh.collective_bytes[0]))
        infos.append((float(info["loss"]), float(info["grad_norm"])))
    assert isinstance(p, partition.Sharded) and isinstance(s, partition.Sharded)
    return infos, partition.unshard_tree(p), partition.unshard_tree(s), counts[0]


def _assert_infos_close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=TOL, err_msg=f"{what} step {i} (loss, grad_norm)")


def _assert_params_close(got, want, n_steps=2, tol=TOL):
    """Params after `n_steps` AdamW steps from equal weights: within rtol
    = atol = `tol`, but for at most 1e-4 of a leaf's elements (one at
    least), each within 2 x lr x n_steps: where a gradient is ~0 (a near
    cancellation), its rounding decides the sign of m̂ / sqrt(v̂) ~ ±1, and
    so an update of ±lr."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        off = ~np.isclose(g, w, rtol=tol, atol=tol)
        assert off.sum() <= max(1, w.size // 10_000), (i, int(off.sum()))
        assert np.abs(g - w).max() <= 2 * LR * n_steps, i


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _ids(case):
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


# ---- against the reference and the whole-tensor step -----------------------
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_partitioned_train_matches_reference(case, models):
    name, shape = case
    _, _, cfg, params = models[name]
    mesh = _mesh(shape)
    ref_infos, ref_params = _reference(models, name)
    whole_infos, whole_params, _, whole_grads = _whole(models, name)
    # the gradients of the first batch
    p, _, cut = _shard(cfg, params, mesh)
    loss, grads = partition.loss_and_grads(cfg, p, cut(_batches(cfg)[0]))
    np.testing.assert_allclose(float(loss), whole_infos[0][0], rtol=TOL)
    for i, (g, w) in enumerate(zip(mdl.param_leaves(partition.unshard_tree(grads)),
                                   mdl.param_leaves(whole_grads))):
        assert _rel(g, w) <= TOL, (i, _rel(g, w))
    infos, got, _, _ = _partitioned(cfg, params, mesh)
    _assert_infos_close(infos, ref_infos, "reference")
    _assert_infos_close(infos, whole_infos, "whole-tensor step")
    _assert_params_close(params_to_numpy(got), ref_params)
    _assert_params_close(params_to_numpy(got), params_to_numpy(whole_params))


def test_one_sequence_long_context(models):
    """B == 1 on (2, 2): the tokens and labels over (data, model); the
    batch whole on every rank, the residual's sequence over "model"."""
    _, _, cfg, params = models["dense"]
    mesh = _mesh((2, 2))
    assert shd.batch_specs(cfg, _train_shape(1), mesh)["labels"] == (None, ("data", "model"))
    ref_infos, ref_params = _reference(models, "dense", 1)
    whole_infos, whole_params, _, _ = _whole(models, "dense", 1)
    infos, got, _, _ = _partitioned(cfg, params, mesh, 1)
    _assert_infos_close(infos, ref_infos, "reference")
    _assert_infos_close(infos, whole_infos, "whole-tensor step")
    _assert_params_close(params_to_numpy(got), ref_params)
    _assert_params_close(params_to_numpy(got), params_to_numpy(whole_params))


@pytest.mark.parametrize("case", [("dense", (2, 2)), ("qwen2", (2, 4))], ids=_ids)
def test_factored_moments_over_sharded_leaves(case, models, monkeypatch):
    """FACTOR_THRESHOLD patched in both packages' optimizer modules (not
    edited): wq and the MLP factored, their row and column means over dims
    cut over "data" and "model" pmeaned, held to the reference and their
    moments to the whole-tensor step's."""
    name, shape = case
    monkeypatch.setattr(jopt, "FACTOR_THRESHOLD", FACTOR_THRESHOLD)
    monkeypatch.setattr(opt, "FACTOR_THRESHOLD", FACTOR_THRESHOLD)
    _, _, cfg, params = models[name]
    state = opt.adamw_init(params)
    layer = state.moments["layers"][0]
    assert "vr" in layer["attn"]["wq"] and "vr" in layer["mlp"]["w_down"]
    assert "v" in layer["attn"]["wk"]
    ref_infos, ref_params = _reference(models, name)
    whole_infos, _, whole_state, _ = _whole(models, name)
    infos, got, got_state, _ = _partitioned(cfg, params, _mesh(shape))
    _assert_infos_close(infos, ref_infos, "reference")
    _assert_infos_close(infos, whole_infos, "whole-tensor step")
    _assert_params_close(params_to_numpy(got), ref_params)
    # a factored leaf's bf16 first moment to a rounding of the first step's,
    # carried by b1 (tests/test_torch_optim.py's limit), the rest to TOL
    for g, w in zip(tree_leaves(got_state.moments), tree_leaves(whole_state.moments)):
        assert g.dtype == w.dtype
        rtol, atol = (2 ** -7, 2 ** -8) if w.dtype == torch.bfloat16 else (TOL, TOL)
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=atol * float(w.float().abs().max()))
    assert int(got_state.step) == 2


# ---- the traps ---------------------------------------------------------------
def test_every_storage_written_once(models, monkeypatch):
    """On (2, 2) of one device the ranks share the storage of every leaf
    not cut over both axes (the norms: each one tensor for all four); the
    optimizer writes each distinct storage region exactly once, and the
    step equals the whole-tensor step."""
    _, _, cfg, params = models["qwen2"]
    mesh = _mesh((2, 2))
    p, s, cut = _shard(cfg, params, mesh)
    ln = [t["layers"][0]["ln1"] for t in p.local]
    assert len({x.data_ptr() for x in ln}) == 1
    writes, lock, copy_ = [], threading.Lock(), torch.Tensor.copy_
    update, inside = opt.adamw_update_sharded, threading.local()

    def counted(self, src, *a, **k):
        if getattr(inside, "on", False):
            with lock:
                writes.append((self.data_ptr(), tuple(self.shape), self.stride()))
        return copy_(self, src, *a, **k)

    def updating(*a, **k):
        inside.on = True
        try:
            return update(*a, **k)
        finally:
            inside.on = False
    monkeypatch.setattr(torch.Tensor, "copy_", counted)
    monkeypatch.setattr(opt, "adamw_update_sharded", updating)
    step = steps.build_train_step(cfg)
    p, s, info = step(p, s, cut(_batches(cfg)[0]))
    targets = {(x.data_ptr(), tuple(x.shape), x.stride())
               for r in range(mesh.n_ranks)
               for t in opt.leaf_targets(p.local[r], s.local[r].moments) for x in t}
    assert len(writes) == len(set(writes)) == len(targets)
    assert set(writes) == targets
    whole_infos, _, _, _ = _whole(models, "qwen2")
    np.testing.assert_allclose(float(info["loss"]), whole_infos[0][0], rtol=TOL)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_train_step_leaves_no_tensor_in_a_reference_cycle(shape, models):
    """After a partitioned train step no tensor is held by a reference
    cycle: each storage goes when its last reference does, not when the
    garbage collector next runs (`optimizer._zip`'s walk once closed over
    itself and its output list, which kept every rank's gradients alive
    into the next step and moved the card's rise in memory over it)."""
    _, _, cfg, params = models["dense"]
    p, s, cut = _shard(cfg, params, _mesh(shape))
    step = steps.build_train_step(cfg)
    b = cut(_batches(cfg)[0])
    p, s, _ = step(p, s, b)
    gc.collect()
    gc.disable()
    try:
        p, s, _ = step(p, s, b)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        held = [x for x in gc.garbage if torch.is_tensor(x)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not held, [tuple(x.shape) for x in held]


@pytest.mark.parametrize("remat", [True, False])
def test_grad_mode_reaches_the_rank_threads(remat, models, monkeypatch):
    """With remat, every rank's layer runs first without grad (the
    checkpoint's forward, in the rank threads) and again with it (the
    recompute, all ranks in lockstep); without, once with grad."""
    _, _, cfg, params = models["dense"]
    mesh = _mesh((2, 2))
    seen, lock, layer = [], threading.Lock(), tp._layer

    def recording(*a, **k):
        with lock:
            seen.append((torch.is_grad_enabled(),
                         threading.current_thread() is threading.main_thread()))
        return layer(*a, **k)
    monkeypatch.setattr(tp, "_layer", recording)
    p, _, cut = _shard(cfg, params, mesh)
    loss, _ = partition.loss_and_grads(cfg, p, cut(_batches(cfg)[0]), remat=remat)
    n = cfg.num_layers * mesh.n_ranks
    assert not any(main for _, main in seen)
    assert [g for g, _ in seen] == ([False] * n + [True] * n if remat else [True] * n)
    whole_infos, _, _, _ = _whole(models, "dense")
    np.testing.assert_allclose(float(loss), whole_infos[0][0], rtol=TOL)


def test_backward_collectives_run_in_the_callers_thread(models, monkeypatch):
    """One backward over one graph spanning the ranks: every collective's
    dual runs in the thread that called the step, none in a rank thread
    (where ranks sharing a card would wait on each other)."""
    _, _, cfg, params = models["dense"]
    threads, back = set(), common._Collective.backward

    def recording(ctx, *grads):
        threads.add(threading.current_thread() is threading.main_thread())
        return back(ctx, *grads)
    monkeypatch.setattr(common._Collective, "backward", staticmethod(recording))
    p, _, cut = _shard(cfg, params, _mesh((2, 2)))
    partition.loss_and_grads(cfg, p, cut(_batches(cfg)[0]))
    assert threads == {True}


def test_dropped_gradient_partial_reads_above_the_limit(models):
    """On (4, 1) (FSDP alone) the only reduce-scatters are the backward's
    of the weights' all-gathers: one that drops the last rank's partial
    leaves the loss and the replicated norms' gradients within TOL and
    moves every FSDP-cut leaf's gradient far above it."""
    _, _, cfg, params = models["dense"]

    class Dropping(GangMesh):
        def psum_scatter(self, xs, axes, *, scatter_dimension):
            return super().psum_scatter(xs[:-1] + [torch.zeros_like(xs[-1])], axes,
                                        scatter_dimension=scatter_dimension)
    mesh = _mesh((4, 1), Dropping)
    p, _, cut = _shard(cfg, params, mesh)
    loss, grads = partition.loss_and_grads(cfg, p, cut(_batches(cfg)[0]))
    whole_infos, _, _, whole_grads = _whole(models, "dense")
    np.testing.assert_allclose(float(loss), whole_infos[0][0], rtol=TOL)
    for spec, g, w in zip(_spec_leaves(p.specs), mdl.param_leaves(partition.unshard_tree(grads)),
                          mdl.param_leaves(whole_grads)):
        if any(spec):
            assert _rel(g, w) > 1e-2, (spec, _rel(g, w))
        else:
            assert _rel(g, w) <= TOL, (spec, _rel(g, w))


def _spec_leaves(specs):
    out = []
    shd.walk(lambda path, spec, n: out.append(spec), specs)
    return out


# ---- collective bytes ----------------------------------------------------------
@pytest.mark.parametrize("name,shape,threshold", [
    ("dense", (2, 2), None), ("qwen2", (2, 4), None), ("vlm", (1, 4), None),
    ("phi3", (4, 1), None), ("dense", (1, 4), 200_000)])
def test_meta_rank_count_equals_cpu_ranks(name, shape, threshold, models, monkeypatch):
    """The dry run's count (rank 0 alone on meta ranks, 4 layers from 2
    and 3) of a train step equals every CPU rank's: forward, remat,
    backward, the gradients' sums and the optimizer's.  With a
    FACTOR_THRESHOLD that factors wq and wo by their stack of 4 layers and
    not of 3, the 2- and 3-layer runs take the moments of 4."""
    if threshold:
        monkeypatch.setattr(opt, "FACTOR_THRESHOLD", threshold)
    _, _, cfg, _ = models[name]
    cfg = dataclasses.replace(cfg, num_layers=4)
    params = mdl.init_params(cfg, device="cpu")
    mesh = _mesh(shape)
    _, _, _, count = _partitioned(cfg, params, mesh)
    got = dryrun.collective_bytes(cfg, _train_shape(), mesh)
    assert got == count and count["total"] > 0
    assert count["reduce-scatter"] > 0 and count["all-reduce"] > 0


# ---- the launcher --------------------------------------------------------------
def test_launcher_shards_on_a_host_mesh(models, monkeypatch):
    """`launch/train.train` on four CPU ranks runs the partitioned step
    every step and equals its run on whole tensors."""
    _, _, cfg, params = models["vlm"]
    calls = []
    part = partition.train
    monkeypatch.setattr(partition, "train", lambda *a, **k: calls.append(1) or part(*a, **k))
    kw = dict(steps=2, batch=4, seq=16, device="cpu", log=lambda s: None)
    sharded = train.train(cfg, _clone(params), mesh=_mesh((2, 2)), **kw)
    assert len(calls) == 2
    whole = train.train(cfg, _clone(params), **kw)
    assert len(calls) == 2
    np.testing.assert_allclose(sharded["losses"], whole["losses"], rtol=TOL)
    np.testing.assert_allclose(sharded["grad_norms"], whole["grad_norms"], rtol=TOL)
    _assert_params_close(params_to_numpy(sharded["params"]), params_to_numpy(whole["params"]))


# ---- the reference's partitioned train step ------------------------------------
def _analysis(compiled) -> dict:
    """One device's temp bytes and FLOPs of a compiled SPMD step, as the
    reference's dry run reads them (``memory_analysis``, ``cost_analysis``)."""
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return {"temp": int(compiled.memory_analysis().temp_size_in_bytes),
            "flops": float(cost["flops"])}


def _jax_outputs(path, more=False):
    """The reference's train step jitted under the dry run's fsdp in- and
    out-shardings on a (2, 2) mesh of four XLA devices: its (loss,
    grad_norm) on the reduced dense model's first batch, its collective
    bytes from the compiled HLO, and one device's temp bytes and FLOPs
    (`_analysis`), with `more` also on (1, 4); needs
    4 XLA devices."""
    from jax.sharding import Mesh, NamedSharding

    from repro.launch import shardings as jshd
    from repro.launch.dryrun import collective_bytes_from_hlo
    assert jax.device_count() >= 4, jax.device_count()
    jcfg, _ = _configs("dense")
    params = jmdl.init_params(jax.random.PRNGKey(0), jcfg)
    state = jopt.adamw_init(params)
    batch = {k: jnp.asarray(v) for k, v in _batches(jcfg)[0].items()}
    m = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    pspecs = jshd.param_specs(jcfg, params, m, fsdp=True)
    p_sh = jshd.to_shardings(m, pspecs)
    o_sh = jshd.to_shardings(m, jshd.opt_specs(pspecs, state))
    b_sh = {k: NamedSharding(m, v) for k, v in
            jshd.batch_specs(jcfg, _train_shape(), m).items()}
    with m:
        fn = jax.jit(jst.build_train_step(jcfg, mesh=m, remat=True),
                     in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
        compiled = fn.lower(params, state, batch).compile()
        _, _, info = fn(jax.device_put(params, p_sh), jax.device_put(state, o_sh),
                        jax.device_put(batch, b_sh))
    ref = {"loss": float(info["loss"]), "grad_norm": float(info["grad_norm"]),
           "bytes": collective_bytes_from_hlo(compiled.as_text()),
           "analysis": {"2x2": _analysis(compiled)}}
    if more:
        m = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
        pspecs = jshd.param_specs(jcfg, params, m, fsdp=True)
        shardings = (jshd.to_shardings(m, pspecs),
                     jshd.to_shardings(m, jshd.opt_specs(pspecs, state)),
                     {k: NamedSharding(m, v) for k, v in
                      jshd.batch_specs(jcfg, _train_shape(), m).items()})
        with m:
            fn = jax.jit(jst.build_train_step(jcfg, mesh=m, remat=True),
                         in_shardings=shardings, out_shardings=shardings[:2] + (None,))
            ref["analysis"]["1x4"] = _analysis(fn.lower(params, state, batch).compile())
    np.savez(path, reference=np.frombuffer(json.dumps(ref).encode(), np.uint8))


def _run_reference(path, *more):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, __file__, str(path), *more], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return json.loads(np.load(path)["reference"].tobytes())


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return _run_reference(tmp_path_factory.mktemp("partition_train") / "reference.npz")


def test_reference_partitioned_train_step(jax_out, models):
    """The reference's own partitioned train step on (2, 2) gives the
    port's partitioned loss and grad norm, and gathers and reduces as the
    port does (PERF.md sets the bytes side by side: `python
    tests/test_torch_partition_train.py --bytes`)."""
    _, _, cfg, params = models["dense"]
    infos, _, _, _ = _partitioned(cfg, params, _mesh((2, 2)))
    np.testing.assert_allclose(infos[0], (jax_out["loss"], jax_out["grad_norm"]), rtol=TOL)
    ref = jax_out["bytes"]
    assert ref["all-gather"] > 0 and ref["reduce-scatter"] + ref["all-reduce"] > 0


def main(argv):
    if argv[:1] == ["--bytes"]:
        path = ROOT / "build" / "partition_train_reference.npz"
        path.parent.mkdir(exist_ok=True)
        ref = _run_reference(path, "--more")
        _, cfg = _configs("dense")
        acct = {tag: dryrun.rank_account(cfg, _train_shape(), _mesh(shape))
                for tag, shape in (("2x2", (2, 2)), ("1x4", (1, 4)))}
        print(json.dumps({"mesh": "2x2", "step": "train", "reference": ref["bytes"],
                          "port": acct["2x2"]["collectives"]}))
        for tag, got in ref["analysis"].items():
            print(json.dumps({"mesh": tag, "step": "train", "reference_temp": got["temp"],
                              "port_temp": acct[tag]["temp"],
                              "reference_flops": got["flops"],
                              "reference_flops_trip_scaled": got["flops"] * cfg.num_layers,
                              "port_flops": acct[tag]["flops"]}))
        return 0
    _jax_outputs(argv[0], more="--more" in argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
