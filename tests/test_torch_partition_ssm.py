"""The partitioned steps of the ssm and hybrid families (`models/tp._mamba`,
the Mamba2 scan over "model"; the hybrid's shared block tensor-parallel)
on meshes of CPU ranks, reduced f32 configs, the reference's weights
bridged: the prefill and serve steps (`launch/partition.prefill`, `serve`)
and the FSDP train step (`partition.train`).

* Configs, from ``reduced_config(get_config(...))``: mamba2_130m-like at
  d_model 256 (16 heads of 32, which divide 4 and 8 model ranks: each rank
  scans its heads), at d_model 192 (12 heads, which do not divide 8: the
  rules' sequence fallback, each rank scanning its rows from a zero state
  and taking the state entering them from the earlier ranks'), and
  zamba2_2_7b-like at 4 layers (two segments, `attn_every` 2, the shared
  block's 4 MHA heads of 64).  Meshes ["cpu"] x 4 shaped (1, 4), (2, 2),
  (4, 1) and ["cpu"] x 8 shaped (1, 8).
* A prefill and 4 greedy serve steps from `Sharded` arguments against the
  reference's `build_prefill_step` / `build_serve_step` without a mesh
  (logits 1e-4, caches 1e-5, the same greedy tokens) and the port's
  whole-tensor steps (1e-5): the scan once per layer and rank, B1 once per
  shared-block application and rank, no B2 where the shared block's cache
  is sequence-sharded; the fallback with row pieces that split a chunk and
  pieces of one whole chunk; one sequence under the long-context rules,
  where the batch axes do not divide B = 1 and the scan stays whole.
* Two train steps against the reference's jitted ``build_train_step``
  without a mesh (loss and grad norm 1e-5 relative, params 1e-5 but for
  AdamW's ±lr flips) and every gradient of `partition.loss_and_grads`
  against `steps.loss_and_grads` (1e-5 in relative norm; A_log 5e-5).
* Faults: one rank's heads dropped from y's all-gather, the entering state
  dropped in the fallback, the last model rank's partial dropped from
  in_proj's gradient sum, each far above its limit.
* Collective bytes: a closed form per layer on (2, 2) and (1, 4), and the
  dry run's count on meta ranks equal to the CPU ranks' for a prefill, a
  serve step and a train step; `launch/train.train` on a (2, 2) host mesh.

The partitioned ssm and hybrid steps on the card against the CPU ranks'
are in tests/test_torch_cuda.py, which imports no JAX.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch import steps as jst
from repro.models import model as jmdl
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, partition, steps, train
from repro_torch.launch import shardings as shd
from repro_torch.models import mamba2, tp
from repro_torch.models import model as mdl
from repro_torch.sp.common import KINDS, GangMesh
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)

TWIN_TOL = 1e-4      # logits against the reference
CACHE_TOL = 1e-5     # caches against the reference
TOL = 1e-5           # against the port's whole-tensor step; train against both
#: A_log's gradient sums dt·A·(...) over every position and head row, terms
#: that cancel: the whole-tensor step's own reads up to 2.5e-5 from the
#: same step run in f64 (these configs, CPU), and the partitioned step's,
#: summed in another order, as much
A_LOG_TOL = 5e-5
LR = 3e-4
STEPS = 4
B, PROMPT = 4, 32
#: name -> (arch, reduced_config keywords, cache length)
CONFIGS = {
    "ssm16": ("mamba2_130m", dict(layers=2), 40),
    "ssm12": ("mamba2_130m", dict(layers=2, d_model=192), 40),
    "hybrid": ("zamba2_2_7b", dict(layers=4), 40),
}
CASES = [("ssm16", (1, 4)), ("ssm16", (2, 2)), ("ssm12", (1, 8)), ("hybrid", (2, 2)),
         ("hybrid", (1, 4))]


def _configs(name):
    arch, kw, _ = CONFIGS[name]
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch), **kw), dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch), **kw), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _mesh(shape, cls=GangMesh):
    return cls(["cpu"] * (shape[0] * shape[1]), shape, ("data", "model"))


def _ids(v):
    if isinstance(v, tuple):
        return f"{v[0]}x{v[1]}"
    return v if isinstance(v, str) else f"S{v}"


def _tokens(cfg, batch=B, prompt=PROMPT):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)


def _shapes(name, batch=B, prompt=PROMPT):
    cache = max(CONFIGS[name][2], prompt + STEPS)
    return (ShapeConfig(f"prefill_{batch}x{prompt}", prompt, batch, "prefill"),
            ShapeConfig(f"decode_{batch}", cache, batch, "decode"))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jcfg, cfg = _configs(name)
        tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
        out[name] = (jcfg, tree, cfg, params_from_jax(tree, device="cpu"))
    return out


class _Calls:
    """Counts the calls of a module function it replaces, from any thread."""

    def __init__(self, monkeypatch, module, name):
        self.n, fn, lock = 0, getattr(module, name), threading.Lock()

        def counted(*a, **k):
            with lock:
                self.n += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counted)


def _caches(cache):
    """The cache's tensors by name, numpy: conv, ssm, sh_k, sh_v, len."""
    out = {"conv": cache["ssm"].conv, "ssm": cache["ssm"].ssm, "len": cache["len"]}
    out.update({k: cache[k] for k in ("sh_k", "sh_v") if k in cache})
    return {k: np.asarray(v) for k, v in out.items()}


# ---- prefill and serve -------------------------------------------------------
_REFERENCE = {}


def _reference(models, name):
    """The reference's prefill and STEPS greedy serve steps, no mesh:
    (logits per step, tokens, the cache after the last step)."""
    if name not in _REFERENCE:
        jcfg, tree, _, _ = models[name]
        jparams = jax.tree.map(jnp.asarray, tree)
        pre, dec = _shapes(name)
        cache = jmdl.init_cache(jcfg, B, dec.seq_len)
        lg, cache = jst.build_prefill_step(jcfg, pre)(
            jparams, {"tokens": jnp.asarray(_tokens(jcfg))}, cache)
        serve = jax.jit(jst.build_serve_step(jcfg, dec))
        logits, toks = [np.asarray(lg)], []
        for _ in range(STEPS):
            toks.append(np.asarray(lg.argmax(-1), np.int32))
            lg, cache = serve(jparams, cache, jnp.asarray(toks[-1]))
            logits.append(np.asarray(lg))
        _REFERENCE[name] = (logits, toks, _caches(cache))
    return _REFERENCE[name]


def _whole(cfg, params, name, tokens=None, batch=B, prompt=PROMPT):
    """The port's whole-tensor steps, fed `tokens` (default: greedy)."""
    pre, dec = _shapes(name, batch, prompt)
    cache = mdl.init_cache(cfg, batch, dec.seq_len, device="cpu")
    lg, cache = steps.build_prefill_step(cfg, pre)(
        params, {"tokens": torch.from_numpy(_tokens(cfg, batch, prompt))}, cache)
    serve = steps.build_serve_step(cfg, dec)
    logits, toks = [lg], []
    for i in range(STEPS):
        toks.append(lg.argmax(-1) if tokens is None else tokens[i])
        lg, cache = serve(params, cache, toks[-1])
        logits.append(lg)
    return logits, toks, cache


def _partitioned(cfg, params, name, mesh, tokens=None, batch=B, prompt=PROMPT):
    """The partitioned steps over `mesh` from shards of the same weights:
    (logits per step, tokens, the cache unsharded, the collective bytes of
    the prefill and of each serve step)."""
    pre, dec = _shapes(name, batch, prompt)
    p = partition.shard_tree(params, shd.param_specs(cfg, params, mesh, fsdp=False), mesh)
    b = partition.shard_tree({"tokens": torch.from_numpy(_tokens(cfg, batch, prompt))},
                             shd.batch_specs(cfg, pre, mesh), mesh)
    cache = mdl.init_cache(cfg, batch, dec.seq_len, device="cpu")
    c = partition.shard_tree(cache, shd.cache_specs(cfg, cache, mesh, global_batch=batch),
                             mesh)
    tspec = shd.batch_specs(cfg, dec, mesh)["token"]
    mesh.reset_bytes()
    lg, c = steps.build_prefill_step(cfg, pre)(p, b, c)
    counts = [dict(mesh.collective_bytes[0])]
    serve = steps.build_serve_step(cfg, dec)
    logits, toks = [partition.unshard_tree(lg)], []
    for i in range(STEPS):
        toks.append(logits[-1].argmax(-1) if tokens is None else tokens[i])
        mesh.reset_bytes()
        lg, c = serve(p, c, partition.shard_tree(toks[-1], tspec, mesh))
        counts.append(dict(mesh.collective_bytes[0]))
        logits.append(partition.unshard_tree(lg))
    return logits, toks, partition.unshard_tree(c), counts


def _close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=tol, rtol=tol,
                                   err_msg=f"{what} {i}")


def _layout(cfg, mesh, batch=B, prompt=PROMPT):
    pl = tp.plan(cfg, mesh, batch=batch, seq=prompt, long_context=batch == 1)
    return ("heads" if pl.ssd_heads else "rows" if pl.ssd_rows else "whole"), pl


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{_ids(c[1])}")
def test_partitioned_matches_reference(case, models):
    name, shape = case
    _, _, cfg, params = models[name]
    want_logits, want_toks, want_cache = _reference(models, name)
    logits, toks, cache, _ = _partitioned(cfg, params, name, _mesh(shape))
    assert [t.tolist() for t in toks] == [t.tolist() for t in want_toks]
    _close(logits, want_logits, TWIN_TOL, "step")
    got = _caches(cache)
    assert set(got) == set(want_cache)
    for k, w in want_cache.items():
        np.testing.assert_allclose(got[k], w, atol=CACHE_TOL, rtol=CACHE_TOL, err_msg=k)


WHOLE_CASES = CASES + [("ssm16", (4, 1)), ("ssm16", (1, 8)), ("hybrid", (4, 1))]


@pytest.mark.parametrize("case", WHOLE_CASES, ids=lambda c: f"{c[0]}-{_ids(c[1])}")
def test_partitioned_matches_whole_tensor_step(case, models, monkeypatch):
    """... fed the same tokens: the scan once per layer and rank in the
    prefill, B1 once per shared-block application and rank, no B2 where
    the shared block's cache is sequence-sharded."""
    name, shape = case
    _, _, cfg, params = models[name]
    mesh = _mesh(shape)
    assert _layout(cfg, mesh)[0] == ("heads" if cfg.ssm_heads % shape[1] == 0 else "rows")
    want_logits, toks, want_cache = _whole(cfg, params, name)
    scan = _Calls(monkeypatch, ops, "ssd_scan")
    attn = _Calls(monkeypatch, ops, "attention")
    dec = _Calls(monkeypatch, ops, "decode_attention")
    logits, _, cache, _ = _partitioned(cfg, params, name, mesh, tokens=toks)
    segments = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    assert scan.n == cfg.num_layers * mesh.n_ranks
    assert attn.n == segments * mesh.n_ranks
    assert dec.n == 0
    _close(logits, want_logits, TOL, "step")
    got, want = _caches(cache), _caches(want_cache)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("prompt", [256, 96], ids=_ids)
def test_sequence_fallback_at_chunk_edges(prompt, models):
    """12 heads on (1, 8): each rank's rows are one whole 32-token chunk
    (256) or straddle two (96: 12 rows from row 12 on); the states passed
    between the ranks give the whole-tensor step's logits and caches."""
    _, _, cfg, params = models["ssm12"]
    mesh = _mesh((1, 8))
    assert _layout(cfg, mesh, prompt=prompt)[0] == "rows"
    assert (prompt // 8) % cfg.ssm_chunk == (0 if prompt == 256 else 12)
    want_logits, toks, want_cache = _whole(cfg, params, "ssm12", prompt=prompt)
    logits, _, cache, _ = _partitioned(cfg, params, "ssm12", mesh, tokens=toks, prompt=prompt)
    _close(logits, want_logits, TOL, "step")
    got, want = _caches(cache), _caches(want_cache)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("name", ["ssm16", "hybrid"])
def test_one_sequence_scans_whole(name, models, monkeypatch):
    """B == 1 under the long-context rules on (2, 2): the batch axes do
    not divide one sequence, so neither of xh's options resolves and every
    rank scans every head of the whole sequence (the residual's rows and
    the hybrid's cache over both axes); the steps equal the whole-tensor
    steps."""
    _, _, cfg, params = models[name]
    mesh = _mesh((2, 2))
    layout, pl = _layout(cfg, mesh, batch=1)
    assert layout == "whole" and pl.seq == ("data", "model")
    want_logits, toks, want_cache = _whole(cfg, params, name, batch=1)
    scans = []
    scan = mamba2.mamba2_scan
    monkeypatch.setattr(mamba2, "mamba2_scan", lambda *a, **k: (
        scans.append((a[2].shape[1], k.get("heads"))), scan(*a, **k))[1])
    logits, _, cache, _ = _partitioned(cfg, params, name, mesh, tokens=toks, batch=1)
    assert set(scans) == {(PROMPT, None)} and len(scans) == cfg.num_layers * mesh.n_ranks
    _close(logits, want_logits, TOL, "step")
    got, want = _caches(cache), _caches(want_cache)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)


# ---- the train step ----------------------------------------------------------
def _batches(cfg, seq, batch=B, n=2):
    """`n` numpy train batches from a seed: tokens, labels the tokens
    shifted left with the last and, in the first row, every third -1."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        tok = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        lab = np.pad(tok[:, 1:], ((0, 0), (0, 1)), constant_values=-1)
        lab[0, ::3] = -1
        out.append({"tokens": tok, "labels": lab})
    return out


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _train_shape(seq, batch=B):
    return ShapeConfig(f"train_{batch}x{seq}", seq, batch, "train")


def _clone(tree):
    return mdl.tree_like(tree, [x.clone() for x in mdl.param_leaves(tree)])


_TRAIN = {}


def _reference_train(models, name):
    """The reference's jitted train step without a mesh, two steps:
    ([(loss, grad_norm)], the params after them, numpy)."""
    key = ("reference", name)
    if key not in _TRAIN:
        jcfg, tree, _, _ = models[name]
        p = jax.tree.map(jnp.asarray, tree)
        s = jopt.adamw_init(p)
        step = jax.jit(jst.build_train_step(jcfg, remat=True))
        infos = []
        for b in _batches(jcfg, PROMPT):
            p, s, info = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            infos.append((float(info["loss"]), float(info["grad_norm"])))
        _TRAIN[key] = (infos, jax.tree.map(np.asarray, p))
    return _TRAIN[key]


def _whole_train(models, name):
    """The port's whole-tensor step, two steps: ([(loss, grad_norm)], the
    params after them, the gradients of the first batch)."""
    key = ("whole", name)
    if key not in _TRAIN:
        _, _, cfg, params = models[name]
        p = _clone(params)
        s = opt.adamw_init(p)
        bs = _batches(cfg, PROMPT)
        _, grads = steps.loss_and_grads(cfg, p, _torch(bs[0]))
        step = steps.build_train_step(cfg)
        infos = []
        for b in bs:
            p, s, info = step(p, s, _torch(b))
            infos.append((float(info["loss"]), float(info["grad_norm"])))
        _TRAIN[key] = (infos, p, grads)
    return _TRAIN[key]


def _shard(cfg, params, mesh, seq=PROMPT):
    """(params, optimizer state) cut by the fsdp specs over `mesh` (views
    of a copy of `params`), and a function cutting a numpy batch."""
    params = _clone(params)
    state = opt.adamw_init(params)
    pspecs = shd.param_specs(cfg, params, mesh, fsdp=True)
    bspecs = shd.batch_specs(cfg, _train_shape(seq), mesh)
    return (partition.shard_tree(params, pspecs, mesh),
            partition.shard_tree(state, shd.opt_specs(pspecs, state), mesh),
            lambda b: partition.shard_tree(_torch(b), bspecs, mesh))


def _partitioned_train(cfg, params, mesh, seq=PROMPT):
    """Two partitioned train steps: ([(loss, grad_norm)], the params after
    them unsharded, the collective bytes of the first step)."""
    p, s, cut = _shard(cfg, params, mesh, seq)
    step = steps.build_train_step(cfg)
    infos, counts = [], []
    for b in _batches(cfg, seq):
        mesh.reset_bytes()
        p, s, info = step(p, s, cut(b))
        counts.append(dict(mesh.collective_bytes[0]))
        infos.append((float(info["loss"]), float(info["grad_norm"])))
    return infos, partition.unshard_tree(p), counts[0]


def _assert_params_close(got, want, n_steps=2, tol=TOL):
    """Params after `n_steps` AdamW steps from equal weights: within rtol
    = atol = `tol`, but for at most 1e-4 of a leaf's elements (one at
    least), each within 2 x lr x n_steps: where a gradient is ~0, its
    rounding decides the sign of m̂ / sqrt(v̂) ~ ±1, and so an update of
    ±lr."""
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        off = ~np.isclose(g, w, rtol=tol, atol=tol)
        assert off.sum() <= max(1, w.size // 10_000), (i, int(off.sum()))
        assert np.abs(g - w).max() <= 2 * LR * n_steps, i


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _paths(tree):
    out = []
    shd.walk(lambda path, x, n: out.append(path), tree)
    return out


#: every leaf of a Mamba2 layer and, for the hybrid, of the shared block
MAMBA_LEAVES = {"in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D", "norm", "out_proj"}
TRAIN_CASES = [("ssm16", (1, 4)), ("ssm16", (2, 2)), ("ssm16", (4, 1)), ("ssm12", (1, 8)),
               ("hybrid", (2, 2)), ("hybrid", (1, 4))]


@pytest.mark.parametrize("case", TRAIN_CASES, ids=lambda c: f"{c[0]}-{_ids(c[1])}")
def test_partitioned_train_matches_reference(case, models):
    name, shape = case
    _, _, cfg, params = models[name]
    mesh = _mesh(shape)
    ref_infos, ref_params = _reference_train(models, name)
    whole_infos, whole_params, whole_grads = _whole_train(models, name)
    p, _, cut = _shard(cfg, params, mesh)
    loss, grads = partition.loss_and_grads(cfg, p, cut(_batches(cfg, PROMPT)[0]))
    np.testing.assert_allclose(float(loss), whole_infos[0][0], rtol=TOL)
    got = partition.unshard_tree(grads)
    paths = _paths(got)
    names = {path[-1] for path in paths}
    assert MAMBA_LEAVES | {"ln"} <= names
    if cfg.family == "hybrid":
        assert sum(path[0] == "shared" for path in paths) == 9
    for path, g, w in zip(paths, mdl.param_leaves(got), mdl.param_leaves(whole_grads)):
        assert _rel(g, w) <= (A_LOG_TOL if path[-1] == "A_log" else TOL), (path, _rel(g, w))
    infos, got_params, _ = _partitioned_train(cfg, params, mesh)
    for what, want in (("reference", ref_infos), ("whole-tensor step", whole_infos)):
        for i, (g, w) in enumerate(zip(infos, want)):
            np.testing.assert_allclose(g, w, rtol=TOL, err_msg=f"{what} step {i}")
    _assert_params_close(params_to_numpy(got_params), ref_params)
    _assert_params_close(params_to_numpy(got_params), params_to_numpy(whole_params))


# ---- faults ------------------------------------------------------------------
def _prefill_rel(cfg, params, name, mesh, want):
    got, _, _, _ = _partitioned(cfg, params, name, mesh, tokens=want[1])
    return float((got[0] - want[0][0]).norm() / want[0][0].norm())


def test_dropped_heads_read_above_the_limit(models, monkeypatch):
    """The last model rank's heads left out of y's all-gather (its scan's y
    zeroed): the prefill's logits leave the whole-tensor step's by far
    more than TWIN_TOL."""
    _, _, cfg, params = models["ssm16"]
    want = _whole(cfg, params, "ssm16")
    scan, last = mamba2.mamba2_scan, cfg.ssm_heads - cfg.ssm_heads // 4

    def dropping(*a, heads=None, **k):
        y, h = scan(*a, heads=heads, **k)
        return (torch.zeros_like(y) if heads and heads[0] == last else y), h
    monkeypatch.setattr(mamba2, "mamba2_scan", dropping)
    assert _prefill_rel(cfg, params, "ssm16", _mesh((1, 4)), want) > 100 * TWIN_TOL


def test_dropped_entering_state_reads_above_the_limit(models, monkeypatch):
    """The sequence fallback with each rank's rows scanned from a zero
    state and the entering state never added: the prefill's logits leave
    the whole-tensor step's by far more than TWIN_TOL."""
    _, _, cfg, params = models["ssm12"]
    want = _whole(cfg, params, "ssm12")
    monkeypatch.setattr(mamba2, "enter_state", lambda y, *a: y)
    assert _prefill_rel(cfg, params, "ssm12", _mesh((1, 8)), want) > 100 * TWIN_TOL


def test_dropped_gradient_partial_reads_above_the_limit(models, monkeypatch):
    """The last model rank's partial of in_proj's gradient left out of its
    sum over "model" (`partition.loss_and_grads`): in_proj's gradient
    leaves the whole-tensor step's far above the limit, and every other
    leaf's stays within it."""
    _, _, cfg, params = models["ssm16"]
    mesh = _mesh((1, 4))
    p, _, cut = _shard(cfg, params, mesh)
    shape = tuple(p.local[0]["layers"][0]["mamba"]["in_proj"].shape)
    psum = partition.Rank.psum

    def dropping(self, x, axes):
        if (not torch.is_grad_enabled() and tuple(x.shape) == shape
                and self.index("model") == self.size("model") - 1):
            x = torch.zeros_like(x)
        return psum(self, x, axes)
    monkeypatch.setattr(partition.Rank, "psum", dropping)
    _, grads = partition.loss_and_grads(cfg, p, cut(_batches(cfg, PROMPT)[0]))
    _, _, whole_grads = _whole_train(models, "ssm16")
    got = partition.unshard_tree(grads)
    for path, g, w in zip(_paths(got), mdl.param_leaves(got), mdl.param_leaves(whole_grads)):
        if path[-1] == "in_proj":
            assert _rel(g, w) > 1e-2, (path, _rel(g, w))
        else:
            assert _rel(g, w) <= (A_LOG_TOL if path[-1] == "A_log" else TOL), path


# ---- collective bytes ----------------------------------------------------------
def _closed_form(cfg, mesh_shape):
    """Collective bytes per device (f32), prefill and one serve step, by
    kind, of the ssm16 config (heads over "model") and the hybrid's (its
    shared block's 4 MHA heads over "model" too)."""
    D, M = mesh_shape
    d, di, nh, hd, ns = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    b, s, f = B // D, PROMPT, 4
    s_max = _shapes("hybrid")[1].seq_len
    nl = cfg.num_layers
    pre = dict.fromkeys(KINDS, 0)
    dec = dict.fromkeys(KINDS, 0)
    if M > 1:
        # per Mamba2 layer: the residual gathered before the norm, y and
        # the final state gathered over the heads
        pre["all-gather"] = nl * (b * s * d + b * s * di + b * nh * hd * ns)
        # once: the embedding's reduce-scatter, the last rows' gather
        pre["reduce-scatter"] = b * (s // M) * d
        pre["all-gather"] += b * M * d
        # the serve step: the embedding's all-reduce; Mamba2 moves nothing
        dec["all-reduce"] = b * d
        if cfg.family == "hybrid":
            H, KV, ahd, n = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, nl // cfg.attn_every
            # per shared-block use as the dense layer's (tests/test_torch_partition.py)
            pre["all-gather"] += n * 2 * b * s * d
            pre["reduce-scatter"] += n * 2 * b * (s // M) * d
            pre["all-to-all"] = n * 2 * b * KV * (s_max // M) * ahd
            dec["all-gather"] = n * b * (H + 2 * KV) * ahd
            dec["all-reduce"] += n * (2 * b * H + b * H * ahd + 2 * b * d)
    for c in (pre, dec):
        for k in c:
            c[k] *= f
        c["total"] = sum(c.values())
    return pre, dec


@pytest.mark.parametrize("name,shape", [("ssm16", (2, 2)), ("ssm16", (1, 4)),
                                        ("hybrid", (2, 2)), ("hybrid", (1, 4))], ids=_ids)
def test_collective_bytes_closed_form(name, shape, models):
    _, _, cfg, params = models[name]
    _, _, _, counts = _partitioned(cfg, params, name, _mesh(shape))
    pre, dec = _closed_form(cfg, shape)
    assert counts[0] == pre
    assert all(c == dec for c in counts[1:])


@pytest.mark.parametrize("name,shape,kind", [
    ("ssm16", (2, 2), "prefill"), ("ssm12", (1, 8), "prefill"), ("hybrid", (1, 4), "prefill"),
    ("hybrid", (2, 2), "decode"), ("ssm12", (1, 8), "train"), ("hybrid", (4, 1), "train")],
    ids=_ids)
def test_meta_rank_count_equals_cpu_ranks(name, shape, kind, models):
    """The dry run's count (rank 0 alone on meta ranks, 4 units of depth
    from 2 and 3) equals the count of every CPU rank running the step."""
    _, _, cfg, _ = models[name]
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    cfg = dataclasses.replace(cfg, num_layers=4 * unit)
    params = mdl.init_params(cfg, device="cpu")
    mesh = _mesh(shape)
    pre, dec = _shapes(name)
    if kind == "train":
        _, _, want = _partitioned_train(cfg, params, mesh)
        got = dryrun.collective_bytes(cfg, _train_shape(PROMPT), mesh)
    else:
        _, _, _, counts = _partitioned(cfg, params, name, mesh)
        want = counts[0] if kind == "prefill" else counts[1]
        got = dryrun.collective_bytes(cfg, pre if kind == "prefill" else dec, mesh,
                                      max_len=dec.seq_len if kind == "prefill" else None)
    assert got == want and want["total"] > 0


# ---- the launcher --------------------------------------------------------------
@pytest.mark.parametrize("name", ["ssm16", "hybrid"])
def test_launcher_shards_on_a_host_mesh(name, models, monkeypatch):
    """`launch/train.train` on four CPU ranks runs the partitioned step
    every step and equals its run on whole tensors."""
    _, _, cfg, params = models[name]
    calls = []
    part = partition.train
    monkeypatch.setattr(partition, "train", lambda *a, **k: calls.append(1) or part(*a, **k))
    kw = dict(steps=2, batch=4, seq=16, device="cpu", log=lambda s: None)
    sharded = train.train(cfg, _clone(params), mesh=_mesh((2, 2)), **kw)
    assert len(calls) == 2
    whole = train.train(cfg, _clone(params), **kw)
    np.testing.assert_allclose(sharded["losses"], whole["losses"], rtol=TOL)
    np.testing.assert_allclose(sharded["grad_norms"], whole["grad_norms"], rtol=TOL)
    _assert_params_close(params_to_numpy(sharded["params"]), params_to_numpy(whole["params"]))
