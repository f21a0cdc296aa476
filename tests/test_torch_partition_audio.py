"""The partitioned steps of the audio family (`models/tp._encode`,
`_dec_layer`: the encoder, the decoder and the cross cache under the
sharding rules) on meshes of CPU ranks, the reduced f32 seamless_m4t_large_v2
config, the reference's weights bridged: the prefill and serve steps
(`launch/partition.prefill`, `serve`) and the FSDP train step
(`partition.train`).

* Config: ``reduced_config(get_config("seamless_m4t_large_v2"))`` in f32
  (2 encoder and 2 decoder layers, d_model 256, 4 MHA heads of 64, 16
  frames); meshes ["cpu"] x 4 shaped (1, 4), (2, 2), (4, 1) and ["cpu"] x 8
  shaped (1, 8), where the 4 heads do not divide 8 model ranks: the
  encoder takes the rules' sequence fallback (each rank's 2 frames of the
  queries) and the decoder's BOS row keeps every head.
* A prefill (16 frames and a BOS token) and 4 greedy serve steps from
  `Sharded` arguments against the reference's `build_prefill_step` /
  `build_serve_step` without a mesh (logits 1e-4, caches 1e-5 including
  cross_k / cross_v / cross_len, the same tokens) and against the port's
  whole-tensor steps (1e-5): B1 once per encoder layer, twice per decoder
  layer (self and cross) and rank, no B2 (both caches sequence-sharded).
* Two train steps against the reference's jitted ``build_train_step``
  without a mesh (loss and grad norm 1e-5 relative, params 1e-5 but for
  AdamW's ±lr flips) and every gradient of `partition.loss_and_grads`,
  the encoder's leaves included, against `steps.loss_and_grads` (1e-5 in
  relative norm); `Rank.remat` giving each of several inputs its gradient.
* Faults: the last model rank's partial dropped from one encoder
  all-reduce, the last rank's slice of the cross cache dropped from the
  serve step's merge, the encoder's output detached inside the decoder
  layers, each far above its limit.
* Collective bytes: a closed form per layer on (2, 2) and (1, 4), and the
  dry run's count on meta ranks equal to the CPU ranks' for a prefill, a
  serve step and a train step; `launch/train.train` on a (2, 2) host mesh.
* One sequence under the long-context rules raises.

The partitioned audio steps on the card against the CPU ranks' are in
tests/test_torch_cuda.py, which imports no JAX.
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
from repro_torch.models import model as mdl
from repro_torch.models import tp
from repro_torch.models.sharding import P
from repro_torch.sp.common import KINDS, GangMesh
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)

TWIN_TOL = 1e-4      # logits against the reference
CACHE_TOL = 1e-5     # caches against the reference
TOL = 1e-5           # against the port's whole-tensor step; train against both
LR = 3e-4
STEPS = 4
B, FRAMES, CACHE = 4, 16, 16     # sequences, encoder frames, self cache
DEC = 32                         # decoder tokens of a train batch
MESHES = [(1, 4), (2, 2), (4, 1), (1, 8)]
CACHES = ("k", "v", "cross_k", "cross_v", "cross_len", "len")


def _ids(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)


def _configs():
    arch = "seamless_m4t_large_v2"
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch)), dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.frontend_tokens == FRAMES
    return jcfg, cfg


def _mesh(shape, cls=GangMesh):
    return cls(["cpu"] * (shape[0] * shape[1]), shape, ("data", "model"))


def _inputs(cfg, batch=B):
    """(BOS tokens (batch, 1), frames (batch, FRAMES, d)), numpy, from a seed."""
    rng = np.random.default_rng(3)
    return (rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32),
            rng.standard_normal((batch, FRAMES, cfg.d_model)).astype(np.float32))


def _shapes(batch=B):
    return (ShapeConfig(f"prefill_{batch}x{FRAMES}", FRAMES, batch, "prefill"),
            ShapeConfig(f"decode_{batch}", CACHE, batch, "decode"))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tree, cfg, params_from_jax(tree, device="cpu")


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
    return {k: np.asarray(cache[k]) for k in CACHES}


# ---- prefill and serve -------------------------------------------------------
_REFERENCE = {}


def _reference(model):
    """The reference's prefill and STEPS greedy serve steps, no mesh:
    (logits per step, tokens, the cache after the last step)."""
    if not _REFERENCE:
        jcfg, tree, _, _ = model
        jparams = jax.tree.map(jnp.asarray, tree)
        pre, dec = _shapes()
        tok, frames = _inputs(jcfg)
        cache = jmdl.init_cache(jcfg, B, CACHE, enc_len=FRAMES)
        lg, cache = jst.build_prefill_step(jcfg, pre)(
            jparams, {"tokens": jnp.asarray(tok), "frames": jnp.asarray(frames)}, cache)
        serve = jax.jit(jst.build_serve_step(jcfg, dec))
        logits, toks = [np.asarray(lg)], []
        for _ in range(STEPS):
            toks.append(np.asarray(lg.argmax(-1), np.int32))
            lg, cache = serve(jparams, cache, jnp.asarray(toks[-1]))
            logits.append(np.asarray(lg))
        _REFERENCE["run"] = (logits, toks, _caches(cache))
    return _REFERENCE["run"]


def _batch(cfg, batch=B):
    tok, frames = _inputs(cfg, batch)
    return {"tokens": torch.from_numpy(tok), "frames": torch.from_numpy(frames)}


def _whole(cfg, params, tokens=None, batch=B):
    """The port's whole-tensor steps, fed `tokens` (default: greedy)."""
    pre, dec = _shapes(batch)
    cache = mdl.init_cache(cfg, batch, CACHE, enc_len=FRAMES, device="cpu")
    lg, cache = steps.build_prefill_step(cfg, pre)(params, _batch(cfg, batch), cache)
    serve = steps.build_serve_step(cfg, dec)
    logits, toks = [lg], []
    for i in range(STEPS):
        toks.append(lg.argmax(-1) if tokens is None else tokens[i])
        lg, cache = serve(params, cache, toks[-1])
        logits.append(lg)
    return logits, toks, cache


def _shards(cfg, params, mesh, batch=B):
    """(params, batch, cache) cut by the rules' specs over `mesh`."""
    pre, _ = _shapes(batch)
    cache = mdl.init_cache(cfg, batch, CACHE, enc_len=FRAMES, device="cpu")
    return (partition.shard_tree(params, shd.param_specs(cfg, params, mesh, fsdp=False), mesh),
            partition.shard_tree(_batch(cfg, batch), shd.batch_specs(cfg, pre, mesh), mesh),
            partition.shard_tree(cache, shd.cache_specs(cfg, cache, mesh, global_batch=batch),
                                 mesh))


def _partitioned(cfg, params, mesh, tokens=None, steps_=STEPS):
    """The partitioned steps over `mesh` from shards of the same weights:
    (logits per step, tokens, the cache unsharded, the collective bytes of
    the prefill and of each serve step)."""
    pre, dec = _shapes()
    p, b, c = _shards(cfg, params, mesh)
    tspec = shd.batch_specs(cfg, dec, mesh)["token"]
    mesh.reset_bytes()
    lg, c = steps.build_prefill_step(cfg, pre)(p, b, c)
    counts = [dict(mesh.collective_bytes[0])]
    serve = steps.build_serve_step(cfg, dec)
    logits, toks = [partition.unshard_tree(lg)], []
    for i in range(steps_):
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


def _rel(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_matches_reference(shape, model):
    _, _, cfg, params = model
    want_logits, want_toks, want_cache = _reference(model)
    logits, toks, cache, _ = _partitioned(cfg, params, _mesh(shape))
    assert [t.tolist() for t in toks] == [t.tolist() for t in want_toks]
    _close(logits, want_logits, TWIN_TOL, "step")
    got = _caches(cache)
    for k, w in want_cache.items():
        np.testing.assert_allclose(got[k], w, atol=CACHE_TOL, rtol=CACHE_TOL, err_msg=k)


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_matches_whole_tensor_step(shape, model, monkeypatch):
    """... fed the same tokens: B1 once per encoder layer and twice per
    decoder layer (self, cross) and rank in the prefill, none in a serve
    step, no B2 (the self and the cross cache are sequence-sharded); the
    encoder's query heads, or on (1, 8) its rows, and the decoder's BOS
    row with every head there."""
    _, _, cfg, params = model
    mesh = _mesh(shape)
    pl = tp.plan(cfg, mesh, batch=B, seq=1, long_context=False, frames=FRAMES)
    fallback = cfg.num_heads % shape[1] != 0
    assert pl.enc.seq == () and pl.seq == ()
    assert bool(pl.enc.q_rows) == fallback and bool(pl.enc.q_heads) == (not fallback)
    assert bool(pl.q_heads) == (not fallback) and not pl.q_rows
    want_logits, toks, want_cache = _whole(cfg, params)
    attn = _Calls(monkeypatch, ops, "attention")
    dec = _Calls(monkeypatch, ops, "decode_attention")
    logits, _, cache, _ = _partitioned(cfg, params, mesh, tokens=toks)
    assert attn.n == (cfg.encoder_layers + 2 * cfg.num_layers) * mesh.n_ranks
    assert dec.n == 0
    _close(logits, want_logits, TOL, "step")
    got, want = _caches(cache), _caches(want_cache)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL, err_msg=k)


def test_one_sequence_raises(model):
    """B == 1 under the long-context rules: the batch specs cut the
    decoder's one BOS token over ("data", "model"), which divides over no
    mesh of more than one rank; the rules' own cut raises, and so does the
    plan of a prefill given such specs."""
    _, _, cfg, params = model
    mesh = _mesh((2, 2))
    with pytest.raises(ValueError, match="does not divide"):
        _shards(cfg, params, mesh, batch=1)
    spec = shd.batch_specs(cfg, _shapes(1)[0], mesh)["tokens"]
    assert spec == P(None, ("data", "model"))
    with pytest.raises(ValueError, match="BOS token"):
        tp.plan(cfg, mesh, batch=1, seq=1, long_context=True, tok_spec=spec, frames=FRAMES)
    # one rank: nothing is cut, the step is the whole-tensor step's
    want_logits, toks, _ = _whole(cfg, params, batch=1)
    one = _mesh((1, 1))
    p, b, c = _shards(cfg, params, one, batch=1)
    lg, c = steps.build_prefill_step(cfg, _shapes(1)[0])(p, b, c)
    _close([partition.unshard_tree(lg)], want_logits[:1], TOL, "prefill")


# ---- the train step ----------------------------------------------------------
def _batches(cfg, dec=DEC, batch=B, n=2):
    """`n` numpy train batches from a seed: decoder tokens, frames, labels
    the tokens shifted left with the last and, in the first row, every
    third -1."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        tok = rng.integers(0, cfg.vocab_size, (batch, dec)).astype(np.int32)
        lab = np.pad(tok[:, 1:], ((0, 0), (0, 1)), constant_values=-1)
        lab[0, ::3] = -1
        frames = rng.standard_normal((batch, FRAMES, cfg.d_model)).astype(np.float32)
        out.append({"tokens": tok, "frames": frames, "labels": lab})
    return out


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _train_shape(batch=B):
    return ShapeConfig(f"train_{batch}x{FRAMES}", FRAMES, batch, "train")


def _clone(tree):
    return mdl.tree_like(tree, [x.clone() for x in mdl.param_leaves(tree)])


_TRAIN = {}


def _reference_train(model):
    """The reference's jitted train step without a mesh, two steps:
    ([(loss, grad_norm)], the params after them, numpy)."""
    if "reference" not in _TRAIN:
        jcfg, tree, _, _ = model
        p = jax.tree.map(jnp.asarray, tree)
        s = jopt.adamw_init(p)
        step = jax.jit(jst.build_train_step(jcfg, remat=True))
        infos = []
        for b in _batches(jcfg):
            p, s, info = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            infos.append((float(info["loss"]), float(info["grad_norm"])))
        _TRAIN["reference"] = (infos, jax.tree.map(np.asarray, p))
    return _TRAIN["reference"]


def _whole_train(model):
    """The port's whole-tensor step, two steps: ([(loss, grad_norm)], the
    params after them, the gradients of the first batch)."""
    if "whole" not in _TRAIN:
        _, _, cfg, params = model
        p = _clone(params)
        s = opt.adamw_init(p)
        bs = _batches(cfg)
        _, grads = steps.loss_and_grads(cfg, p, _torch(bs[0]))
        step = steps.build_train_step(cfg)
        infos = []
        for b in bs:
            p, s, info = step(p, s, _torch(b))
            infos.append((float(info["loss"]), float(info["grad_norm"])))
        _TRAIN["whole"] = (infos, p, grads)
    return _TRAIN["whole"]


def _shard(cfg, params, mesh):
    """(params, optimizer state) cut by the fsdp specs over `mesh` (views
    of a copy of `params`), and a function cutting a numpy batch."""
    params = _clone(params)
    state = opt.adamw_init(params)
    pspecs = shd.param_specs(cfg, params, mesh, fsdp=True)
    bspecs = shd.batch_specs(cfg, _train_shape(), mesh)
    return (partition.shard_tree(params, pspecs, mesh),
            partition.shard_tree(state, shd.opt_specs(pspecs, state), mesh),
            lambda b: partition.shard_tree(_torch(b), bspecs, mesh))


def _partitioned_train(cfg, params, mesh, dec=DEC):
    """Two partitioned train steps: ([(loss, grad_norm)], the params after
    them unsharded, the collective bytes of the first step)."""
    p, s, cut = _shard(cfg, params, mesh)
    step = steps.build_train_step(cfg)
    infos, counts = [], []
    for b in _batches(cfg, dec):
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


def _paths(tree):
    out = []
    shd.walk(lambda path, x, n: out.append(path), tree)
    return out


def _grads(cfg, params, mesh):
    p, _, cut = _shard(cfg, params, mesh)
    loss, grads = partition.loss_and_grads(cfg, p, cut(_batches(cfg)[0]))
    got = partition.unshard_tree(grads)
    return float(loss), got, _paths(got)


@pytest.mark.parametrize("shape", MESHES, ids=_ids)
def test_partitioned_train_matches_reference(shape, model):
    _, _, cfg, params = model
    mesh = _mesh(shape)
    ref_infos, ref_params = _reference_train(model)
    whole_infos, whole_params, whole_grads = _whole_train(model)
    loss, got, paths = _grads(cfg, params, mesh)
    np.testing.assert_allclose(loss, whole_infos[0][0], rtol=TOL)
    assert sum(path[0] == "encoder" for path in paths) == 9 * cfg.encoder_layers
    assert sum("xattn" in path for path in paths) == 4 * cfg.num_layers
    for path, g, w in zip(paths, mdl.param_leaves(got), mdl.param_leaves(whole_grads)):
        assert _rel(g, w) <= TOL, (path, _rel(g, w))
    infos, got_params, _ = _partitioned_train(cfg, params, mesh)
    for what, want in (("reference", ref_infos), ("whole-tensor step", whole_infos)):
        for i, (g, w) in enumerate(zip(infos, want)):
            np.testing.assert_allclose(g, w, rtol=TOL, err_msg=f"{what} step {i}")
    _assert_params_close(params_to_numpy(got_params), ref_params)
    _assert_params_close(params_to_numpy(got_params), params_to_numpy(whole_params))


@pytest.mark.parametrize("meta", [False, True], ids=["cpu", "meta"])
def test_remat_gives_every_input_its_gradient(meta):
    """`Rank.remat` of a stage of two inputs over four ranks (a psum inside,
    as a decoder layer's all-reduce) gives each input its gradient, as the
    stage run without the remat does; where neither input requires grad
    (the encoder's first layer, on the frames) the closed-over weight still
    gets its gradient.  On meta ranks (the dry run) the shapes alone."""
    dev = "meta" if meta else "cpu"
    mesh = GangMesh([dev] * 4, (2, 2), ("data", "model"))
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 5, generator=g).to(dev) for _ in range(4)]
    es = [torch.randn(3, 5, generator=g).to(dev) for _ in range(4)]
    w = torch.randn(5, 5, generator=g).to(dev)

    def run(remat, needs_input_grad=True):
        ws = [w.detach().clone().requires_grad_(True) for _ in range(4)]
        ins = [[t.detach().clone().requires_grad_(needs_input_grad) for t in ts]
               for ts in (xs, es)]

        def body(rk):
            def stage(rk, x, e):
                return rk.psum(torch.tanh(x @ ws[rk.rank]) * e, "model")
            x, e = ins[0][rk.rank], ins[1][rk.rank]
            y = rk.remat("stage", stage, x, e) if remat else stage(rk, x, e)
            return (y * y).sum()
        with torch.enable_grad():
            losses = partition.run_lockstep(mesh, body)
            torch.stack(losses).sum().backward()
        return ([t.grad for t in ins[0]], [t.grad for t in ins[1]], [v.grad for v in ws])
    got, want = run(True), run(False)
    for a, b in zip(got, want):
        for ga, gb in zip(a, b):
            if meta:
                if ga is None:
                    continue
                assert ga.shape == gb.shape
            else:
                torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)
    no_input = run(True, needs_input_grad=False)
    assert all(t is None for t in no_input[0] + no_input[1])
    for ga, gb in zip(no_input[2], want[2]):
        if not meta:
            torch.testing.assert_close(ga, gb, rtol=1e-6, atol=1e-6)
        elif ga is not None:
            assert ga.shape == gb.shape


# ---- faults ------------------------------------------------------------------
def test_dropped_encoder_partial_reads_above_the_limit(model, monkeypatch):
    """The last model rank's partial left out of the first encoder
    all-reduce (wo's sum in layer 0) on every batch slice: the prefill's
    logits and the cross cache leave the whole-tensor step's by far more
    than TWIN_TOL."""
    _, _, cfg, params = model
    want_logits, toks, want_cache = _whole(cfg, params)
    mesh = _mesh((2, 2))
    psum = partition.Rank.psum
    seen, lock = set(), threading.Lock()

    def dropping(self, x, axes):
        if tuple(x.shape[1:]) == (FRAMES, cfg.d_model) and "model" in axes:
            with lock:
                first = self.rank not in seen
                seen.add(self.rank)
            if first and self.index("model") == self.size("model") - 1:
                x = torch.zeros_like(x)
        return psum(self, x, axes)
    monkeypatch.setattr(partition.Rank, "psum", dropping)
    logits, _, cache, _ = _partitioned(cfg, params, mesh, tokens=toks, steps_=0)
    assert len(seen) == mesh.n_ranks
    assert _rel(logits[0], want_logits[0]) > 100 * TWIN_TOL
    assert _rel(cache["cross_k"], want_cache["cross_k"]) > 100 * TWIN_TOL


def test_dropped_cross_slice_reads_above_the_limit(model, monkeypatch):
    """The last model rank's slice of the cross cache left out of the serve
    step's merge (its keys masked in its partial) for two steps: each
    step's logits leave the whole-tensor step's by far more than TWIN_TOL,
    and the prefill's, which reads no cross cache, do not."""
    _, _, cfg, params = model
    want_logits, toks, _ = _whole(cfg, params)
    decode = tp.distributed_decode_local
    crosses = []

    def dropping(q, k, v, lens, *, mesh, seq_axes, **kw):
        if any(k[0].untyped_storage().data_ptr() == c.untyped_storage().data_ptr()
               for c in crosses):
            lens = lens[:-1] + [torch.zeros_like(lens[-1])]
        return decode(q, k, v, lens, mesh=mesh, seq_axes=seq_axes, **kw)
    monkeypatch.setattr(tp, "distributed_decode_local", dropping)
    real_init = mdl.init_cache

    def init(*a, **k):
        cache = real_init(*a, **k)
        crosses.append(cache["cross_k"])
        return cache
    monkeypatch.setattr(mdl, "init_cache", init)
    logits, _, _, _ = _partitioned(cfg, params, _mesh((1, 4)), tokens=toks, steps_=2)
    assert crosses
    assert _rel(logits[0], want_logits[0]) <= TOL
    for i in (1, 2):
        assert _rel(logits[i], want_logits[i]) > 100 * TWIN_TOL, i


def test_detached_encoder_output_reads_above_the_limit(model, monkeypatch):
    """The encoder's output detached inside every decoder layer: no
    gradient reaches the encoder, so each of its leaves leaves the
    whole-tensor step's gradient far above the limit, and each decoder
    leaf stays within it."""
    _, _, cfg, params = model
    _, _, whole_grads = _whole_train(model)
    layer = tp._dec_layer
    monkeypatch.setattr(tp, "_dec_layer", lambda rk, cfg, pl, p, ps, x, enc, *a, **k:
                        layer(rk, cfg, pl, p, ps, x, enc.detach(), *a, **k))
    _, got, paths = _grads(cfg, params, _mesh((2, 2)))
    for path, g, w in zip(paths, mdl.param_leaves(got), mdl.param_leaves(whole_grads)):
        if path[0] in ("encoder", "enc_norm"):
            assert _rel(g, w) > 0.5, path
        else:
            assert _rel(g, w) <= TOL, path


# ---- collective bytes ----------------------------------------------------------
def _closed_form(cfg, mesh_shape):
    """Collective bytes per device (f32), prefill and one serve step, by
    kind: the 4 heads over "model" in the encoder, the decoder's BOS row
    and the cross attention."""
    D, M = mesh_shape
    d, H, KV, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 4
    b, ne, nd = B // D, cfg.encoder_layers, cfg.num_layers
    pre = dict.fromkeys(KINDS, 0)
    dec = dict.fromkeys(KINDS, 0)
    if M > 1:
        # per encoder layer: wo's and w_down's sums all-reduced over the
        # whole frames; per decoder layer: the self, cross and MLP sums of
        # the BOS row, the BOS row's K/V gathered over their heads (the
        # first slice of the self cache holds it), the cross K/V
        # all-to-all'd from their heads into the cross cache's slices; once
        # the embedding's all-reduce
        pre["all-reduce"] = ne * 2 * b * FRAMES * d + nd * 3 * b * d + b * d
        pre["all-gather"] = nd * 2 * b * KV * hd
        pre["all-to-all"] = nd * 2 * b * KV * FRAMES * hd // M
        # the serve step, per layer: q, k, v and the cross q gathered whole;
        # the self and cross decodes' pmax and two psums (f32 partials);
        # wo's, the cross wo's and w_down's all-reduce; once the embedding's
        dec["all-gather"] = nd * b * (2 * H + 2 * KV) * hd
        dec["all-reduce"] = nd * (2 * (2 * b * H + b * H * hd) + 3 * b * d) + b * d
    for c in (pre, dec):
        for k in c:
            c[k] *= f
        c["total"] = sum(c.values())
    return pre, dec


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=_ids)
def test_collective_bytes_closed_form(shape, model):
    _, _, cfg, params = model
    _, _, _, counts = _partitioned(cfg, params, _mesh(shape))
    pre, dec = _closed_form(cfg, shape)
    assert counts[0] == pre
    assert all(c == dec for c in counts[1:])


@pytest.mark.parametrize("shape,kind", [((2, 2), "prefill"), ((1, 8), "prefill"),
                                        ((1, 4), "decode"), ((2, 2), "train")], ids=_ids)
def test_meta_rank_count_equals_cpu_ranks(shape, kind, model):
    """The dry run's count (rank 0 alone on meta ranks, 4 encoder and 4
    decoder layers from 2 and 3 of each) equals the count of every CPU
    rank running the step; the train step's decoder takes the dry run's
    AUDIO_DECODER_TRAIN_LEN tokens."""
    _, _, cfg, _ = model
    cfg = dataclasses.replace(cfg, num_layers=4, encoder_layers=4)
    params = mdl.init_params(cfg, device="cpu")
    mesh = _mesh(shape)
    pre, dec = _shapes()
    if kind == "train":
        _, _, want = _partitioned_train(cfg, params, mesh, dec=steps.AUDIO_DECODER_TRAIN_LEN)
        got = dryrun.collective_bytes(cfg, _train_shape(), mesh)
    else:
        _, _, _, counts = _partitioned(cfg, params, mesh, steps_=1)
        want = counts[0] if kind == "prefill" else counts[1]
        got = dryrun.collective_bytes(cfg, pre if kind == "prefill" else dec, mesh,
                                      max_len=CACHE if kind == "prefill" else None)
    assert got == want and want["total"] > 0


# ---- the launcher --------------------------------------------------------------
def test_launcher_shards_on_a_host_mesh(model, monkeypatch):
    """`launch/train.train` on four CPU ranks runs the partitioned step
    every step and equals its run on whole tensors."""
    _, _, cfg, params = model
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
