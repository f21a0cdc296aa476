"""The partitioned steps of the moe family (`models/tp._moe`, experts over
"model") on meshes of CPU ranks, reduced f32 configs, the reference's
weights bridged: the prefill and serve steps (`launch/partition.prefill`,
`serve`) and the FSDP train step (`partition.train`).

* Configs, from ``reduced_config(get_config(...))`` at the default capacity
  factor 1.25, so that prefill assignments are dropped: olmoe-like with 8
  experts top-2 (the experts divide 4 model ranks), olmoe-like with the
  default 4 experts on (1, 8) (they stay whole: every model rank runs every
  expert and no sum is taken), and llama4-like with its shared expert,
  top-1 routing and 10 q / 2 KV heads (the rules' sequence fallback on 4
  model ranks).  Meshes ["cpu"] x 4 shaped (1, 4), (2, 2), (4, 1) and
  ["cpu"] x 8 shaped (1, 8).
* A prefill and 4 greedy serve steps from `Sharded` arguments against the
  reference's `build_prefill_step` / `build_serve_step` without a mesh
  (logits 1e-4, caches 1e-5, the same greedy tokens) and the port's
  whole-tensor steps (1e-5), B1 once per layer and rank.
* The block alone (`tp._moe`) from one input on every mesh, with routing
  groups the batch axes cut (each rank routes its own rows) and groups they
  do not (the rank gathers every row): `moe.route`'s expert, slot and keep
  exactly, its output and load-balance loss within 1e-5 of `moe_block`'s.
* Two train steps against the reference's jitted ``build_train_step``
  without a mesh (loss and grad norm 1e-5 relative, params 1e-5 but for
  AdamW's ±lr flips) and every gradient of `partition.loss_and_grads`, the
  router's included, against `steps.loss_and_grads` (1e-5 in relative
  norm); a sequence of 1024 gives two routing groups, so on (2, 2) the
  load-balance means are psummed over "data".
* Faults: the last expert rank's partial dropped from the expert sum, and a
  gradient reduce-scatter on (4, 1) that drops the last rank's partial,
  read far above the limits.
* Collective bytes: a closed form per layer on (2, 2) and (1, 4), and the
  dry run's count on meta ranks equal to the CPU ranks' for a prefill, a
  serve step and a train step; `launch/train.train` on a (2, 2) host mesh.

The partitioned moe steps on the card against the CPU ranks' are in
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
from repro_torch.models import moe, tp
from repro_torch.sp.common import KINDS, GangMesh, as_axes
from repro_torch.training import optimizer as opt

torch.set_num_threads(1)

TWIN_TOL = 1e-4      # logits against the reference
CACHE_TOL = 1e-5     # caches against the reference
TOL = 1e-5           # against the port's whole-tensor step; train against both
#: a top-1 router's gradient against the whole-tensor step's: its renormalised
#: gate p / p is 1, whose derivative is an f32 cancellation, so the gradient
#: is 0.01 x the load-balance loss's plus that residue, and the whole-tensor
#: step's own reads 5e-6 to 7e-6 (relative norm) from the same step run in
#: f64 outside the routing (the llama4-like config, CPU)
TOP1_ROUTER_TOL = 3e-5
LR = 3e-4
STEPS = 4
B, PROMPT = 4, 32
#: name -> (arch, reduced_config keywords, cache length)
CONFIGS = {
    "moe8": ("olmoe_1b_7b", dict(layers=2, experts=8), 40),
    "moe4": ("olmoe_1b_7b", dict(layers=2), 40),
    "llama4": ("llama4_maverick_400b_a17b", dict(layers=2, d_model=320, n_heads=10, n_kv=2),
               40),
}
CASES = ([("moe8", m) for m in ((1, 4), (2, 2), (4, 1))]
         + [("moe4", (1, 8)), ("llama4", (1, 4)), ("llama4", (2, 2))])


def _configs(name):
    arch, kw, _ = CONFIGS[name]
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch), **kw), dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch), **kw), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.family == "moe" and cfg.capacity_factor == 1.25
    return jcfg, cfg


def _mesh(shape, cls=GangMesh):
    return cls(["cpu"] * (shape[0] * shape[1]), shape, ("data", "model"))


def _ids(case):
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


def _tokens(cfg, batch=B, prompt=PROMPT):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (batch, prompt)).astype(np.int32)


def _shapes(name, batch=B, prompt=PROMPT):
    return (ShapeConfig(f"prefill_{batch}x{prompt}", prompt, batch, "prefill"),
            ShapeConfig(f"decode_{batch}", CONFIGS[name][2], batch, "decode"))


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


# ---- prefill and serve -------------------------------------------------------
_REFERENCE = {}


def _reference(models, name):
    """The reference's prefill and STEPS greedy serve steps, no mesh:
    (logits per step, tokens, the cache after the last step)."""
    if name not in _REFERENCE:
        jcfg, tree, _, _ = models[name]
        jparams = jax.tree.map(jnp.asarray, tree)
        pre, dec = _shapes(name)
        cache = jmdl.init_cache(jcfg, B, CONFIGS[name][2])
        lg, cache = jst.build_prefill_step(jcfg, pre)(
            jparams, {"tokens": jnp.asarray(_tokens(jcfg))}, cache)
        serve = jax.jit(jst.build_serve_step(jcfg, dec))
        logits, toks = [np.asarray(lg)], []
        for _ in range(STEPS):
            toks.append(np.asarray(lg.argmax(-1), np.int32))
            lg, cache = serve(jparams, cache, jnp.asarray(toks[-1]))
            logits.append(np.asarray(lg))
        _REFERENCE[name] = (logits, toks, {k: np.asarray(cache[k]) for k in ("k", "v", "len")})
    return _REFERENCE[name]


def _whole(cfg, params, name, tokens=None):
    """The port's whole-tensor steps, fed `tokens` (default: greedy)."""
    pre, dec = _shapes(name)
    cache = mdl.init_cache(cfg, B, CONFIGS[name][2], device="cpu")
    lg, cache = steps.build_prefill_step(cfg, pre)(
        params, {"tokens": torch.from_numpy(_tokens(cfg))}, cache)
    serve = steps.build_serve_step(cfg, dec)
    logits, toks = [lg], []
    for i in range(STEPS):
        toks.append(lg.argmax(-1) if tokens is None else tokens[i])
        lg, cache = serve(params, cache, toks[-1])
        logits.append(lg)
    return logits, toks, cache


def _partitioned(cfg, params, name, mesh, tokens=None):
    """The partitioned steps over `mesh` from shards of the same weights:
    (logits per step, tokens, the cache unsharded, the collective bytes of
    the prefill and of each serve step)."""
    pre, dec = _shapes(name)
    p = partition.shard_tree(
        params, shd.param_specs(cfg, params, mesh, fsdp=shd.needs_fsdp(cfg, mesh, "prefill")),
        mesh)
    b = partition.shard_tree({"tokens": torch.from_numpy(_tokens(cfg))},
                             shd.batch_specs(cfg, pre, mesh), mesh)
    cache = mdl.init_cache(cfg, B, CONFIGS[name][2], device="cpu")
    c = partition.shard_tree(cache, shd.cache_specs(cfg, cache, mesh, global_batch=B), mesh)
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


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_partitioned_matches_reference(case, models):
    name, shape = case
    _, _, cfg, params = models[name]
    want_logits, want_toks, want_cache = _reference(models, name)
    logits, toks, cache, _ = _partitioned(cfg, params, name, _mesh(shape))
    assert [t.tolist() for t in toks] == [t.tolist() for t in want_toks]
    _close(logits, want_logits, TWIN_TOL, "step")
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), want_cache[k], atol=CACHE_TOL,
                                   rtol=CACHE_TOL, err_msg=k)
    np.testing.assert_array_equal(cache["len"].numpy(), want_cache["len"])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_partitioned_matches_whole_tensor_step(case, models, monkeypatch):
    """... fed the same tokens; B1 once per layer and rank in the prefill,
    no B2 where the cache's sequence is sharded."""
    name, shape = case
    _, _, cfg, params = models[name]
    mesh = _mesh(shape)
    want_logits, toks, want_cache = _whole(cfg, params, name)
    attn = _Calls(monkeypatch, ops, "attention")
    dec = _Calls(monkeypatch, ops, "decode_attention")
    logits, _, cache, _ = _partitioned(cfg, params, name, mesh, tokens=toks)
    assert attn.n == cfg.num_layers * mesh.n_ranks
    assert dec.n == 0
    _close(logits, want_logits, TOL, "step")
    for k in ("k", "v", "len"):
        torch.testing.assert_close(cache[k], want_cache[k], atol=TOL, rtol=TOL)


# ---- the block alone ---------------------------------------------------------
@pytest.mark.parametrize("name,shape,seq", [
    ("moe8", (1, 4), 1024), ("moe8", (2, 2), 1024), ("moe8", (4, 1), 1024),
    ("moe8", (2, 2), 32), ("moe4", (1, 8), 1024), ("llama4", (2, 2), 1024)],
    ids=lambda v: v if isinstance(v, str) else (f"{v[0]}x{v[1]}" if isinstance(v, tuple)
                                                else f"S{v}"))
def test_moe_block_routes_as_the_whole_block(name, shape, seq, models, monkeypatch):
    """`tp._moe` on every rank from one input h (B, seq, d), assignments
    dropped at the capacity factor 1.25: each rank's
    routing (its own groups where the batch axes cut them, else every
    group) has `moe.route`'s expert, slot and keep exactly, and the joined
    output and the load-balance loss equal `moe_block`'s within TOL."""
    _, _, cfg, params = models[name]
    mesh = _mesh(shape)
    rng = np.random.default_rng(7)
    # a direction shared by every token skews the routing, so that experts
    # overflow their capacity
    h = rng.standard_normal((B, seq, cfg.d_model)) + 0.5 * rng.standard_normal(cfg.d_model)
    h = torch.from_numpy(h.astype(np.float32))
    p0 = params["layers"][0]["moe"]
    want_y, want_aux = moe.moe_block(cfg, p0, h)
    whole = moe.route(cfg, p0["router"], h)
    assert (~whole.keep).any(), "no assignment dropped at capacity factor 1.25"
    pl = tp.plan(cfg, mesh, batch=B, seq=seq, long_context=False)
    specs = shd.param_specs(cfg, params, mesh, fsdp=False)
    p = partition.shard_tree(params, specs, mesh)
    routes, ranks, route_logits = {}, {}, moe.route_logits

    def recording(*a, **k):
        out = route_logits(*a, **k)
        routes[threading.get_ident()] = out
        return out
    monkeypatch.setattr(moe, "route_logits", recording)

    def body(rk):
        ranks[threading.get_ident()] = rk.rank
        return tp._moe(rk, cfg, pl, p.local[rk.rank]["layers"][0]["moe"],
                       specs["layers"][0]["moe"], rk.local(h, 0, pl.batch), pl.seq,
                       balance=True)
    outs = partition.run_lockstep(mesh, body)
    G = whole.expert.shape[0]
    for ident, r in routes.items():
        i, n = mesh.axis_index(ranks[ident], pl.batch), mesh.axis_size(pl.batch)
        own = pl.moe_batch == pl.batch
        sl = slice(i * G // n, (i + 1) * G // n) if own else slice(None)
        assert r.capacity == whole.capacity
        for f in ("expert", "slot", "keep"):
            assert torch.equal(getattr(r, f), getattr(whole, f)[sl]), (ranks[ident], f)
        torch.testing.assert_close(r.gate, whole.gate[sl], atol=TOL, rtol=TOL)
    assert len(routes) == mesh.n_ranks
    y = partition._join(shd.P(pl.batch, pl.seq), [o[0] for o in outs], mesh)
    torch.testing.assert_close(y, want_y, atol=TOL, rtol=TOL)
    for _, lb in outs:
        torch.testing.assert_close(lb, want_aux["lb_loss"], atol=TOL, rtol=TOL)


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


def _reference_train(models, name, seq):
    """The reference's jitted train step without a mesh, two steps:
    ([(loss, grad_norm)], the params after them, numpy)."""
    key = ("reference", name, seq)
    if key not in _TRAIN:
        jcfg, tree, _, _ = models[name]
        p = jax.tree.map(jnp.asarray, tree)
        s = jopt.adamw_init(p)
        step = jax.jit(jst.build_train_step(jcfg, remat=True))
        infos = []
        for b in _batches(jcfg, seq):
            p, s, info = step(p, s, {k: jnp.asarray(v) for k, v in b.items()})
            infos.append((float(info["loss"]), float(info["grad_norm"])))
        _TRAIN[key] = (infos, jax.tree.map(np.asarray, p))
    return _TRAIN[key]


def _whole_train(models, name, seq):
    """The port's whole-tensor step, two steps: ([(loss, grad_norm)], the
    params after them, the gradients of the first batch)."""
    key = ("whole", name, seq)
    if key not in _TRAIN:
        _, _, cfg, params = models[name]
        p = _clone(params)
        s = opt.adamw_init(p)
        bs = _batches(cfg, seq)
        _, grads = steps.loss_and_grads(cfg, p, _torch(bs[0]))
        step = steps.build_train_step(cfg)
        infos = []
        for b in bs:
            p, s, info = step(p, s, _torch(b))
            infos.append((float(info["loss"]), float(info["grad_norm"])))
        _TRAIN[key] = (infos, p, grads)
    return _TRAIN[key]


def _shard(cfg, params, mesh, seq):
    """(params, optimizer state) cut by the fsdp specs over `mesh` (views
    of a copy of `params`), and a function cutting a numpy batch."""
    params = _clone(params)
    state = opt.adamw_init(params)
    pspecs = shd.param_specs(cfg, params, mesh, fsdp=True)
    bspecs = shd.batch_specs(cfg, _train_shape(seq), mesh)
    return (partition.shard_tree(params, pspecs, mesh),
            partition.shard_tree(state, shd.opt_specs(pspecs, state), mesh),
            lambda b: partition.shard_tree(_torch(b), bspecs, mesh))


def _partitioned_train(cfg, params, mesh, seq):
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


TRAIN_CASES = ([("moe8", m, 32) for m in ((1, 4), (2, 2), (4, 1))]
               + [("moe8", (2, 2), 1024), ("moe4", (1, 8), 32), ("llama4", (1, 4), 32)])


@pytest.mark.parametrize("name,shape,seq", TRAIN_CASES,
                         ids=lambda v: v if isinstance(v, str) else (
                             f"{v[0]}x{v[1]}" if isinstance(v, tuple) else f"S{v}"))
def test_partitioned_train_matches_reference(name, shape, seq, models):
    _, _, cfg, params = models[name]
    mesh = _mesh(shape)
    ref_infos, ref_params = _reference_train(models, name, seq)
    whole_infos, whole_params, whole_grads = _whole_train(models, name, seq)
    p, _, cut = _shard(cfg, params, mesh, seq)
    loss, grads = partition.loss_and_grads(cfg, p, cut(_batches(cfg, seq)[0]))
    np.testing.assert_allclose(float(loss), whole_infos[0][0], rtol=TOL)
    got = partition.unshard_tree(grads)
    paths = _paths(got)
    assert any(path[-1] == "router" for path in paths)
    for path, g, w in zip(paths, mdl.param_leaves(got), mdl.param_leaves(whole_grads)):
        top1_router = path[-1] == "router" and cfg.experts_per_token == 1
        assert _rel(g, w) <= (TOP1_ROUTER_TOL if top1_router else TOL), (path, _rel(g, w))
    infos, got_params, _ = _partitioned_train(cfg, params, mesh, seq)
    for what, want in (("reference", ref_infos), ("whole-tensor step", whole_infos)):
        for i, (g, w) in enumerate(zip(infos, want)):
            np.testing.assert_allclose(g, w, rtol=TOL, err_msg=f"{what} step {i}")
    _assert_params_close(params_to_numpy(got_params), ref_params)
    _assert_params_close(params_to_numpy(got_params), params_to_numpy(whole_params))


# ---- faults ------------------------------------------------------------------
def test_dropped_expert_partial_reads_above_the_limit(models, monkeypatch):
    """The last expert rank's partial left out of the expert sum (its
    `expert_partial` zeroed): the prefill's logits leave the whole-tensor
    step's by far more than TWIN_TOL."""
    _, _, cfg, params = models["moe8"]
    want, toks, _ = _whole(cfg, params, "moe8")
    partial = moe.expert_partial
    last = cfg.num_experts - cfg.num_experts // 4

    def dropping(cfg_, p, r, x, *, e0=0, tokens=None, **kw):
        y = partial(cfg_, p, r, x, e0=e0, tokens=tokens, **kw)
        return torch.zeros_like(y) if e0 == last else y
    monkeypatch.setattr(moe, "expert_partial", dropping)
    got, _, _, _ = _partitioned(cfg, params, "moe8", _mesh((1, 4)), tokens=toks)
    rel = float((got[0] - want[0]).norm() / want[0].norm())
    assert rel > 100 * TWIN_TOL, rel


def test_dropped_gradient_partial_reads_above_the_limit(models):
    """On (4, 1) the forward reduce-scatters nothing (the experts whole,
    one routing group gathered over "data") and the backward's
    reduce-scatters are the duals of the FSDP gathers and of the routing
    input's: one that drops the last rank's partial leaves the loss within
    TOL and moves every FSDP-cut leaf's gradient, the experts' among them,
    far above the limit."""
    _, _, cfg, params = models["moe8"]

    class Dropping(GangMesh):
        def psum_scatter(self, xs, axes, *, scatter_dimension):
            return super().psum_scatter(xs[:-1] + [torch.zeros_like(xs[-1])], axes,
                                        scatter_dimension=scatter_dimension)
    mesh = _mesh((4, 1), Dropping)
    p, _, cut = _shard(cfg, params, mesh, PROMPT)
    loss, grads = partition.loss_and_grads(cfg, p, cut(_batches(cfg, PROMPT)[0]))
    whole_infos, _, whole_grads = _whole_train(models, "moe8", PROMPT)
    np.testing.assert_allclose(float(loss), whole_infos[0][0], rtol=TOL)
    specs = []
    shd.walk(lambda path, spec, n: specs.append((path, spec)), p.specs)
    cut_experts = 0
    for (path, spec), g, w in zip(specs, mdl.param_leaves(partition.unshard_tree(grads)),
                                  mdl.param_leaves(whole_grads)):
        if any("data" in as_axes(e) for e in spec):
            assert _rel(g, w) > 1e-2, (path, _rel(g, w))
            cut_experts += path[-1] in ("w_gate", "w_up", "w_down") and "moe" in path
    assert cut_experts == 3 * cfg.num_layers


# ---- collective bytes ----------------------------------------------------------
def _closed_form(cfg, mesh_shape, layers):
    """The olmoe-like config's collective bytes per device (f32), prefill
    and one serve step, by kind: MHA heads that divide "model", 8 experts
    over it, one routing group (B x PROMPT < 2048 tokens)."""
    D, M = mesh_shape
    d, H, KV, hd, E = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_experts
    b, s, s_max, f = B // D, PROMPT, CONFIGS["moe8"][2], 4
    pre = dict.fromkeys(KINDS, 0)
    dec = dict.fromkeys(KINDS, 0)
    if M > 1:
        # per layer: the residual gathered before both norms; with the one
        # group cut over no batch axis, the routing input gathered over
        # "data"; the router's logit columns gathered; wo and the expert
        # sum reduce-scattered; the cache's K and V all-to-all'd from heads
        pre["all-gather"] = layers * (2 * b * s * d + (B * s * d if D > 1 else 0) + B * s * E)
        pre["reduce-scatter"] = layers * 2 * b * (s // M) * d
        pre["all-to-all"] = layers * 2 * b * KV * (s_max // M) * hd
        # once: the embedding's reduce-scatter, the last rows' gather
        pre["reduce-scatter"] += b * (s // M) * d
        pre["all-gather"] += b * M * d
        # per layer: q, k, v gathered whole, the routing input over "data"
        # and the logits; the decode's pmax, two psums (f32 partials); wo's
        # and the expert sum's all-reduce; once the embedding's
        dec["all-gather"] = layers * (b * (H + 2 * KV) * hd + (B * d if D > 1 else 0) + B * E)
        dec["all-reduce"] = layers * (2 * b * H + b * H * hd + 2 * b * d) + b * d
    for c in (pre, dec):
        for k in c:
            c[k] *= f
        c["total"] = sum(c.values())
    return pre, dec


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_collective_bytes_closed_form(shape, models):
    _, _, cfg, params = models["moe8"]
    _, _, _, counts = _partitioned(cfg, params, "moe8", _mesh(shape))
    pre, dec = _closed_form(cfg, shape, cfg.num_layers)
    assert counts[0] == pre
    assert all(c == dec for c in counts[1:])


@pytest.mark.parametrize("name,shape,kind", [
    ("moe8", (2, 2), "prefill"), ("moe8", (1, 4), "decode"), ("llama4", (1, 4), "prefill"),
    ("moe4", (1, 8), "decode"), ("moe8", (2, 2), "train"), ("llama4", (4, 1), "train")])
def test_meta_rank_count_equals_cpu_ranks(name, shape, kind, models):
    """The dry run's count (rank 0 alone on meta ranks, the one-hot
    dispatch restricted to its experts, 4 layers from 2 and 3) equals the
    count of every CPU rank running the step."""
    _, _, cfg, _ = models[name]
    cfg = dataclasses.replace(cfg, num_layers=4)
    params = mdl.init_params(cfg, device="cpu")
    mesh = _mesh(shape)
    pre, dec = _shapes(name)
    if kind == "train":
        _, _, want = _partitioned_train(cfg, params, mesh, PROMPT)
        got = dryrun.collective_bytes(cfg, _train_shape(PROMPT), mesh)
    else:
        _, _, _, counts = _partitioned(cfg, params, name, mesh)
        want = counts[0] if kind == "prefill" else counts[1]
        got = dryrun.collective_bytes(cfg, pre if kind == "prefill" else dec, mesh,
                                      max_len=CONFIGS[name][2] if kind == "prefill" else None)
    assert got == want and want["total"] > 0


# ---- the launcher --------------------------------------------------------------
def test_launcher_shards_on_a_host_mesh(models, monkeypatch):
    """`launch/train.train` of the moe family on four CPU ranks runs the
    partitioned step every step and equals its run on whole tensors."""
    _, _, cfg, params = models["moe8"]
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
