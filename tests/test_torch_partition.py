"""The partitioned prefill and serve steps (`launch/partition.py`,
`models/tp.py`) of the dense and vlm families on meshes of CPU ranks,
reduced f32 configs, the reference's weights bridged.

* Meshes ["cpu"] x 4 shaped (1, 4), (2, 2), (4, 1) and ["cpu"] x 8 shaped
  (2, 4), (1, 8); configs: a llama-like dense model (8 q / 2 KV heads), a
  qwen2-like one with QKV bias and 6 heads (the rules' sequence fallback
  wherever 6 does not divide "model"), a vlm, a sliding-window model
  whose serve step decodes into a ring, and a phi3-like one (phi3_14b's
  40 q / 10 KV heads) on (1, 4) and (1, 8), where the 10 KV heads stay
  whole and a rank's query heads read K/V heads they do not pair evenly
  with (B1 gets them repeated per query head).
* A prefill and 4 greedy serve steps from `Sharded` arguments against the
  reference's `build_prefill_step` / `build_serve_step` without a mesh
  (logits 1e-4, caches 1e-5, the same greedy tokens) and against the
  port's whole-tensor steps (1e-5), B1 called once per layer and rank; one
  sequence (long context: the sequence over both axes), FSDP-sharded
  weights, the ring buffer.
* `GangMesh.psum_scatter` against ``jax.lax.psum_scatter`` (exact), in ONE
  subprocess with eight forced XLA devices (this file run as a script),
  which also compiles the reference's partitioned prefill on (2, 2) and
  (1, 4) of four of them for its own collective bytes.
* The collective bytes the mesh counts: a closed form per layer on (2, 2)
  and (1, 4), and the dry run's count on meta ranks equal to the CPU
  ranks' for the same combo; the dry run's records of every family carry
  them (train too: tests/test_torch_partition_train.py; the moe steps:
  tests/test_torch_partition_moe.py; ssm and hybrid:
  tests/test_torch_partition_ssm.py; audio:
  tests/test_torch_partition_audio.py).

The partitioned steps on the card against the CPU ranks' are in
tests/test_torch_cuda.py, which imports no JAX.

    PYTHONPATH=src python tests/test_torch_partition.py --bytes

prints the reference's collective bytes beside the port's for the reduced
dense prefill and serve step and the reduced moe (8 experts), ssm (16
heads), hybrid (two segments) and audio (32 frames and a BOS token)
prefills on (2, 2) and (1, 4), and for the dense steps the reference's
``memory_analysis().temp_size_in_bytes`` and ``cost_analysis()["flops"]``
(as parsed, and scaled by the layer loop's trip count as the reference's
roofline scales it) beside the dry run's per-device temp and FLOPs
(`dryrun.rank_account`).
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch import steps as jst
from repro.models import model as jmdl
from repro_torch.bridge import params_from_jax
from repro_torch.configs import INPUT_SHAPES, get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as shd
from repro_torch.launch import steps
from repro_torch.launch.partition import run_lockstep, shard_tree, unshard_tree
from repro_torch.models import model as mdl
from repro_torch.models import tp
from repro_torch.sp.common import KINDS, GangMesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TWIN_TOL = 1e-4      # logits against the reference
CACHE_TOL = 1e-5     # caches against the reference
#: the ring's caches against the reference: the port's own whole-tensor
#: ring prefill of 96 tokens sits 2.3e-5 from it (f32 summation order over
#: the longer prompt), so the ring keeps tests/test_torch_ring.py's 1e-4
#: there and is held to the whole-tensor step at TOL
RING_CACHE_TOL = 1e-4
TOL = 1e-5           # against the port's whole-tensor step
STEPS = 4
B, PROMPT = 4, 32
#: name -> (arch, reduced_config keywords, cache length)
CONFIGS = {
    "dense": ("llama31_70b", dict(layers=2, n_heads=8, n_kv=2), 40),
    "qwen2": ("qwen2_7b", dict(layers=2, d_model=192, n_heads=6, n_kv=2), 40),
    "vlm": ("internvl2_76b", dict(layers=2), 56),
    "swa": ("llama3_8b", dict(layers=2), 64),
    "phi3": ("phi3_14b", dict(layers=2, d_model=320, n_heads=40, n_kv=10), 40),
    # tests/test_torch_partition_moe.py's olmoe-like config (8 experts) and
    # tests/test_torch_partition_ssm.py's ssm (16 heads) and hybrid (4
    # layers, two segments) configs, whose prefill `--bytes` compiles in the
    # reference
    "moe": ("olmoe_1b_7b", dict(layers=2, experts=8), 40),
    "ssm": ("mamba2_130m", dict(layers=2), 40),
    "hybrid": ("zamba2_2_7b", dict(layers=4), 40),
    # tests/test_torch_partition_audio.py's seamless-like config (2 + 2
    # layers): PROMPT frames and a BOS token into a self cache of 40
    "audio": ("seamless_m4t_large_v2", dict(layers=2), 40),
}
#: the configs whose prefill alone `--bytes` compiles
BYTES_PREFILL = ("moe", "ssm", "hybrid", "audio")
MESHES = [(1, 4), (2, 2), (4, 1), (2, 4), (1, 8)]


def _configs(name):
    arch, kw, _ = CONFIGS[name]
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch), **kw), dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch), **kw), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _mesh(shape):
    return GangMesh(["cpu"] * (shape[0] * shape[1]), shape, ("data", "model"))


def _inputs(cfg, batch, prompt):
    """The prompt batch (numpy) from a seed: tokens, and for the vlm its
    patch embeddings first."""
    rng = np.random.default_rng(3)
    n_prefix = cfg.frontend_tokens if cfg.family == "vlm" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt - n_prefix)).astype(np.int32)}
    if n_prefix:
        out["embeds"] = rng.standard_normal((batch, n_prefix, cfg.d_model)).astype(np.float32)
    return out


def _shapes(batch, prompt, name):
    """(prefill shape, serve shape): the sliding-window model with one
    sequence serves at long_500k, its ring."""
    pre = ShapeConfig(f"prefill_{batch}x{prompt}", prompt, batch, "prefill")
    if name == "swa" and batch == 1:
        return pre, INPUT_SHAPES["long_500k"]
    return pre, ShapeConfig(f"decode_{batch}", CONFIGS[name][2], batch, "decode")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jcfg, cfg = _configs(name)
        jparams = jmdl.init_params(jax.random.PRNGKey(0), jcfg)
        out[name] = (jcfg, jparams, cfg,
                     params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    return out


_REFERENCE = {}


def _reference(models, name, batch=B, prompt=PROMPT):
    """The reference's prefill and STEPS greedy serve steps, no mesh:
    (logits per step, tokens, the cache after the last step)."""
    key = (name, batch, prompt)
    if key not in _REFERENCE:
        jcfg, jparams, _, _ = models[name]
        pre, dec = _shapes(batch, prompt, name)
        inp = _inputs(jcfg, batch, prompt)
        cache = jmdl.init_cache(jcfg, batch, CONFIGS[name][2])
        lg, cache = jst.build_prefill_step(jcfg, pre)(
            jparams, {k: jnp.asarray(v) for k, v in inp.items()}, cache)
        serve = jax.jit(jst.build_serve_step(jcfg, dec))
        logits, toks = [np.asarray(lg)], []
        for _ in range(STEPS):
            toks.append(np.asarray(lg.argmax(-1), np.int32))
            lg, cache = serve(jparams, cache, jnp.asarray(toks[-1]))
            logits.append(np.asarray(lg))
        _REFERENCE[key] = (logits, toks, {k: np.asarray(cache[k]) for k in ("k", "v", "len")})
    return _REFERENCE[key]


def _whole(cfg, params, name, batch=B, prompt=PROMPT, tokens=None):
    """The port's whole-tensor steps, fed `tokens` (default: greedy)."""
    pre, dec = _shapes(batch, prompt, name)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg, batch, prompt).items()}
    cache = mdl.init_cache(cfg, batch, CONFIGS[name][2], device="cpu")
    lg, cache = steps.build_prefill_step(cfg, pre)(params, inp, cache)
    serve = steps.build_serve_step(cfg, dec)
    logits, toks = [lg], []
    for i in range(STEPS):
        toks.append(lg.argmax(-1) if tokens is None else tokens[i])
        lg, cache = serve(params, cache, toks[-1])
        logits.append(lg)
    return logits, toks, cache


def _partitioned(cfg, params, name, mesh, batch=B, prompt=PROMPT, tokens=None, fsdp=None):
    """The partitioned steps over `mesh` from shards of the same weights
    (`tokens`: fed, default greedy): (logits per step, tokens, the cache
    unsharded, the mesh's collective bytes of the prefill and of the first
    serve step)."""
    pre, dec = _shapes(batch, prompt, name)
    fsdp = shd.needs_fsdp(cfg, mesh, "prefill") if fsdp is None else fsdp
    p = shard_tree(params, shd.param_specs(cfg, params, mesh, fsdp=fsdp), mesh)
    inp = {k: torch.from_numpy(v) for k, v in _inputs(cfg, batch, prompt).items()}
    b = shard_tree(inp, shd.batch_specs(cfg, pre, mesh), mesh)
    cache = mdl.init_cache(cfg, batch, CONFIGS[name][2], device="cpu")
    c = shard_tree(cache, shd.cache_specs(cfg, cache, mesh, global_batch=batch), mesh)
    tspec = shd.batch_specs(cfg, dec, mesh)["token"]
    mesh.reset_bytes()
    lg, c = steps.build_prefill_step(cfg, pre)(p, b, c)
    counts = [dict(mesh.collective_bytes[0])]
    serve = steps.build_serve_step(cfg, dec)
    logits, toks = [unshard_tree(lg)], []
    for i in range(STEPS):
        toks.append(logits[-1].argmax(-1) if tokens is None else tokens[i])
        mesh.reset_bytes()
        lg, c = serve(p, c, shard_tree(toks[-1], tspec, mesh))
        counts.append(dict(mesh.collective_bytes[0]))
        logits.append(unshard_tree(lg))
    return logits, toks, unshard_tree(c), counts


def _close(got, want, tol, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=tol, rtol=tol,
                                   err_msg=f"{what} {i}")


class _Calls:
    """Counts the calls of a module function it replaces, from any thread."""

    def __init__(self, monkeypatch, module, name):
        self.n, fn, lock = 0, getattr(module, name), threading.Lock()

        def counted(*a, **k):
            with lock:
                self.n += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counted)


CASES = ([(name, shape) for name in ("dense", "qwen2", "vlm") for shape in MESHES]
         + [("phi3", (1, 4)), ("phi3", (1, 8))])


def _ids(case):
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


# ---- against the reference and the whole-tensor step -----------------------
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
    the plain distributed decode in the serve steps (no B2 where the cache's
    sequence is sharded)."""
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


@pytest.mark.parametrize("name", ["dense", "swa"])
def test_one_sequence_long_context(name, models):
    """B == 1 on (2, 2): the sequence and the cache over (data, model); the
    sliding-window model's 96-token prompt into its ring of 64, then ring
    serve steps at long_500k."""
    _, _, cfg, params = models[name]
    prompt = 96 if name == "swa" else PROMPT
    mesh = _mesh((2, 2))
    pre, dec = _shapes(1, prompt, name)
    assert steps.ring_buffer(cfg, dec) == (name == "swa")
    assert shd.cache_specs(cfg, mdl.init_cache(cfg, 1, CONFIGS[name][2], device="meta"),
                           mesh, global_batch=1)["k"][3] == ("data", "model")
    want_logits, want_toks, want_cache = _reference(models, name, 1, prompt)
    logits, toks, cache, _ = _partitioned(cfg, params, name, mesh, 1, prompt)
    assert [t.tolist() for t in toks] == [t.tolist() for t in want_toks]
    _close(logits, want_logits, TWIN_TOL, "step")
    tol = RING_CACHE_TOL if name == "swa" else CACHE_TOL
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), want_cache[k], atol=tol, rtol=tol,
                                   err_msg=k)
    whole, _, whole_cache = _whole(cfg, params, name, 1, prompt, toks)
    _close(logits, [w.numpy() for w in whole], TOL, "whole step")
    for k in ("k", "v", "len"):
        torch.testing.assert_close(cache[k], whole_cache[k], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", ["dense", "vlm"])
def test_fsdp_sharded_weights(name, shape, models, monkeypatch):
    """Serving weights over "data" when a device could not hold them, forced
    by a smaller device (HBM_PER_DEVICE, as tests/test_torch_sharding.py
    does): each gathered before its layer."""
    _, _, cfg, params = models[name]
    mesh = _mesh(shape)
    monkeypatch.setattr(shd, "HBM_PER_DEVICE", 1e3)
    assert shd.needs_fsdp(cfg, mesh, "prefill")
    specs = shd.param_specs(cfg, params, mesh, fsdp=True)
    assert specs["layers"][0]["attn"]["wq"] == ("data", "model")
    want_logits, want_toks, want_cache = _reference(models, name)
    logits, toks, cache, counts = _partitioned(cfg, params, name, mesh)
    assert [t.tolist() for t in toks] == [t.tolist() for t in want_toks]
    _close(logits, want_logits, TWIN_TOL, "step")
    np.testing.assert_allclose(cache["k"].numpy(), want_cache["k"], atol=CACHE_TOL,
                               rtol=CACHE_TOL)
    _, _, _, plain = _partitioned(cfg, params, name, mesh, fsdp=False)
    # the weights' gathers over "data" are what FSDP adds (nothing on a
    # data axis of one rank)
    extra = counts[0]["all-gather"] - plain[0]["all-gather"]
    assert extra > 0 if mesh.shape["data"] > 1 else extra == 0


def test_planted_fault_reads_above_the_limit(models):
    """A reduce-scatter that drops the last rank's partial: the prefill's
    logits leave the whole-tensor step's by far more than TWIN_TOL."""
    _, _, cfg, params = models["dense"]

    class Dropping(GangMesh):
        def psum_scatter(self, xs, axes, *, scatter_dimension):
            return super().psum_scatter(xs[:-1] + [torch.zeros_like(xs[-1])], axes,
                                        scatter_dimension=scatter_dimension)
    want, toks, _ = _whole(cfg, params, "dense")
    got, _, _, _ = _partitioned(cfg, params, "dense",
                                Dropping(["cpu"] * 4, (1, 4), ("data", "model")), tokens=toks)
    rel = (got[0] - want[0]).norm() / want[0].norm()
    assert rel > 100 * TWIN_TOL, rel


def test_planted_serve_fault_reads_above_the_limit(models):
    """An all-reduce that drops the last rank's partial: the prefill (which
    reduce-scatters on (1, 4)) is untouched, every serve step's logits
    leave the whole-tensor step's by far more than TWIN_TOL."""
    _, _, cfg, params = models["dense"]

    class Dropping(GangMesh):
        def psum(self, xs, axes):
            return super().psum(xs[:-1] + [torch.zeros_like(xs[-1])], axes)
    want, toks, _ = _whole(cfg, params, "dense")
    got, _, _, _ = _partitioned(cfg, params, "dense",
                                Dropping(["cpu"] * 4, (1, 4), ("data", "model")), tokens=toks)
    _close(got[:1], want[:1], TWIN_TOL, "prefill")
    rel = [float((g - w).norm() / w.norm()) for g, w in zip(got[1:], want[1:])]
    assert min(rel) > 100 * TWIN_TOL, rel


# ---- the boundary and the lockstep ------------------------------------------
def test_shard_tree_gives_views_and_unshards_back(models):
    _, _, cfg, params = models["dense"]
    mesh = _mesh((2, 2))
    specs = shd.param_specs(cfg, params, mesh, fsdp=True)
    sh = shard_tree(params, specs, mesh)
    assert len(sh.local) == 4
    wq = params["layers"][1]["attn"]["wq"]
    for r in range(4):
        piece = sh.local[r]["layers"][1]["attn"]["wq"]
        assert piece.untyped_storage().data_ptr() == wq.untyped_storage().data_ptr()
        assert piece.shape == shd.shard_shape(wq.shape, specs["layers"][1]["attn"]["wq"], mesh)
    back = unshard_tree(sh)
    for a, b in zip(mdl.param_leaves(back), mdl.param_leaves(params)):
        assert torch.equal(a, b)
    tok = torch.arange(8)
    assert torch.equal(unshard_tree(shard_tree(tok, shd.P("data"), mesh)), tok)


def test_lockstep_raises_on_a_rank_that_raises_or_strays():
    mesh = _mesh((1, 4))

    def stray(rk):
        x = torch.ones(2)
        if rk.rank == 3:
            return rk.psum(x, "model")
        return rk.all_gather(x, "model", axis=0)
    with pytest.raises(RuntimeError, match="different collectives"):
        run_lockstep(mesh, stray)

    def broken(rk):
        if rk.rank == 1:
            raise KeyError("rank 1")
        return rk.psum(torch.ones(2), "model")
    with pytest.raises(KeyError, match="rank 1"):
        run_lockstep(mesh, broken)


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2"])
def test_other_families_are_not_partitioned(arch, models):
    """No family is left without a partitioned step: the last one, audio,
    runs its prefill from `Sharded` arguments on (2, 2) and gives the
    whole-tensor step's logits and caches (the audio steps in full:
    tests/test_torch_partition_audio.py; moe: test_torch_partition_moe.py;
    ssm and hybrid: test_torch_partition_ssm.py)."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
    assert cfg.family in tp.FAMILIES and set(tp.FAMILIES) == set(mdl.FAMILIES)
    mesh = _mesh((2, 2))
    params = mdl.init_params(cfg, device="cpu")
    pre = ShapeConfig("p", 32, 4, "prefill")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1)).astype(np.int32)),
             "frames": torch.from_numpy(rng.standard_normal((4, 32, cfg.d_model))
                                        .astype(np.float32))}

    def cache():
        return mdl.init_cache(cfg, 4, 40, enc_len=32, device="cpu")
    want, want_cache = steps.build_prefill_step(cfg, pre)(params, batch, cache())
    c = cache()
    args = (shard_tree(params, shd.param_specs(cfg, params, mesh, fsdp=False), mesh),
            shard_tree(batch, shd.batch_specs(cfg, pre, mesh), mesh),
            shard_tree(c, shd.cache_specs(cfg, c, mesh, global_batch=4), mesh))
    got, got_cache = steps.build_prefill_step(cfg, pre)(*args)
    torch.testing.assert_close(unshard_tree(got), want, atol=TOL, rtol=TOL)
    got_cache = unshard_tree(got_cache)
    for k in ("k", "v", "cross_k", "cross_v", "cross_len", "len"):
        torch.testing.assert_close(got_cache[k], want_cache[k], atol=TOL, rtol=TOL)


def test_mesh_of_one_rank_equals_the_whole_step(models):
    _, _, cfg, params = models["dense"]
    want, toks, want_cache = _whole(cfg, params, "dense")
    got, _, cache, counts = _partitioned(cfg, params, "dense", _mesh((1, 1)), tokens=toks)
    _close(got, want, TOL, "step")
    torch.testing.assert_close(cache["k"], want_cache["k"], atol=TOL, rtol=TOL)
    assert all(c["total"] == 0 for c in counts)


# ---- collective bytes --------------------------------------------------------
def _closed_form(cfg, mesh_shape, batch, prompt, s_max, layers):
    """The dense config's collective bytes per device (f32), prefill and
    one serve step, by kind: 8 q / 2 KV heads, every dim divisible but the
    KV heads beyond 2 model ranks (then K and V are gathered whole, and the
    cache's slices cut locally instead of by an all-to-all)."""
    D, M = mesh_shape
    d, H, KV, hd, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 4
    b, s = batch // D, prompt
    kv_sharded = KV % M == 0
    pre = dict.fromkeys(KINDS, 0)
    dec = dict.fromkeys(KINDS, 0)
    if M > 1:
        # per layer: the residual gathered before both norms; K and V
        # gathered where their heads do not divide; wo and w_down
        # reduce-scattered; the cache's K and V all-to-all'd from heads
        pre["all-gather"] = layers * (2 * b * s * d + (0 if kv_sharded else 2 * b * s * KV * hd))
        pre["reduce-scatter"] = layers * 2 * b * (s // M) * d
        pre["all-to-all"] = layers * (2 * b * KV * (s_max // M) * hd if kv_sharded else 0)
        # once: the embedding's reduce-scatter, the last rows' gather
        pre["reduce-scatter"] += b * (s // M) * d
        pre["all-gather"] += b * M * d
        # per layer: q, k, v gathered whole; the decode's pmax, two psums
        # (f32 partials); wo's and w_down's all-reduce; once the embedding's
        dec["all-gather"] = layers * b * (H + 2 * KV) * hd
        dec["all-reduce"] = layers * (2 * b * H + b * H * hd + 2 * b * d) + b * d
    for c in (pre, dec):
        for k in c:
            c[k] *= f
        c["total"] = sum(c.values())
    return pre, dec


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_collective_bytes_closed_form(shape, models):
    _, _, cfg, params = models["dense"]
    _, _, _, counts = _partitioned(cfg, params, "dense", _mesh(shape))
    pre, dec = _closed_form(cfg, shape, B, PROMPT, CONFIGS["dense"][2], cfg.num_layers)
    assert counts[0] == pre
    assert all(c == dec for c in counts[1:])


@pytest.mark.parametrize("name,shape,kind", [
    ("dense", (2, 2), "prefill"), ("dense", (1, 4), "decode"), ("qwen2", (1, 4), "prefill"),
    ("qwen2", (2, 4), "decode"), ("vlm", (2, 2), "prefill"), ("vlm", (1, 8), "decode")])
def test_meta_rank_count_equals_cpu_ranks(name, shape, kind, models):
    """The dry run's count (rank 0 alone on meta ranks, 4 layers from 2 and
    3) equals the count of every CPU rank running the step."""
    _, _, cfg, _ = models[name]
    cfg = dataclasses.replace(cfg, num_layers=4)
    params = mdl.init_params(cfg, device="cpu")
    mesh = _mesh(shape)
    _, _, _, counts = _partitioned(cfg, params, name, mesh)
    pre, dec = _shapes(B, PROMPT, name)
    want = counts[0] if kind == "prefill" else counts[1]
    got = dryrun.collective_bytes(cfg, pre if kind == "prefill" else dec, mesh,
                                  max_len=CONFIGS[name][2] if kind == "prefill" else None)
    assert got == want and want["total"] > 0


def test_dry_run_records_carry_collective_bytes():
    for arch, shape in (("llama3_8b", "prefill_32k"), ("qwen2_7b", "prefill_32k"),
                        ("internvl2_76b", "decode_32k"), ("llama3_8b", "long_500k"),
                        ("llama3_8b", "train_4k"), ("olmoe_1b_7b", "train_4k"),
                        ("olmoe_1b_7b", "decode_32k"), ("mamba2_130m", "prefill_32k"),
                        ("zamba2_2_7b", "decode_32k")):
        rec = dryrun.run_combo(arch, shape)
        assert rec["ok"] and set(rec["collectives"]) == set(KINDS) | {"total"}
        assert rec["collectives"]["total"] > 0 and "collectives_reason" not in rec
    # the 28 heads of qwen2 on 16 model ranks take the sequence fallback: an
    # all-to-all moves q's rows (and wo's inputs back)
    assert dryrun.run_combo("qwen2_7b", "prefill_32k")["collectives"]["all-to-all"] > 0
    # mamba2_130m's 24 heads on 16 model ranks take the sequence fallback:
    # the ranks' final states and summed decays are all-gathered
    assert dryrun.run_combo("mamba2_130m", "prefill_32k")["collectives"]["all-gather"] > 0
    # seamless_m4t_large_v2's cross K/V go into the cross cache by an
    # all-to-all from their heads, as the self K/V do
    rec = dryrun.run_combo("seamless_m4t_large_v2", "prefill_32k")
    assert rec["ok"] and rec["collectives"]["total"] > 0 and "collectives_reason" not in rec
    assert rec["collectives"]["all-to-all"] > 0


# ---- against jax.lax, and the reference's own bytes ---------------------------
PSUM_SCATTER = {"data_dim1": ("data", 1), "model_dim1": ("model", 1),
                "model_dim2": ("model", 2), "both_dim1": (("data", "model"), 1)}


#: the configs whose serve step the reference compiles beside its prefill
SERVE_BYTES = ("dense", "audio")


def _trip_scaled_bytes(hlo: str) -> dict:
    """The reference's `collective_bytes_from_hlo` count with every
    computation's collectives scaled by the trip counts XLA records for the
    while loops that reach it (``known_trip_count``): that parser reads a
    loop's count from a constant in its condition and finds the body by a
    header whose parameters hold no tuple, so it counts a scanned layer
    loop's body once where its condition compares two parameters."""
    from repro.launch.dryrun import _COLLECTIVES, _shape_bytes
    colls, calls, comp = {}, [], "ENTRY"
    for line in hlo.splitlines():
        st = line.strip()
        head = re.match(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{$", st)
        if head:
            comp = "ENTRY" if head.group(1) else head.group(2)
            continue
        for kind in _COLLECTIVES:
            if re.search(rf"\b{kind}(-start|-done)?\(", st):
                done = kind == "all-gather" and "-done(" in st   # counted at -start
                colls.setdefault(comp, []).append(
                    (kind, 0 if done else _shape_bytes(st.split(f" {kind}", 1)[0])))
                break
        trip = re.search(r'"known_trip_count":\{"n":"(\d+)"', st)
        body = re.search(r"body=%?([\w.\-]+)", st)
        for callee in re.findall(r"(?:body|condition|calls|to_apply)=%?([\w.\-]+)", st):
            n = int(trip.group(1)) if trip and body and callee == body.group(1) else 1
            calls.append((comp, callee, n))
    mult = {"ENTRY": 1}
    for _ in range(len(calls) + 1):
        for caller, callee, n in calls:
            if caller in mult:
                mult[callee] = max(mult.get(callee, 0), mult[caller] * n)
    out = dict.fromkeys(_COLLECTIVES, 0)
    for c, ops in colls.items():
        for kind, b in ops:
            out[kind] += b * mult.get(c, 1)
    out["total"] = sum(out.values())
    return out


def _analysis(compiled) -> dict:
    """One device's temp bytes and FLOPs of a compiled SPMD step, as the
    reference's dry run reads them (``memory_analysis``, ``cost_analysis``)."""
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return {"temp": int(compiled.memory_analysis().temp_size_in_bytes),
            "flops": float(cost["flops"])}


def _jax_outputs(path, more=False):
    """psum_scatter of jax.lax on a (4, 2) mesh, and the reference's
    collective bytes of its partitioned dense and audio prefill and serve
    step (with `more`, also of the BYTES_PREFILL configs' prefill) on (2, 2)
    and (1, 4) meshes of four devices, as its parser counts them and with
    the layer loops' trip counts (`_trip_scaled_bytes`, "<key>_scaled");
    needs 8 XLA devices."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.launch import shardings as jshd
    from repro.launch.dryrun import collective_bytes_from_hlo
    from repro.sp import common as jcommon
    assert jax.device_count() >= 8, jax.device_count()
    x = np.random.default_rng(11).standard_normal((8, 8, 8)).astype(np.float32)
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    out = {}
    for name, (axes, dim) in PSUM_SCATTER.items():
        fn = lambda v, axes=axes, dim=dim: jax.lax.psum_scatter(  # noqa: E731
            v, axes, scatter_dimension=dim, tiled=True)
        out[name] = np.asarray(jcommon.shard_map(
            fn, mesh=mesh, in_specs=(P(("data", "model")),),
            out_specs=P(("data", "model")), check_vma=False)(x))
    ref = {}
    for name in SERVE_BYTES + tuple(n for n in BYTES_PREFILL if more and n not in SERVE_BYTES):
        jcfg, _ = _configs(name)
        pre, dec = _shapes(B, PROMPT, name)
        s_max = CONFIGS[name][2]
        params = jax.eval_shape(lambda: jmdl.init_params(jax.random.PRNGKey(0), jcfg))
        audio = jcfg.family == "audio"
        cache = jax.eval_shape(lambda: jmdl.init_cache(jcfg, B, s_max,
                                                       enc_len=PROMPT if audio else 0))
        batch = {"tokens": jax.ShapeDtypeStruct((B, 1 if audio else PROMPT), jnp.int32)}
        if audio:
            batch["frames"] = jax.ShapeDtypeStruct((B, PROMPT, jcfg.d_model), jnp.float32)
        for shape in ((2, 2), (1, 4)):
            m = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("data", "model"))
            p_sh = jshd.to_shardings(m, jshd.param_specs(jcfg, params, m, fsdp=False))
            c_sh = jshd.to_shardings(m, jshd.cache_specs(jcfg, cache, m, global_batch=B))
            b_sh = {k: NamedSharding(m, v) for k, v in jshd.batch_specs(jcfg, pre, m).items()}
            t_sh = NamedSharding(m, jshd.batch_specs(jcfg, dec, m)["token"])
            tag = f"{shape[0]}x{shape[1]}" + ("" if name == "dense" else f"_{name}")
            with m:
                f_pre = jax.jit(jst.build_prefill_step(jcfg, pre, mesh=m),
                                in_shardings=(p_sh, b_sh, c_sh), out_shardings=(None, c_sh))
                compiled = {"prefill": f_pre.lower(params, batch, cache).compile()}
                if name in SERVE_BYTES:
                    f_dec = jax.jit(jst.build_serve_step(jcfg, dec, mesh=m),
                                    in_shardings=(p_sh, c_sh, t_sh), out_shardings=(None, c_sh))
                    compiled["serve"] = f_dec.lower(
                        params, cache, jax.ShapeDtypeStruct((B,), jnp.int32)).compile()
                for step, c in compiled.items():
                    text = c.as_text()
                    ref[f"{step}_{tag}"] = collective_bytes_from_hlo(text)
                    ref[f"{step}_{tag}_scaled"] = _trip_scaled_bytes(text)
                    if name == "dense":
                        ref[f"{step}_{tag}_analysis"] = _analysis(c)
    out["reference_bytes"] = np.frombuffer(json.dumps(ref).encode(), np.uint8)
    np.savez(path, x=x, **out)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("partition") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", list(PSUM_SCATTER))
def test_psum_scatter_matches_lax(name, jax_out):
    axes, dim = PSUM_SCATTER[name]
    mesh = GangMesh(["cpu"] * 8, (4, 2), ("data", "model"))
    xs = mesh.shard(torch.from_numpy(jax_out["x"]), 0, ("data", "model"))
    got = torch.cat(mesh.psum_scatter(xs, axes, scatter_dimension=dim), 0)
    np.testing.assert_array_equal(got.numpy(), jax_out[name])
    p = mesh.axis_size(axes)
    assert mesh.collective_bytes[0] == dict(
        dict.fromkeys(KINDS, 0), **{"reduce-scatter": 64 * 4 // p, "total": 64 * 4 // p})


def test_reference_moves_the_kinds_the_port_moves(jax_out, models):
    """The reference's partitioned prefill on (2, 2) and (1, 4) gathers and
    reduces as the port's does (PERF.md sets the bytes side by side:
    `python tests/test_torch_partition.py --bytes`)."""
    ref = json.loads(jax_out["reference_bytes"].tobytes())
    for tag in ("2x2", "1x4"):
        pre = ref[f"prefill_{tag}"]
        assert pre["all-gather"] > 0 and pre["reduce-scatter"] + pre["all-reduce"] > 0
        assert ref[f"serve_{tag}"]["all-reduce"] > 0


@pytest.mark.parametrize("tag", ["2x2", "1x4"])
def test_reference_audio_prefill_moves_the_ports_bytes(tag, jax_out, models):
    """The reference's partitioned audio prefill (32 frames and a BOS token
    into a self cache of 40), its scanned encoder and decoder loops counted
    with XLA's trip counts, moves the port's bytes kind by kind: the
    encoder's wo and w_down sums all-reduced over a residual whole over
    "model", the BOS row's K/V gathered over their heads, the cross K/V
    all-to-all'd into the cross cache's slices.  Its serve step all-reduces
    the port's bytes (both merge the cross decode's partials over the cross
    cache's sequence; XLA also gathers the SwiGLU product and the cross
    logits' maxima, so it gathers more)."""
    ref = json.loads(jax_out["reference_bytes"].tobytes())
    _, cfg = _configs("audio")
    pre, dec = _shapes(B, PROMPT, "audio")
    mesh = _mesh(tuple(int(n) for n in tag.split("x")))
    assert ref[f"prefill_{tag}_audio_scaled"] == dryrun.collective_bytes(
        cfg, pre, mesh, max_len=CONFIGS["audio"][2])
    port = dryrun.collective_bytes(cfg, dec, mesh)
    got = ref[f"serve_{tag}_audio_scaled"]
    assert got["all-reduce"] == port["all-reduce"] and got["all-gather"] > port["all-gather"]


def main(argv):
    if argv[:1] == ["--bytes"]:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   PYTHONPATH=str(ROOT / "src"))
        path = ROOT / "build" / "partition_reference.npz"
        path.parent.mkdir(exist_ok=True)
        subprocess.run([sys.executable, __file__, str(path), "--more"], env=env, check=True)
        ref = json.loads(np.load(path)["reference_bytes"].tobytes())
        for name, kinds in [(n, ("prefill", "serve")) for n in SERVE_BYTES] + [
                (n, ("prefill",)) for n in BYTES_PREFILL if n not in SERVE_BYTES]:
            _, cfg = _configs(name)
            pre, dec = _shapes(B, PROMPT, name)
            for shape in ((2, 2), (1, 4)):
                mesh = _mesh(shape)
                tag = f"{shape[0]}x{shape[1]}" + ("" if name == "dense" else f"_{name}")
                port = {"prefill": dryrun.collective_bytes(cfg, pre, mesh,
                                                           max_len=CONFIGS[name][2]),
                        "serve": dryrun.collective_bytes(cfg, dec, mesh)}
                for step in kinds:
                    print(json.dumps({"config": name, "mesh": tag, "step": step,
                                      "reference": ref[f"{step}_{tag}"],
                                      "reference_trip_scaled": ref[f"{step}_{tag}_scaled"],
                                      "port": port[step]}))
                if name != "dense":
                    continue
                for step, acct in (("prefill", dryrun.rank_account(
                        cfg, pre, mesh, max_len=CONFIGS[name][2])),
                                   ("serve", dryrun.rank_account(cfg, dec, mesh))):
                    got = ref[f"{step}_{tag}_analysis"]
                    print(json.dumps({"config": name, "mesh": tag, "step": step,
                                      "reference_temp": got["temp"], "port_temp": acct["temp"],
                                      "reference_flops": got["flops"],
                                      "reference_flops_trip_scaled": got["flops"]
                                      * cfg.num_layers,
                                      "port_flops": acct["flops"]}))
        return 0
    _jax_outputs(argv[0], more="--more" in argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
