"""The sequence-sharded decode hook (`layers._cached_decode_attention`)
against the unsharded decode and against the reference's, reduced f32
(4 layers, d_model 256), the reference's weights bridged.

Under `use_rules(standard_rules(make_host_mesh(model, devices=["cpu"] *
4), long_context=...))` a decode step sends every self-attention layer to
`sp.decode.distributed_decode_attention` (a counter shows it, and that
without rules, or with a cache length the axes do not divide, every layer
goes to `ops.decode_attention`), and its logits and caches equal the
unsharded step's to 1e-5, for "cache_seq" over "model" and over ("data",
"model"), with a sliding window and with the ring buffer.  The same steps
on an eight-rank mesh equal the reference's `build_serve_step(...,
mesh=make_host_mesh(model))` (or its rules entered directly, where the
batch is not one sequence but the cache spans both axes) to the decode
twins' 1e-4 (tests/test_torch_ring.py): the reference runs once per
module in ONE subprocess with eight forced XLA devices (this file run as a
script), which writes its logits and greedy tokens to an .npz.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import model as jmdl
from repro_torch.bridge import params_from_jax
from repro_torch.configs import INPUT_SHAPES, get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as mdl
from repro_torch.models.sharding import standard_rules, use_rules
from repro_torch.sp import decode as sp_decode

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5          # sharded against unsharded, the same package
TWIN_TOL = 1e-4     # against the reference
STEPS = 3
#: name -> (arch, batch, cache length, prompt, model ranks, long_context,
#: the shape's name: "long_500k" rings a sliding-window model)
CASES = {
    "model": ("mistral_7b", 2, 64, 40, 4, False, "decode"),
    "data_model": ("mistral_7b", 2, 64, 40, 2, True, "decode"),
    "window": ("llama3_8b", 2, 128, 96, 4, False, "decode"),
    "ring": ("llama3_8b", 1, 64, 96, 1, True, "long_500k"),
}


def _configs(arch):
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch), layers=4), dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch), layers=4), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _shape(name):
    arch, B, S, prompt, model, lc, shape = CASES[name]
    if shape == "long_500k":
        return INPUT_SHAPES["long_500k"]
    return ShapeConfig(f"decode_{S}", S, B, "decode")


def _prompt(name, vocab):
    _, B, _, prompt, _, _, _ = CASES[name]
    return np.random.default_rng(7).integers(0, vocab, (B, prompt)).astype(np.int32)


def _jax_outputs(path):
    """The reference's prefill and STEPS sharded serve steps per case;
    needs 8 XLA devices."""
    from repro.launch import steps as jst
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro.models.sharding import standard_rules as j_rules
    from repro.models.sharding import use_rules as j_use_rules
    assert jax.device_count() >= 8, jax.device_count()
    out = {}
    for name, (arch, B, S, _, model, lc, shape_name) in CASES.items():
        jcfg, _ = _configs(arch)
        shape = _shape(name)
        params = jmdl.init_params(jax.random.PRNGKey(0), jcfg)
        lg, cache = jmdl.prefill(jcfg, params, {"tokens": jnp.asarray(_prompt(name, jcfg.vocab_size))},
                                 jmdl.init_cache(jcfg, B, S), impl="xla")
        mesh = j_host_mesh(model)
        serve = jst.build_serve_step(jcfg, shape, mesh=mesh)
        if lc != (B == 1):       # the serve step's rules do not span these axes
            def serve(p, c, t):  # (no ring: the case is mistral_7b's)
                with j_use_rules(j_rules(mesh, long_context=lc)):
                    return jmdl.decode_step(jcfg, p, c, t, impl="xla")
        toks, logits = [], []
        for _ in range(STEPS):
            toks.append(np.asarray(lg.argmax(-1), np.int32))
            lg, cache = serve(params, cache, jnp.asarray(toks[-1]))
            logits.append(np.asarray(lg))
        out[f"{name}_tokens"] = np.stack(toks)
        out[f"{name}_logits"] = np.stack(logits)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_decode") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in {c[0] for c in CASES.values()}:
        jcfg, cfg = _configs(arch)
        tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
        out[arch] = (cfg, params_from_jax(tree, device="cpu"))
    return out


class _Counted:
    """Counts the calls of a module function it replaces."""

    def __init__(self, monkeypatch, module, name):
        self.n, fn = 0, getattr(module, name)

        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counted)


def _prefilled(name, models):
    arch, B, S, _, _, _, _ = CASES[name]
    cfg, params = models[arch]
    lg, cache = mdl.prefill(cfg, params, {"tokens": torch.from_numpy(_prompt(name, cfg.vocab_size)).long()},
                            mdl.init_cache(cfg, B, S, device="cpu"))
    return cfg, params, lg, cache


def _decode(cfg, params, cache, shape, lg, tokens=None, rules=None):
    """STEPS serve steps from the prefill's logits `lg`, fed `tokens` or,
    without them, their own greedy tokens: (tokens, logits)."""
    toks, logits = [], []
    for i in range(STEPS):
        tok = tokens[i] if tokens is not None else lg.argmax(-1)
        with use_rules(rules), torch.no_grad():
            lg, _ = mdl.decode_step(cfg, params, cache, tok,
                                    ring_buffer=steps.ring_buffer(cfg, shape))
        toks.append(tok)
        logits.append(lg)
    return toks, logits


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_equals_unsharded(name, models, monkeypatch):
    arch, B, S, _, model, lc, _ = CASES[name]
    cfg, params, lg, cache = _prefilled(name, models)
    shape = _shape(name)
    rules = standard_rules(make_host_mesh(model, devices=["cpu"] * 4), long_context=lc)
    assert rules.rules["cache_seq"] == (("data", "model") if lc else ("model",))
    sharded_cache = _clone(cache)
    dist = _Counted(monkeypatch, sp_decode, "distributed_decode_attention")
    local = _Counted(monkeypatch, ops, "decode_attention")
    toks, want = _decode(cfg, params, cache, shape, lg)
    assert (dist.n, local.n) == (0, cfg.num_layers * STEPS)
    _, got = _decode(cfg, params, sharded_cache, shape, lg, toks, rules)
    assert (dist.n, local.n) == (cfg.num_layers * STEPS, cfg.num_layers * STEPS)
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL, msg=f"step {i}")
    for k in ("k", "v", "len"):
        torch.testing.assert_close(sharded_cache[k], cache[k], atol=TOL, rtol=TOL)


def test_undivided_cache_goes_to_the_local_decode(models, monkeypatch):
    """A cache of 66 positions over 4 "model" ranks does not divide: every
    layer takes ops.decode_attention under the rules too."""
    cfg, params = models["mistral_7b"]
    cache = mdl.init_cache(cfg, 2, 66, device="cpu")
    lg, cache = mdl.prefill(cfg, params, {"tokens": torch.arange(80).reshape(2, 40) % 500}, cache)
    dist = _Counted(monkeypatch, sp_decode, "distributed_decode_attention")
    local = _Counted(monkeypatch, ops, "decode_attention")
    rules = standard_rules(make_host_mesh(4, devices=["cpu"] * 4))
    with use_rules(rules):
        mdl.decode_step(cfg, params, cache, lg.argmax(-1))
    assert (dist.n, local.n) == (0, cfg.num_layers)


def test_serve_step_with_a_mesh_enters_its_rules(models, monkeypatch):
    """build_serve_step(mesh=...) decodes sharded; without a mesh, not."""
    cfg, params, lg, cache = _prefilled("ring", models)
    dist = _Counted(monkeypatch, sp_decode, "distributed_decode_attention")
    shape = _shape("ring")
    mesh = make_host_mesh(1, devices=["cpu"] * 4)
    steps.build_serve_step(cfg, shape, mesh=mesh)(params, _clone(cache), lg.argmax(-1))
    assert dist.n == cfg.num_layers
    steps.build_serve_step(cfg, shape)(params, cache, lg.argmax(-1))
    assert dist.n == cfg.num_layers


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_reference(name, jax_out, models):
    """On the reference's (8 / model, model) host mesh over eight CPU
    ranks, fed the reference's greedy tokens."""
    arch, B, S, _, model, lc, _ = CASES[name]
    cfg, params, lg, cache = _prefilled(name, models)
    rules = standard_rules(make_host_mesh(model, devices=["cpu"] * 8), long_context=lc)
    toks = [torch.from_numpy(t).long() for t in jax_out[f"{name}_tokens"]]
    assert torch.equal(toks[0], lg.argmax(-1))
    _, got = _decode(cfg, params, cache, _shape(name), lg, toks, rules)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), jax_out[f"{name}_logits"][i],
                                   atol=TWIN_TOL, rtol=TWIN_TOL, err_msg=f"step {i}")


if __name__ == "__main__":
    _jax_outputs(sys.argv[1])
