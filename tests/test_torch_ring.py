"""The sliding-window ring buffer of the port against the JAX reference, on
the same weights (bridged from `repro.models.init_params`), reduced f32
configs, the reference on its plain XLA paths.

A prefill longer than a cache keeps the most recent positions, token t at
slot t % S_max (the reference's `_write_prefix` roll), and
`decode_step(ring_buffer=True)` writes at len % S_max and attends over the
whole ring: logits (1e-4) and the ring's contents equal the reference's
step by step past the window, for the dense and moe self-attention caches,
the hybrid's shared-block `sh_k`/`sh_v` and the audio `cross_k`/`cross_v`;
the serve step built for long_500k decodes so; and the twin of
tests/test_models.py::test_sliding_window_ring_buffer_decode holds (the
ring's greedy token equals a windowed teacher-forced forward's).
"""
import dataclasses

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
from repro_torch.launch import steps
from repro_torch.models import model as mdl

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(arch, **over):
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch)),
                               dtype="float32", **over)
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32", **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _models(jcfg, cfg, seed=0):
    tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, device="cpu")


def _close(got: torch.Tensor, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def _check_rings(cache, jcache, names, what):
    for name in names:
        _close(cache[name], jcache[name], f"{what}: {name}")
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()


def test_sliding_window_ring_buffer_decode():
    """Twin of the reference's test: a cache of one window (8), a 12-token
    prompt, 4 ring decode steps; the last greedy token equals the argmax of
    a teacher-forced forward with the same window over the whole sequence."""
    _, cfg = _configs("llama3_8b", sliding_window=8)
    params = mdl.init_params(cfg, seed=3, device="cpu")
    B, S, W = 2, 12, 8
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=torch.Generator().manual_seed(3))}
    cache = mdl.init_cache(cfg, B, W, device="cpu")
    lg, cache = mdl.prefill(cfg, params, batch, cache)
    toks = [lg.argmax(-1)]
    for _ in range(4):
        lg, cache = mdl.decode_step(cfg, params, cache, toks[-1], ring_buffer=True)
        toks.append(lg.argmax(-1))
    seq = torch.cat([batch["tokens"]] + [t[:, None] for t in toks[:-1]], 1)
    logits_full, _ = mdl.forward(cfg, params, {"tokens": seq})
    assert logits_full[:, -1].argmax(-1).tolist() == toks[-1].tolist()
    torch.testing.assert_close(lg, logits_full[:, -1], atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("arch,window,prompt", [("llama3_8b", 8, 13),
                                                ("olmoe_1b_7b", 8, 11)])
def test_ring_decode_matches_jax(arch, window, prompt):
    """Prefill past a cache of 8 (rolled), then 6 ring decode steps, each
    fed the reference's greedy token: logits and the K/V ring equal the
    reference's decode_step(ring_buffer=True) at every step.  (moe layers
    attend without the window in both packages; the window is what lets
    the prefill keep a ring.)"""
    jcfg, cfg = _configs(arch, sliding_window=window)
    jparams, params = _models(jcfg, cfg)
    B, S_max = 2, 8
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (B, prompt)).astype(np.int32)
    cf = float(cfg.num_experts) if cfg.family == "moe" else None
    jl, jcache = jmdl.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              jmdl.init_cache(jcfg, B, S_max), impl="xla", moe_cf=cf)
    pl, cache = mdl.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                            mdl.init_cache(cfg, B, S_max, device="cpu"), moe_cf=cf)
    _close(pl, jl, "prefill logits")
    _check_rings(cache, jcache, ("k", "v"), "prefill")
    tok = np.array(jl.argmax(-1), np.int32)
    for step in range(6):
        jl, jcache = jmdl.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                      impl="xla", ring_buffer=True)
        pl, cache = mdl.decode_step(cfg, params, cache, torch.from_numpy(tok).long(),
                                    ring_buffer=True)
        _close(pl, jl, f"ring decode step {step}")
        _check_rings(cache, jcache, ("k", "v"), f"ring decode step {step}")
        tok = np.array(jl.argmax(-1), np.int32)


def test_hybrid_shared_ring_matches_jax():
    """zamba2 with a window of 8 (which its shared block, as the
    reference's, does not apply): the shared block's caches past their
    length (sh_k, sh_v rolled), then 5 ring decode steps against the
    reference."""
    jcfg, cfg = _configs("zamba2_2_7b", sliding_window=8)
    jparams, params = _models(jcfg, cfg)
    B, S_max, prompt = 2, 8, 19
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (B, prompt)).astype(np.int32)
    jl, jcache = jmdl.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              jmdl.init_cache(jcfg, B, S_max), impl="xla")
    pl, cache = mdl.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                            mdl.init_cache(cfg, B, S_max, device="cpu"))
    _close(pl, jl, "prefill logits")
    _check_rings(cache, jcache, ("sh_k", "sh_v"), "prefill")
    tok = np.array(jl.argmax(-1), np.int32)
    for step in range(5):
        jl, jcache = jmdl.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                      impl="xla", ring_buffer=True)
        pl, cache = mdl.decode_step(cfg, params, cache, torch.from_numpy(tok).long(),
                                    ring_buffer=True)
        _close(pl, jl, f"ring decode step {step}")
        _check_rings(cache, jcache, ("sh_k", "sh_v"), f"ring decode step {step}")
        _close(cache["ssm"].ssm, jcache["ssm"].ssm, f"ssm state, step {step}")
        tok = np.array(jl.argmax(-1), np.int32)


def test_audio_cross_roll_matches_jax():
    """seamless: 16 encoder frames into a cross cache of 12 (cross_k,
    cross_v rolled, cross_len 16 as the reference sets it), then 4 decode
    steps with ring_buffer=True (the decoder's self cache stays linear, as
    in the reference)."""
    jcfg, cfg = _configs("seamless_m4t_large_v2")
    jparams, params = _models(jcfg, cfg)
    B, enc_len = 2, 12
    rng = np.random.default_rng(6)
    inputs = {"tokens": np.zeros((B, 1), np.int32),
              "frames": rng.standard_normal((B, cfg.frontend_tokens,
                                             cfg.d_model)).astype(np.float32)}
    jl, jcache = jmdl.prefill(jcfg, jparams, {k: jnp.asarray(v) for k, v in inputs.items()},
                              jmdl.init_cache(jcfg, B, 8, enc_len=enc_len), impl="xla")
    pl, cache = mdl.prefill(cfg, params, {k: torch.from_numpy(v) for k, v in inputs.items()},
                            mdl.init_cache(cfg, B, 8, enc_len=enc_len, device="cpu"))
    _close(pl, jl, "prefill logits")
    _check_rings(cache, jcache, ("cross_k", "cross_v", "k", "v"), "prefill")
    assert cache["cross_len"].tolist() == np.asarray(jcache["cross_len"]).tolist()
    tok = np.array(jl.argmax(-1), np.int32)
    for step in range(4):
        jl, jcache = jmdl.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                      impl="xla", ring_buffer=True)
        pl, cache = mdl.decode_step(cfg, params, cache, torch.from_numpy(tok).long(),
                                    ring_buffer=True)
        _close(pl, jl, f"decode step {step}")
        _check_rings(cache, jcache, ("k", "v"), f"decode step {step}")
        tok = np.array(jl.argmax(-1), np.int32)


@pytest.mark.parametrize("arch", ["mistral_7b", "olmoe_1b_7b"])
def test_prefill_without_window_past_cache_raises(arch):
    """A model without a sliding window has no ring: a 9-token prefill into
    a cache of 8 raises (a ValueError naming the ring buffer) instead of
    dropping the oldest position, and leaves the cache as it was."""
    _, cfg = _configs(arch)
    assert cfg.sliding_window == 0
    cache = mdl.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="ring buffer"):
        mdl.prefill(cfg, mdl.init_params(cfg, seed=0, device="cpu"),
                    {"tokens": torch.zeros((1, 9), dtype=torch.long)}, cache)
    assert not cache["k"].any() and cache["len"].tolist() == [0]
    _, cache = mdl.prefill(cfg, mdl.init_params(cfg, seed=0, device="cpu"),
                           {"tokens": torch.zeros((1, 8), dtype=torch.long)}, cache)
    assert cache["len"].tolist() == [8]


def test_serve_step_long_500k_rings():
    """The serve step built for long_500k decodes a sliding-window model
    into a ring of one window (sized by `steps.cache_lengths`), and the
    ring's logits equal a windowed forward over the extended sequence
    (the f32 invariant's 1e-3 / 5e-3)."""
    _, cfg = _configs("llama3_8b", sliding_window=8)
    shape = dataclasses.replace(INPUT_SHAPES["long_500k"], seq_len=20)
    assert steps.ring_buffer(cfg, shape)
    assert not steps.ring_buffer(cfg, INPUT_SHAPES["decode_32k"])
    assert steps.supports_shape(cfg, shape)[0]
    assert not steps.supports_shape(get_config("mistral_7b"), shape)[0]
    max_len, enc_len = steps.cache_lengths(cfg, shape)
    assert (max_len, enc_len) == (8, 0)
    params = mdl.init_params(cfg, seed=1, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 12),
                         generator=torch.Generator().manual_seed(1))
    prefill_step = steps.build_prefill_step(cfg, shape)
    serve_step = steps.build_serve_step(cfg, shape)
    lg, cache = prefill_step(params, {"tokens": toks},
                             mdl.init_cache(cfg, 1, max_len, device="cpu"))
    seq, outs = toks, []
    for _ in range(5):
        seq = torch.cat([seq, lg.argmax(-1)[:, None]], 1)
        lg, cache = serve_step(params, cache, seq[:, -1])
        outs.append(lg)
    full, _ = mdl.forward(cfg, params, {"tokens": seq})
    torch.testing.assert_close(torch.stack(outs, 1), full[:, 12:], atol=5e-3, rtol=5e-3)
    assert cache["len"].tolist() == [17]
