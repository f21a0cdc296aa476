"""Port dense model vs the JAX reference on the same weights (bridged from
`repro.models.init_params`): prefill logits and per-layer KV from
`forward(write_cache=True)`, then 4 `decode_step`s fed the same tokens.
Reduced configs in f32; tolerance 1e-4 (f32 sums in another order through a
few layers).  The reference runs its plain XLA attention ("xla")."""
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
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model as mdl

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(arch):
    """Reference and port configs: the same reduced dense model in f32
    (llama3_8b keeps its sliding window, reduced to 64)."""
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch), layers=2),
                               dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch), layers=2),
                              dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _jax_params(jcfg, seed=0):
    """The reference's weights as numpy; qkv biases are made non-zero so the
    bias path is exercised."""
    tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(seed),
                                                     jcfg))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in tree["layers"]["attn"]:
            b = tree["layers"]["attn"][name]
            tree["layers"]["attn"][name] = rng.normal(
                scale=0.1, size=b.shape).astype(b.dtype)
    return tree


@pytest.mark.parametrize("arch,batch,seq", [("mistral_7b", 2, 24),
                                            ("mistral_7b", 1, 17),
                                            ("qwen2_7b", 2, 24),
                                            ("llama3_8b", 2, 80)])
def test_forward_and_decode_match_jax(arch, batch, seq):
    jcfg, cfg = _configs(arch)
    tree = _jax_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, device="cpu")
    max_len = seq + 8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)

    jlogits, jaux = jmdl.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                                 impl="xla", write_cache=True)
    logits, aux = mdl.forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                              write_cache=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for li, kv in enumerate(aux["kv"]):
        np.testing.assert_allclose(kv.k.numpy(), np.asarray(jaux["kv"].k[li]), **TOL)
        np.testing.assert_allclose(kv.v.numpy(), np.asarray(jaux["kv"].v[li]), **TOL)

    jcache = jmdl.init_cache(jcfg, batch, max_len)
    _, jcache = jmdl.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                             jcache, impl="xla")
    cache = mdl.init_cache(cfg, batch, max_len, device="cpu")
    for li, kv in enumerate(aux["kv"]):
        cache["k"][li, :, :, :seq] = kv.k
        cache["v"][li, :, :, :seq] = kv.v
    cache["len"][:] = seq
    tok = np.array(jlogits[:, -1].argmax(-1), np.int32)
    for _ in range(4):
        jl, jcache = jmdl.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                      impl="xla")
        pl, cache = mdl.decode_step(cfg, params, cache,
                                    torch.from_numpy(tok).long())
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        tok = np.array(jl.argmax(-1), np.int32)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]), **TOL)
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()


def test_padded_vocab_masked():
    cfg = dataclasses.replace(reduced_config(get_config("mistral_7b")),
                              vocab_size=500)
    assert cfg.padded_vocab == 512
    out = mdl._mask_padded_vocab(cfg, torch.zeros(2, 512))
    assert (out[:, 500:] == -1e30).all() and (out[:, :500] == 0).all()


def test_init_params_shapes_and_other_families_raise():
    cfg = dataclasses.replace(reduced_config(get_config("qwen2_7b")),
                              dtype="float32")
    p = mdl.init_params(cfg, seed=0, device="cpu")
    assert len(p["layers"]) == cfg.num_layers
    assert p["layers"][0]["attn"]["wq"].shape == (cfg.d_model,
                                                  cfg.num_heads * cfg.head_dim)
    assert "bq" in p["layers"][0]["attn"]
    again = mdl.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(p["layers"][1]["mlp"]["w_up"],
                       again["layers"][1]["mlp"]["w_up"])
    with pytest.raises(ValueError, match="unknown model family"):
        mdl.init_params(dataclasses.replace(cfg, family="rnn"), device="cpu")
