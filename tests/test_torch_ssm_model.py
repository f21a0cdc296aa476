"""Port ssm (Mamba2) and hybrid (Zamba2) models vs the JAX reference on the
same weights (bridged from `repro.models.init_params`): `forward` logits,
then `prefill` (last logits, conv and SSM states, the shared block's K/V),
then 4 `decode_step`s fed the same tokens.  Reduced configs in f32;
tolerance 1e-4 (f32 sums in another order through a few layers).  The
reference runs its plain XLA paths ("xla"), and once its Pallas kernels
B1, B2 and B3 in interpret mode ("pallas_interpret").

The slice as a whole: `launch/quickstart.py` on the CPU gives the same
greedy tokens as the reference's prefill + decode_step on its weights.
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
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import quickstart
from repro_torch.models import model as mdl

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
LAYERS = {"mamba2_130m": 2, "zamba2_2_7b": 4}     # zamba2: two segments of 2


def _configs(arch, layers):
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch), layers=layers),
                               dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch), layers=layers),
                              dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _close(got: torch.Tensor, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def _check_cache(cfg, cache, jcache, what):
    _close(cache["ssm"].conv, jcache["ssm"].conv, f"{what}: conv state")
    _close(cache["ssm"].ssm, jcache["ssm"].ssm, f"{what}: ssm state")
    if cfg.family == "hybrid":
        _close(cache["sh_k"], jcache["sh_k"], f"{what}: sh_k")
        _close(cache["sh_v"], jcache["sh_v"], f"{what}: sh_v")
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist()


@pytest.mark.parametrize("arch,impl", [("mamba2_130m", "xla"),
                                       ("zamba2_2_7b", "xla"),
                                       ("zamba2_2_7b", "pallas_interpret")])
def test_forward_prefill_decode_match_jax(arch, impl):
    jcfg, cfg = _configs(arch, LAYERS[arch])
    tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, device="cpu")
    assert params["layers"][0]["mamba"]["A_log"].dtype == torch.float32
    batch, seq = 2, 40                  # ragged against the reduced chunk of 32
    max_len = seq + 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (batch, seq)).astype(np.int32)

    jlogits, _ = jmdl.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              impl=impl)
    logits, _ = mdl.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(logits, jlogits, "forward logits")

    jl, jcache = jmdl.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              jmdl.init_cache(jcfg, batch, max_len), impl=impl)
    pl, cache = mdl.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                            mdl.init_cache(cfg, batch, max_len, device="cpu"))
    _close(pl, jl, "prefill logits")
    _check_cache(cfg, cache, jcache, "prefill")

    tok = np.array(jl.argmax(-1), np.int32)
    for step in range(4):
        jl, jcache = jmdl.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                      impl=impl)
        pl, cache = mdl.decode_step(cfg, params, cache,
                                    torch.from_numpy(tok).long())
        _close(pl, jl, f"decode step {step}")
        tok = np.array(jl.argmax(-1), np.int32)
    _check_cache(cfg, cache, jcache, "after 4 decode steps")


def test_prefill_past_cache_raises():
    """A prefill of 9 tokens into a shared-block cache of 8 raises: zamba2
    has no sliding window, so sh_k / sh_v have no ring.  With a window set
    (the shared block attends without one, as in the reference) sh_k / sh_v
    keep the most recent 8 positions in ring order (token t at slot t % 8),
    equal to the reference's roll, with equal last logits and SSM states."""
    jcfg, cfg = _configs("zamba2_2_7b", 2)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
    with pytest.raises(ValueError, match="ring buffer"):
        mdl.prefill(cfg, mdl.init_params(cfg, device="cpu"),
                    {"tokens": torch.from_numpy(toks)},
                    mdl.init_cache(cfg, 1, 8, device="cpu"))
    jcfg, cfg = (dataclasses.replace(c, sliding_window=8) for c in (jcfg, cfg))
    tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(tree, device="cpu")
    jl, jcache = jmdl.prefill(jcfg, jax.tree.map(jnp.asarray, tree),
                              {"tokens": jnp.asarray(toks)},
                              jmdl.init_cache(jcfg, 1, 8), impl="xla")
    pl, cache = mdl.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                            mdl.init_cache(cfg, 1, 8, device="cpu"))
    _close(pl, jl, "prefill logits")
    _check_cache(cfg, cache, jcache, "prefill past the cache")


def test_init_params_shapes_and_dtypes():
    _, cfg = _configs("zamba2_2_7b", 4)
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    p = mdl.init_params(cfg, seed=0, device="cpu")
    m = p["layers"][0]["mamba"]
    proj = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    assert m["in_proj"].shape == (cfg.d_model, proj)
    assert m["in_proj"].dtype == torch.bfloat16
    assert {m[k].dtype for k in ("A_log", "D", "dt_bias")} == {torch.float32}
    assert set(p["shared"]) == {"attn", "mlp", "ln1", "ln2"}
    cache = mdl.init_cache(cfg, 2, 16, device="cpu")
    assert cache["sh_k"].shape == (2, 2, cfg.num_kv_heads, 16, cfg.head_dim)
    assert cache["ssm"].ssm.dtype == torch.float32
    assert cache["ssm"].conv.shape == (4, 2, cfg.ssm_conv - 1,
                                       cfg.d_inner + 2 * cfg.ssm_state)


def _jax_tree(params):
    """The port's per-layer params stacked back into the reference's tree."""
    return jax.tree.map(jnp.asarray, params_to_numpy(params))


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_2_7b"])
def test_quickstart_greedy_tokens_match_jax(arch, capsys):
    n_tokens, batch, plen = 6, 2, 16
    out = quickstart.main(["--arch", arch, "--device", "cpu", "--layers", "2",
                           "--tokens", str(n_tokens), "--batch", str(batch),
                           "--prompt-len", str(plen)])
    assert out["logits_finite"]
    assert '"generated"' in capsys.readouterr().out
    jcfg, cfg = _configs(arch, 2)
    jparams = _jax_tree(mdl.init_params(cfg, seed=0, device="cpu"))
    prompt = quickstart.make_prompt(cfg, batch, plen, seed=0).numpy()
    lg, jcache = jmdl.prefill(jcfg, jparams, {"tokens": jnp.asarray(prompt)},
                              jmdl.init_cache(jcfg, batch, plen + n_tokens),
                              impl="xla")
    toks = [jnp.argmax(lg, -1).astype(jnp.int32)]
    for _ in range(n_tokens - 1):
        lg, jcache = jmdl.decode_step(jcfg, jparams, jcache, toks[-1], impl="xla")
        toks.append(jnp.argmax(lg, -1).astype(jnp.int32))
    assert out["generated"] == np.asarray(jnp.stack(toks, 1)).tolist()
