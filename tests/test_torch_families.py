"""Port moe, audio (encoder-decoder) and vlm models vs the JAX reference on
the same weights (bridged from `repro.models.init_params`): `forward`
logits (and moe's `lb_loss` and `dropped_frac`), then `prefill` (last
logits and every cache tensor: k, v, cross_k, cross_v, cross_len, len),
then 4 `decode_step`s fed the same tokens.  Reduced configs in f32;
tolerance 1e-4 (f32 sums in another order through a few layers).  The
reference runs its plain XLA paths ("xla"), and once its Pallas kernels B1
and B2 in interpret mode ("pallas_interpret").

The moe block alone: the port's routing (experts chosen, drops at the
default capacity factor, with and without several routing groups) equals
the reference's, and the port's index dispatch equals the reference's
one-hot einsum dispatch (`moe_block_onehot`).

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
from repro.models import moe as jmoe
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import quickstart
from repro_torch.models import model as mdl
from repro_torch.models import moe

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["olmoe_1b_7b", "llama4_maverick_400b_a17b", "seamless_m4t_large_v2",
         "internvl2_76b"]
MOE_ARCHS = ["olmoe_1b_7b", "llama4_maverick_400b_a17b"]


def _configs(arch, layers=2):
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch), layers=layers),
                               dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch), layers=layers),
                              dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _close(got: torch.Tensor, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def _inputs(cfg, batch, seq, seed):
    """numpy inputs: tokens (batch, seq) and vlm embeds / audio frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.family in ("vlm", "audio"):
        out["embeds" if cfg.family == "vlm" else "frames"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _same_drops(aux, jaux):
    """Equal dropped_frac up to the f32 rounding of its means (one drop
    more or less moves it by 1 / (layers * tokens * K), 1e-3 or more here)."""
    assert float(jaux["dropped_frac"]) > 0
    assert abs(float(aux["dropped_frac"]) - float(jaux["dropped_frac"])) < 1e-6


def _check_cache(cache, jcache, what):
    for name in ("k", "v", "cross_k", "cross_v"):
        if name in jcache:
            _close(cache[name], jcache[name], f"{what}: {name}")
    for name in ("len", "cross_len"):
        if name in jcache:
            assert cache[name].tolist() == np.asarray(jcache[name]).tolist(), name


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, impl):
    jcfg, cfg = _configs(arch)
    tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, device="cpu")
    if cfg.family == "moe":
        assert params["layers"][0]["moe"]["router"].dtype == torch.float32
    batch, seq = 2, (6 if cfg.family == "audio" else 40)
    inputs = _inputs(cfg, batch, seq, seed=1)
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    tb = {k: torch.from_numpy(v) for k, v in inputs.items()}
    n_prefix = inputs["embeds"].shape[1] if "embeds" in inputs else 0
    max_len = n_prefix + seq + 8
    enc_len = inputs["frames"].shape[1] if "frames" in inputs else 0

    jlogits, jaux = jmdl.forward(jcfg, jparams, jb, impl=impl)
    logits, aux = mdl.forward(cfg, params, tb)
    assert logits.shape == (batch, seq, cfg.padded_vocab)
    _close(logits, jlogits, "forward logits")
    if cfg.family == "moe":
        _close(aux["lb_loss"], jaux["lb_loss"], "lb_loss")
        _same_drops(aux, jaux)

    jl, jcache = jmdl.prefill(jcfg, jparams, jb,
                              jmdl.init_cache(jcfg, batch, max_len, enc_len=enc_len),
                              impl=impl)
    pl, cache = mdl.prefill(cfg, params, tb,
                            mdl.init_cache(cfg, batch, max_len, enc_len=enc_len,
                                           device="cpu"))
    _close(pl, jl, "prefill logits")
    _check_cache(cache, jcache, "prefill")

    tok = np.array(jl.argmax(-1), np.int32)
    for step in range(4):
        jl, jcache = jmdl.decode_step(jcfg, jparams, jcache, jnp.asarray(tok),
                                      impl=impl)
        pl, cache = mdl.decode_step(cfg, params, cache,
                                    torch.from_numpy(tok).long())
        _close(pl, jl, f"decode step {step}")
        tok = np.array(jl.argmax(-1), np.int32)
    _check_cache(cache, jcache, "after 4 decode steps")


def _moe_layer_params(jcfg, seed):
    """Layer 0 of the reference's init_moe, as numpy and as the port's."""
    tree = jax.tree.map(lambda a: np.array(a)[0],
                        jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, 1, jnp.float32))

    def to_torch(t):
        return ({k: to_torch(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.from_numpy(t))
    return tree, to_torch(tree)


@pytest.mark.parametrize("group_size", [2048, 32])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_and_drops_match_jax(arch, group_size):
    """At the default capacity factor some assignments are dropped; the
    port drops the same ones (equal dropped_frac), picks the same experts
    and gives the same output and load-balance loss, in one routing group
    and in four."""
    jcfg, cfg = _configs(arch)
    tree, p = _moe_layer_params(jcfg, seed=3)
    rng = np.random.default_rng(5)
    # a direction shared by every token skews the routing, so experts overflow
    x = (rng.standard_normal((2, 64, cfg.d_model))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_block(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                              group_size=group_size)
    y, aux = moe.moe_block(cfg, p, torch.from_numpy(x), group_size=group_size)
    _same_drops(aux, jaux)
    _close(aux["lb_loss"], jaux["lb_loss"], "lb_loss")
    _close(y, jy, "moe output")
    r = moe.route(cfg, p["router"], torch.from_numpy(x), group_size=group_size)
    G, Tg, _ = r.expert.shape
    assert G == (1 if group_size == 2048 else 4)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(G, Tg, -1) @ tree["router"], -1)
    _, jexpert = jax.lax.top_k(probs, cfg.experts_per_token)
    assert r.expert.tolist() == np.asarray(jexpert).tolist()


@pytest.mark.parametrize("cf,group_size,dtype", [(None, 2048, torch.float32),
                                                 (None, 16, torch.float32),
                                                 (4.0, 32, torch.float32),
                                                 (0.5, 2048, torch.bfloat16)])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_index_dispatch_matches_onehot(arch, cf, group_size, dtype):
    """`moe_block` (sorted indices, one product per expert with rows) against
    the reference's one-hot einsum dispatch in plain PyTorch, with drops,
    several groups, the dropless capacity E and a bf16 model (2e-2)."""
    _, cfg = _configs(arch)
    cfg = dataclasses.replace(cfg, dtype=str(dtype).split(".")[1])
    p = moe.init_moe(torch.Generator().manual_seed(7), cfg, dtype, "cpu")
    g = torch.Generator().manual_seed(8)
    x = (torch.randn((3, 40, cfg.d_model), generator=g)
         + torch.randn(cfg.d_model, generator=g)).to(dtype)
    kw = dict(capacity_factor=cf, group_size=group_size)
    y, aux = moe.moe_block(cfg, p, x, **kw)
    want, want_aux = moe.moe_block_onehot(cfg, p, x, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)
    assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])
    if cf == 4.0:
        assert float(aux["dropped_frac"]) == 0.0
    else:
        assert float(aux["dropped_frac"]) > 0.0


@pytest.mark.parametrize("arch", ["seamless_m4t_large_v2", "internvl2_76b"])
def test_prefill_past_cache_raises(arch):
    """A prefill longer than its cache (vlm: 16 patch embeddings + 4 tokens
    into 16 positions; audio: 16 frames into a cross cache of 8).  The vlm
    model has no sliding window, so its self-attention cache has no ring
    and the prefill raises; with a window of 8 it keeps the most recent
    positions in ring order, token t at slot t % S_max.  The audio cross
    cache rolls so in either case.  A roll's last logits and every cache
    tensor equal the reference's (its `_write_prefix` roll)."""
    jcfg, cfg = _configs(arch)
    inputs = _inputs(cfg, 1, 4, seed=0)
    max_len, enc_len = (8, 8) if cfg.family == "audio" else (16, 0)
    if cfg.family == "vlm":
        with pytest.raises(ValueError, match="ring buffer"):
            mdl.prefill(cfg, mdl.init_params(cfg, device="cpu"),
                        {k: torch.from_numpy(v) for k, v in inputs.items()},
                        mdl.init_cache(cfg, 1, max_len, device="cpu"))
        jcfg, cfg = (dataclasses.replace(c, sliding_window=8) for c in (jcfg, cfg))
    tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(tree, device="cpu")
    jl, jcache = jmdl.prefill(jcfg, jax.tree.map(jnp.asarray, tree),
                              {k: jnp.asarray(v) for k, v in inputs.items()},
                              jmdl.init_cache(jcfg, 1, max_len, enc_len=enc_len),
                              impl="xla")
    pl, cache = mdl.prefill(cfg, params,
                            {k: torch.from_numpy(v) for k, v in inputs.items()},
                            mdl.init_cache(cfg, 1, max_len, enc_len=enc_len,
                                           device="cpu"))
    _close(pl, jl, "prefill logits")
    _check_cache(cache, jcache, "prefill past the cache")


def _jax_tree(params):
    """The port's per-layer params stacked back into the reference's tree."""
    return jax.tree.map(jnp.asarray, params_to_numpy(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_quickstart_greedy_tokens_match_jax(arch, capsys):
    n_tokens, batch, plen = 6, 2, 16
    out = quickstart.main(["--arch", arch, "--device", "cpu", "--layers", "2",
                           "--tokens", str(n_tokens), "--batch", str(batch),
                           "--prompt-len", str(plen)])
    assert out["logits_finite"]
    assert '"generated"' in capsys.readouterr().out
    jcfg, cfg = _configs(arch)
    jparams = _jax_tree(mdl.init_params(cfg, seed=0, device="cpu"))
    inputs = {k: jnp.asarray(v.numpy()) for k, v in
              quickstart.make_batch(cfg, batch, plen, seed=0).items()}
    if cfg.family == "audio":
        assert inputs["tokens"].shape == (batch, 1)
    n = inputs["tokens"].shape[1] + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    cf = float(cfg.num_experts) if cfg.family == "moe" else None
    lg, jcache = jmdl.prefill(jcfg, jparams, inputs,
                              jmdl.init_cache(jcfg, batch, n + n_tokens,
                                              enc_len=cfg.frontend_tokens),
                              impl="xla", moe_cf=cf)
    toks = [jnp.argmax(lg, -1).astype(jnp.int32)]
    for _ in range(n_tokens - 1):
        lg, jcache = jmdl.decode_step(jcfg, jparams, jcache, toks[-1], impl="xla")
        toks.append(jnp.argmax(lg, -1).astype(jnp.int32))
    assert out["generated"] == np.asarray(jnp.stack(toks, 1)).tolist()
