"""The port's optimizer, train step, checkpoints and data against the JAX
reference, one reduced f32 config per family, on the same weights (bridged
from `repro.models.init_params`) and the same numpy inputs.

- `adamw_update`, one and three steps: params, every moment and grad_norm
  equal the reference's (rtol 1e-5, atol 1e-7; the bf16 first moment of a
  factored leaf to one bf16 rounding, and after it the params of a
  factored leaf to lr x that rounding), both with the default threshold and
  with FACTOR_THRESHOLD set, in both packages, between a per-layer leaf's
  size and its stacked size: the case where deciding per layer would not
  factor a leaf the reference factors;
- three `build_train_step` steps equal the reference's jitted train step
  (loss and grad_norm to 1e-4; params to 1e-4 but where a gradient near 0
  flips the sign of its Adam update, see `_assert_params_close`);
- checkpoints load across packages both ways, in the reference's flat
  stacked layout, and a bf16 leaf is written byte for byte as the
  reference writes it;
- `SyntheticLMData` batches are the reference's, and `launch/train_lm`'s
  loop lowers the loss of a small model on them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.launch import steps as jsteps
from repro.models import model as jmdl
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps, train, train_lm
from repro_torch.models.model import param_leaves
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import data
from repro_torch.training import optimizer as opt

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

ARCHS = ["qwen2_7b", "olmoe_1b_7b", "mamba2_130m", "zamba2_2_7b",
         "seamless_m4t_large_v2", "internvl2_76b"]


def _configs(arch, dtype="float32"):
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch)), dtype=dtype)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _tree(jcfg, seed=0):
    return jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(seed), jcfg))


#: where f32 sums in another order round a factored leaf's first moment to
#: the other bf16 neighbour (2^-8 relative), every later update of that
#: parameter moves by lr x 2^-8 x its Adam ratio m̂ / sqrt(v̂) (up to ~4
#: against a rank-1 v̂): over the two steps after the first, lr x 2^-5
BF16_M_ATOL = 3e-4 * 2 ** -5


def _random_like(tree, seed):
    """A tree of standard normal f32 arrays shaped like `tree` (gradients)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32)
                        * 0.01, tree)


def _leaves_with_path(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_close(got, want, what, rtol=1e-5, atol=1e-7):
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for (path, w), g in zip(_leaves_with_path(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            # the bf16 first moment: f32 values equal to ~1e-7 may round to
            # neighbouring bf16 values (2^-8 relative), and a rounding
            # carried from an earlier step (times b1) is at most one bf16
            # step of the leaf's largest moment
            g = np.asarray(jnp.asarray(g.view(np.int16)).view(jnp.bfloat16))
            w = w.astype(np.float32)
            np.testing.assert_allclose(g.astype(np.float32), w, rtol=2 ** -7,
                                       atol=2 ** -8 * np.abs(w).max(),
                                       err_msg=f"{what}{jax.tree_util.keystr(path)}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _stacked_threshold(tree):
    """A FACTOR_THRESHOLD between the per-layer and the stacked size of a
    leaf of 2+ dims per layer (the smallest such leaf at or above every
    1-D per-layer leaf's stacked size, so nothing is factored across
    layers)."""
    per_layer, one_d = [], [0]
    for name in ("layers", "encoder"):
        for leaf in jax.tree.leaves(tree.get(name, {})):
            (per_layer if leaf.ndim >= 3 else one_d).append(
                leaf.size // leaf.shape[0] if leaf.ndim >= 3 else leaf.size)
    t = min(n for n in per_layer if n >= max(one_d))
    return t


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("factoring", ["default", "stacked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_matches_jax(arch, factoring, n_steps, monkeypatch):
    jcfg, cfg = _configs(arch)
    tree = _tree(jcfg)
    if factoring == "stacked":
        t = _stacked_threshold(tree)
        monkeypatch.setattr(jopt, "FACTOR_THRESHOLD", t)
        monkeypatch.setattr(opt, "FACTOR_THRESHOLD", t)
    params = params_from_jax(tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate, state = jopt.adamw_init(jparams), opt.adamw_init(params)
    factored = [p for p, m in zip(jax.tree.leaves(jparams),
                                  jax.tree.leaves(jstate.moments,
                                                  is_leaf=lambda x: "m" in x))
                if "vr" in m]
    if factoring == "stacked":
        # at least one leaf is factored only by its stacked size
        assert any(p.size // p.shape[0] <= opt.FACTOR_THRESHOLD < p.size
                   for p in factored)
    _assert_trees_close(params_to_numpy(state),
                        {"step": jstate.step, "moments": jstate.moments}, "init")
    for i in range(n_steps):
        g = _random_like(tree, seed=10 + i)
        jparams, jstate, jinfo = jopt.adamw_update(
            jparams, jax.tree.map(jnp.asarray, g), jstate)
        params, state, info = opt.adamw_update(
            params, params_from_jax(g, device="cpu"), state)
        np.testing.assert_allclose(float(info["grad_norm"]), float(jinfo["grad_norm"]),
                                   rtol=1e-6)
    atol = BF16_M_ATOL if factored and n_steps > 1 else 1e-7
    _assert_trees_close(params_to_numpy(params), jparams, "params", atol=atol)
    _assert_trees_close(params_to_numpy(state),
                        {"step": jstate.step, "moments": jstate.moments}, "state")


def test_factoring_across_layers_raises(monkeypatch):
    """A 1-D per-layer leaf whose stack exceeds the threshold would be
    factored across layers by the reference: the port refuses."""
    _, cfg = _configs("qwen2_7b")
    params = params_from_jax(_tree(_configs("qwen2_7b")[0]), device="cpu")
    monkeypatch.setattr(opt, "FACTOR_THRESHOLD", 2 * cfg.d_model - 1)
    with pytest.raises(ValueError, match="across"):
        opt.adamw_init(params)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """Three `build_train_step` steps (impl "torch", remat) against the
    reference's (impl "xla", remat), jitted, on the reference's weights and
    three numpy batches: loss and grad_norm every step, then the params."""
    jcfg, cfg = _configs(arch)
    tree = _tree(jcfg)
    params = params_from_jax(tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate, state = jopt.adamw_init(jparams), opt.adamw_init(params)
    jstep = jax.jit(jsteps.build_train_step(jcfg, remat=True))
    step = steps.build_train_step(cfg)
    rng = np.random.default_rng(7)
    for i in range(3):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
        if cfg.family in ("vlm", "audio"):
            b["embeds" if cfg.family == "vlm" else "frames"] = rng.standard_normal(
                (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        b["labels"] = np.pad(b["tokens"][:, 1:], ((0, 0), (0, 1)), constant_values=-1)
        jparams, jstate, jinfo = jstep(jparams, jstate,
                                       {k: jnp.asarray(v) for k, v in b.items()})
        params, state, info = step(params, state, {
            k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in b.items()})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(info[key]), float(jinfo[key]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    _assert_params_close(params_to_numpy(params), jparams, n_steps=3)


def _assert_params_close(got, want, n_steps, lr=3e-4):
    """Params after `n_steps` AdamW steps from equal weights on gradients
    equal to ~1e-6: within rtol 1e-4, atol 1e-5, but for at most 1e-4 of a
    leaf's elements (one at least), each within 2 x lr x n_steps.  Where a
    gradient is ~0 (a near cancellation), its rounding decides the sign
    of m̂ / sqrt(v̂) ~ ±1, and so an update of ±lr."""
    for (path, w), g in zip(_leaves_with_path(want), jax.tree.leaves(got)):
        w = np.asarray(w)
        what = jax.tree_util.keystr(path)
        off = ~np.isclose(g, w, rtol=1e-4, atol=1e-5)
        assert off.sum() <= max(1, w.size // 10_000), (what, int(off.sum()))
        assert np.abs(g - w).max() <= 2 * lr * n_steps, what


def _one_step(jcfg, tree):
    """Params and a state after one reference AdamW step (nonzero moments)."""
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams, jstate, _ = jopt.adamw_update(
        jparams, jax.tree.map(jnp.asarray, _random_like(tree, 3)),
        jopt.adamw_init(jparams))
    return jparams, jstate


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_port_to_reference(arch, tmp_path):
    """The port writes; the reference's load_checkpoint + restore_like read
    the reference's own trees back, leaf for leaf."""
    jcfg, _ = _configs(arch)
    jparams, jstate = _one_step(jcfg, _tree(jcfg))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    state = opt.adamw_init(params)
    state = ckpt.restore_like(state, {**{"step": np.asarray(jstate.step)}, **{
        "moments/" + k: v for k, v in ckpt._flatten(
            jax.tree.map(np.asarray, jstate.moments)).items()}})
    ckpt.save_checkpoint(str(tmp_path), params, state, step=5)
    pflat, oflat, s = jckpt.load_checkpoint(str(tmp_path))
    assert s == 5
    assert set(pflat) == set(jckpt._flatten(jparams))
    assert set(oflat) == set(jckpt._flatten(jstate))
    rp = jckpt.restore_like(jparams, pflat)
    ro = jckpt.restore_like(jstate, oflat)
    for a, b in zip(jax.tree.leaves((rp, ro)), jax.tree.leaves((jparams, jstate))):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_reference_to_port(arch, tmp_path):
    """The reference writes; the port's load_checkpoint + restore_like
    rebuild its per-layer trees equal to the bridged reference's."""
    jcfg, cfg = _configs(arch)
    jparams, jstate = _one_step(jcfg, _tree(jcfg))
    jckpt.save_checkpoint(str(tmp_path), jparams, jstate, step=9)
    pflat, oflat, s = ckpt.load_checkpoint(str(tmp_path))
    assert s == 9
    want = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    got = ckpt.restore_like(want, pflat)
    assert ckpt.params_equal(got, want)
    state = ckpt.restore_like(opt.adamw_init(want), oflat)
    assert int(state.step) == 1
    _assert_trees_close(params_to_numpy(state),
                        {"step": jstate.step, "moments": jstate.moments},
                        "state", rtol=0, atol=0)


def test_checkpoint_bf16_leaves_byte_equal(tmp_path, monkeypatch):
    """A bf16 model and a factored (bf16) first moment: every array the
    port writes equals the reference's for the same values, dtype (|V2)
    and bytes, and the port reads the reference's file back bit for bit."""
    jcfg, cfg = _configs("qwen2_7b", dtype="bfloat16")
    tree = _tree(jcfg)
    monkeypatch.setattr(jopt, "FACTOR_THRESHOLD", 100_000)
    monkeypatch.setattr(opt, "FACTOR_THRESHOLD", 100_000)
    jparams, jstate = _one_step(jcfg, tree)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    state = ckpt.restore_like(opt.adamw_init(params), {
        "step": np.asarray(jstate.step), **{
            "moments/" + k: v for k, v in ckpt._flatten(
                jax.tree.map(np.asarray, jstate.moments)).items()}})
    jckpt.save_checkpoint(str(tmp_path / "ref"), jparams, jstate, step=1)
    ckpt.save_checkpoint(str(tmp_path / "port"), params, state, step=1)
    ref, port = jckpt.load_checkpoint(str(tmp_path / "ref")), ckpt.load_checkpoint(
        str(tmp_path / "port"))
    n_bf16 = 0
    for r, p in zip(ref[:2], port[:2]):
        assert set(r) == set(p)
        for k in r:
            assert r[k].dtype == p[k].dtype and r[k].tobytes() == p[k].tobytes(), k
            n_bf16 += r[k].dtype == np.dtype("V2")
    assert n_bf16 > 0
    assert ckpt.params_equal(ckpt.restore_like(params, ref[0]), params)


def test_synthetic_data_matches_reference():
    a = data.SyntheticLMData(vocab=300, seq=24, batch=3, seed=5)
    b = jdata.SyntheticLMData(vocab=300, seq=24, batch=3, seed=5)
    for _ in range(4):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])


def test_train_lm_loop_lowers_loss_and_round_trips(tmp_path):
    """train_lm's loop on a small dense model and its Markov data: the mean
    of the last 10 losses ends MIN_DROP below the first, as the reference's
    example asserts at ~100M parameters; the checkpoint reloads equal."""
    cfg = ModelConfig(name="lm-tiny", family="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                      dtype="float32")
    r = train_lm.train(cfg, steps=60, batch=8, seq=32, device="cpu",
                       log=lambda *a: None)
    losses = r["losses"]
    assert np.mean(losses[-10:]) < losses[0] - train_lm.MIN_DROP
    ckpt.save_checkpoint(str(tmp_path), r["params"], r["opt"], step=60)
    p2, o2, s2 = ckpt.load_checkpoint(str(tmp_path))
    assert s2 == 60
    assert ckpt.params_equal(ckpt.restore_like(r["params"], p2), r["params"])
    assert ckpt.params_equal(ckpt.restore_like(r["opt"], o2), r["opt"])
    assert not any(t.requires_grad for t in param_leaves(r["params"]))


@pytest.mark.parametrize("arch", ["internvl2_76b", "seamless_m4t_large_v2"])
def test_train_cli_on_cpu(arch, capsys):
    """launch/train.py on the CPU: the reduced f32 config at 3 layers
    (printed), the reference's batches (vlm patch embeddings, audio frames,
    labels padded with -1), finite losses and gradient norms."""
    out = train.main(["--arch", arch, "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--layers", "3"])
    assert out["layers"] == 3 and out["dtype"] == "float32"
    assert np.isfinite(out["losses"] + out["grad_norms"]).all()
    assert out["mfu"] is None and out["peak_gb"] is None     # not measured on the CPU
    assert "steps in" in capsys.readouterr().out
    b = train.make_batch(get_config(arch), 2, 16, np.random.default_rng(0), "cpu")
    assert b["labels"][:, -1].tolist() == [-1, -1]
    assert (b["labels"][:, :-1] == b["tokens"][:, 1:]).all()
