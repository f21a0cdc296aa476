"""The port's training path against the JAX reference, on the same weights
(bridged from `repro.models.init_params`) and the same numpy batch, one
reduced f32 config per family; the reference runs its train impl "xla".

- `loss_fn` equals the reference's to 1e-5 relative, with remat on and off;
- its gradients (`launch.steps.loss_and_grads`, through `params_to_numpy`)
  equal `jax.grad`'s to rtol 1e-4, atol 1e-5;
- the hand-kernel wrappers under autograd: `ops.*(impl="auto")` raises on
  the CPU as on the card (the kernels have no backward), `impl="torch"`
  differentiates;
- `torch_attention`'s gradient equals the naive oracle's and the
  reference's `xla_attention`'s (2e-4), with and without its per-q-block
  checkpoint (the counterpart of tests/test_kernels.py's gradient test).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.kernels import ops as jops
from repro.models import model as jmdl
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import _q_column, torch_attention
from repro_torch.launch import steps
from repro_torch.models import model as mdl

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

#: one reduced config per family (qwen2: the dense family with qkv biases)
ARCHS = ["qwen2_7b", "olmoe_1b_7b", "mamba2_130m", "zamba2_2_7b",
         "seamless_m4t_large_v2", "internvl2_76b"]


def train_batch(cfg, batch=2, seq=16, seed=0):
    """numpy tokens (batch, seq) [+ vlm embeds / audio frames]."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.family in ("vlm", "audio"):
        out["embeds" if cfg.family == "vlm" else "frames"] = rng.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """(jcfg, cfg, reference params (numpy), numpy batch, the reference's
    loss and gradients)."""
    arch = request.param
    jcfg = dataclasses.replace(j_reduced_config(j_get_config(arch)), dtype="float32")
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = jax.tree.map(np.asarray, jmdl.init_params(jax.random.PRNGKey(0), jcfg))
    batch = train_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jmdl.loss_fn(jcfg, p, jb, impl="xla"), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    return dict(jcfg=jcfg, cfg=cfg, tree=tree, batch=batch, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_matches_jax(case, remat):
    cfg = case["cfg"]
    params = params_from_jax(case["tree"], device="cpu")
    with torch.no_grad():
        loss, aux = mdl.loss_fn(cfg, params, to_torch(case["batch"]), impl="torch",
                                remat=remat)
    assert abs(float(loss) - case["loss"]) <= 1e-5 * abs(case["loss"])
    assert float(aux["ce_loss"]) == float(loss)
    if cfg.family == "moe":
        assert "lb_loss" in aux


def test_grads_match_jax(case):
    params = params_from_jax(case["tree"], device="cpu")
    loss, grads = steps.loss_and_grads(case["cfg"], params, to_torch(case["batch"]))
    assert abs(float(loss) - case["loss"]) <= 1e-5 * abs(case["loss"])
    got = params_to_numpy(grads)
    flat, _ = jax.tree_util.tree_flatten_with_path(case["grads"])
    assert jax.tree.structure(got) == jax.tree.structure(case["grads"])
    for path, want in flat:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
    # the step leaves the parameters plain tensors again
    assert not any(t.requires_grad for t in mdl.param_leaves(params))


def test_loss_chunks_and_labels():
    """The loss over chunks of the largest divisor of S at or below
    loss_chunk equals the loss in one chunk; labels -1 are left out."""
    cfg = dataclasses.replace(reduced_config(get_config("llama3_8b")), dtype="float32")
    params = mdl.init_params(cfg, seed=1, device="cpu")
    b = to_torch(train_batch(cfg, seq=24, seed=3))
    with torch.no_grad():
        whole, _ = mdl.loss_fn(cfg, params, b, loss_chunk=24)
        for ck in (7, 8, 5):                      # divisors 6, 8, 4
            part, _ = mdl.loss_fn(cfg, params, b, loss_chunk=ck)
            torch.testing.assert_close(part, whole, rtol=1e-6, atol=1e-6)
        labels = torch.nn.functional.pad(b["tokens"][:, 1:], (0, 1), value=-1)
        labels[:, :10] = -1
        masked, _ = mdl.loss_fn(cfg, params, dict(b, labels=labels))
        logits, _ = mdl.forward(cfg, params, b)
        logp = torch.log_softmax(logits.float(), -1)[:, 10:-1]
        want = -torch.gather(logp, -1, labels[:, 10:-1, None]).mean()
    torch.testing.assert_close(masked, want, rtol=1e-6, atol=1e-6)


def _attention_inputs(requires_grad=True):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4, 16, 8), generator=g),
               torch.randn((1, 2, 16, 8), generator=g),
               torch.randn((1, 2, 16, 8), generator=g))
    return [t.requires_grad_(requires_grad) for t in (q, k, v)]


@pytest.mark.parametrize("call", ["attention", "decode_attention", "ssd_scan"])
def test_auto_kernels_refuse_autograd(call):
    """impl="auto" under autograd raises before the device dispatch (so the
    CPU refuses what the card would); impl="torch" gives gradients; under
    no_grad "auto" runs."""
    q, k, v = _attention_inputs()
    g = torch.Generator().manual_seed(1)
    x, B, C = (torch.randn((1, 12, 2, 16), generator=g),
               torch.randn((1, 12, 16), generator=g),
               torch.randn((1, 12, 16), generator=g))
    dt = torch.rand((1, 12, 2), generator=g).requires_grad_()
    A, D = -torch.rand(2, generator=g), torch.ones(2)
    x.requires_grad_()
    fns = {"attention": lambda impl: ops.attention(q, k, v, impl=impl),
           "decode_attention": lambda impl: ops.decode_attention(
               q[:, :, 0], k, v, torch.tensor([9]), impl=impl),
           "ssd_scan": lambda impl: ops.ssd_scan(x, dt, A, B, C, D, chunk=8,
                                                 impl=impl)}
    with pytest.raises(RuntimeError, match='impl="torch"'):
        fns[call]("auto")
    out = fns[call]("torch")
    wrt = (x, dt) if call == "ssd_scan" else (q, k, v)
    grads = torch.autograd.grad(out.square().sum(), wrt)
    assert all(gr is not None and torch.isfinite(gr).all() and gr.abs().sum() > 0
               for gr in grads)
    with torch.no_grad():
        torch.testing.assert_close(fns[call]("auto"), out.detach())


@pytest.mark.parametrize("q_block", [8, 4])
def test_attention_gradient_matches_oracle_and_jax(q_block):
    """Causal GQA attention over 16 positions in q-block columns of 8 or 4
    (each column checkpointed, kv blocks of 8): the gradient wrt q, k and v
    of the plain version equals the naive oracle's and the reference's
    xla_attention's (2e-4), as tests/test_kernels.py holds the reference's
    own."""
    q, k, v = _attention_inputs()
    w = torch.randn((1, 4, 16, 8), generator=torch.Generator().manual_seed(2))

    def loss(fn, *a):
        return (fn(*a) * w).sum()
    got = torch.autograd.grad(loss(lambda *a: torch_attention(
        *a, causal=True, q_block=q_block, kv_block=8), q, k, v), (q, k, v))
    oracle = torch.autograd.grad(loss(lambda *a: tref.mha_reference(*a, causal=True),
                                      q, k, v), (q, k, v))
    jw = jnp.asarray(w.numpy())
    jgot = jax.grad(lambda *a: (jops.xla_attention(*a, causal=True, q_block=q_block,
                                                   kv_block=8) * jw).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(t.detach().numpy())
                                         for t in (q, k, v)))
    for name, g, o, j in zip("qkv", got, oracle, jgot):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name} vs the oracle")
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=2e-4, rtol=2e-4,
                                   err_msg=f"d{name} vs xla_attention")


def test_attention_checkpoint_recomputes_columns():
    """With the checkpoint, the forward keeps no (q_block, kv_block) tile:
    what a 4 x 4-column call saves for the backward is its inputs (each
    tensor counted once), under a quarter of what the same columns save
    when `_q_column` runs them without one."""
    q, k, v = _attention_inputs()
    scale = q.shape[-1] ** -0.5
    kf, vf = (t.repeat_interleave(q.shape[1] // t.shape[1], 1) for t in (k, v))
    eff_len = torch.full((q.shape[0],), k.shape[2])

    def plain_columns():
        for q0 in range(0, q.shape[2], 4):
            _q_column(q[:, :, q0:q0 + 4], kf, vf, eff_len, q0, causal=True,
                      sliding_window=0, q_offset=0, kv_block=4, scale=scale)
    counts = {}
    for name, run in (("checkpointed", lambda: torch_attention(q, k, v, q_block=4,
                                                               kv_block=4)),
                      ("plain", plain_columns)):
        saved = {}
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.setdefault((t.data_ptr(), t.numel()), t.numel()) and t,
                lambda t: t):
            run()
        counts[name] = sum(saved.values())
    assert counts["checkpointed"] < counts["plain"] / 4
