"""The port's sequence parallelism (`repro_torch.sp`) against the reference.

The port's mesh is single-controller: eight ranks on the CPU
(``["cpu"] * 8``), the twin of the reference's eight forced XLA host
devices.  The reference's own SP functions need those eight devices, which
this process must not force (tests keep seeing one device), so they run
once per module in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (this file run as a
script, as tests/test_sp.py replays its multidevice module), which writes
their outputs on the same seeded inputs to an .npz.  Held here:

* `GangMesh` collectives (ppermute, tiled all_to_all and all_gather, psum,
  pmax over one axis and over a tuple of axes) equal ``jax.lax``'s under
  ``shard_map`` on a (4, 2) mesh, exactly (they only move and add data);
* `merge_partials` / `finalize` against ``repro.sp.common`` (2e-6);
* twins of every case of tests/multidevice/test_sp_kernels.py: the ring,
  the hybrid x {a2a, allgather} x window {0, 24}, the three-axis
  multi-pod ring, MQA x both strategies, distributed decode x window
  {0, 16}, each to TOL = 2e-5 against the naive oracle (as there) and
  against the reference's own SP function on the same inputs.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.sp import common as jcommon
from repro_torch.sp import (GangMesh, a2a_attention, allgather_attention,
                            distributed_decode_attention, fast_sp_attention,
                            finalize, merge_partials, ring_attention_local)

# one intra-op thread: the suite runs several test workers on a few cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TOL = 2e-5
B, H, KV, S, D = 2, 4, 2, 64, 16

#: name -> (mesh shape, axis names, kwargs of fast_sp_attention)
HYBRID = {
    **{f"hybrid_{st}_w{w}": ((4, 2), ("data", "model"),
                             dict(strategy=st, sliding_window=w))
       for st in ("a2a", "allgather") for w in (0, 24)},
    "multipod": ((2, 2, 2), ("pod", "data", "model"),
                 dict(strategy="a2a", outer_axes=("pod", "data"))),
    **{f"mqa_{st}": ((4, 2), ("data", "model"), dict(strategy=st))
       for st in ("a2a", "allgather")},
}

#: name -> (axes, collective, kwargs) on a (4, 2) ("data", "model") mesh over
#: a (8, 8, 8) array sharded on its first axis across both mesh axes
COLLECTIVES = {
    "ppermute_data": ("data", "ppermute", {}),
    "ppermute_model": ("model", "ppermute", {}),
    "ppermute_both": (("data", "model"), "ppermute", {}),
    "all_to_all_data": ("data", "all_to_all", dict(split_axis=1, concat_axis=2)),
    "all_to_all_model": ("model", "all_to_all", dict(split_axis=2, concat_axis=1)),
    "all_gather_data": ("data", "all_gather", dict(axis=1)),
    "all_gather_both": (("data", "model"), "all_gather", dict(axis=2)),
    "psum_data": ("data", "psum", {}),
    "psum_model": ("model", "psum", {}),
    "pmax_both": (("data", "model"), "pmax", {}),
}


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _inputs():
    """Every case's inputs, from the seeds test_sp_kernels.py uses."""
    rng = np.random.default_rng(3)
    q, k, v = _normal(rng, B, H, S, D), _normal(rng, B, KV, S, D), \
        _normal(rng, B, KV, S, D)
    rng = np.random.default_rng(5)
    mq, mk, mv = _normal(rng, B, 8, S, D), _normal(rng, B, 1, S, D), \
        _normal(rng, B, 1, S, D)
    rng = np.random.default_rng(7)
    dq, dk, dv = _normal(rng, 3, H, D), _normal(rng, 3, KV, S, D), \
        _normal(rng, 3, KV, S, D)
    return dict(q=q, k=k, v=v, mq=mq, mk=mk, mv=mv, dq=dq, dk=dk, dv=dv,
                cl=np.asarray([10, 40, 64], np.int32),
                x=_normal(np.random.default_rng(11), 8, 8, 8))


def _qkv(inp, name):
    return ((inp["mq"], inp["mk"], inp["mv"]) if name.startswith("mqa")
            else (inp["q"], inp["k"], inp["v"]))


def _jax_outputs(path):
    """The reference's SP functions on `_inputs()`; needs 8 XLA devices."""
    import functools

    from jax.sharding import PartitionSpec as P

    from repro.sp import (distributed_decode_attention as jdecode,
                          fast_sp_attention as jfast,
                          ring_attention_local as jring)
    assert jax.device_count() >= 8, jax.device_count()
    inp = _inputs()
    out = {}
    mesh = jax.make_mesh((8,), ("data",))
    fn = functools.partial(jring, axis_name="data", causal=True)
    out["ring"] = jax.jit(jcommon.shard_map(
        fn, mesh=mesh, in_specs=(P(None, None, "data", None),) * 3,
        out_specs=P(None, None, "data", None), check_vma=False))(
            inp["q"], inp["k"], inp["v"])
    for name, (shape, axes, kw) in HYBRID.items():
        out[name] = jfast(*_qkv(inp, name), mesh=jax.make_mesh(shape, axes),
                          causal=True, **kw)
    for w in (0, 16):
        out[f"decode_w{w}"] = jdecode(inp["dq"], inp["dk"], inp["dv"],
                                      inp["cl"], mesh=mesh, seq_axes=("data",),
                                      sliding_window=w)
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    lax = {"ppermute": lambda x, axes: jax.lax.ppermute(
               x, axes, [(i, (i + 1) % _size(axes)) for i in range(_size(axes))]),
           "all_to_all": lambda x, axes, **kw: jax.lax.all_to_all(
               x, axes, tiled=True, **kw),
           "all_gather": lambda x, axes, axis: jax.lax.all_gather(
               x, axes, axis=axis, tiled=True),
           "psum": lambda x, axes: jax.lax.psum(x, axes),
           "pmax": lambda x, axes: jax.lax.pmax(x, axes)}
    spec = P(("data", "model"))
    for name, (axes, op, kw) in COLLECTIVES.items():
        fn = functools.partial(lax[op], axes=axes, **kw)
        out[name] = jcommon.shard_map(fn, mesh=mesh, in_specs=(spec,),
                                      out_specs=spec, check_vma=False)(inp["x"])
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _size(axes):
    return {"data": 4, "model": 2}[axes] if isinstance(axes, str) else 8


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("sp") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, __file__, str(path)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def inp():
    return _inputs()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- GangMesh ---------------------------------------------------------------
@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_mesh_collectives_match_lax(jax_out, inp, name):
    axes, op, kw = COLLECTIVES[name]
    mesh = GangMesh(["cpu"] * 8, (4, 2), ("data", "model"))
    xs = mesh.shard(_t(inp["x"]), 0, ("data", "model"))
    got = torch.cat(getattr(mesh, op)(xs, axes, **kw), 0)
    np.testing.assert_array_equal(got.numpy(), jax_out[name])


def test_mesh_ranks_and_groups():
    mesh = GangMesh(["cpu"] * 8, (2, 2, 2), ("pod", "data", "model"))
    assert mesh.n_ranks == 8 and mesh.axis_size(("pod", "data")) == 4
    assert [mesh.axis_index(r, ("pod", "data")) for r in range(8)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert mesh.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups(("pod", "model")) == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert mesh.axis_size(None) == 1 and mesh.groups(None)[3] == [3]
    with pytest.raises(ValueError, match="do not fill"):
        GangMesh(["cpu"] * 6, (4, 2), ("data", "model"))


# ---- LSE merge ------------------------------------------------------------
def test_merge_partials_and_finalize_match_reference():
    rng = np.random.default_rng(0)
    o1, o2 = _normal(rng, 2, 3, 5, 4), _normal(rng, 2, 3, 5, 4)
    l1, l2 = _normal(rng, 2, 3, 5), _normal(rng, 2, 3, 5)
    l1[0, 0] = -np.inf                     # one side empty
    l2[1, 2] = -np.inf
    l1[1, 1, :2] = l2[1, 1, :2] = -np.inf  # both empty: stays empty, zeroed
    jo, jl = jcommon.merge_partials(o1, l1, o2, l2)
    to, tl = merge_partials(_t(o1), _t(l1), _t(o2), _t(l2))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-6, atol=2e-6)
    # a row empty on both sides: XLA flushes the subnormal 1e-38 floor of
    # the denominator to 0 and gives NaN there, torch keeps it and gives 0;
    # finalize zeroes the row either way
    live = np.isfinite(np.asarray(jl))
    np.testing.assert_allclose(to.numpy()[live], np.asarray(jo)[live],
                               rtol=2e-6, atol=2e-6)
    assert np.isneginf(tl[1, 1, :2].numpy()).all()
    assert (to[1, 1, :2] == 0).all()
    np.testing.assert_allclose(finalize(to, tl, torch.float32).numpy(),
                               np.asarray(jcommon.finalize(jo, jl, jnp.float32)),
                               rtol=2e-6, atol=2e-6)
    # identity: merging with an empty partial gives the other back exactly
    eo, el = merge_partials(_t(o1), torch.zeros(l2.shape), torch.zeros(o1.shape),
                            torch.full(l2.shape, float("-inf")))
    np.testing.assert_array_equal(eo.numpy(), o1)


# ---- twins of tests/multidevice/test_sp_kernels.py -------------------------
def _close(got, want, tol=TOL):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want)).max())
    assert err < tol, err


def test_ring_attention_matches_reference(jax_out, inp):
    q, k, v = (_t(inp[n]) for n in "qkv")
    mesh = GangMesh(["cpu"] * 8, (8,), ("data",))
    out = ring_attention_local(*(mesh.shard(t, 2, "data") for t in (q, k, v)),
                               mesh=mesh, axis_name="data", causal=True)
    got = mesh.unshard(out, 2, "data").numpy()
    _close(got, jref.mha_reference(inp["q"], inp["k"], inp["v"], causal=True))
    _close(got, jax_out["ring"])


@pytest.mark.parametrize("strategy", ["a2a", "allgather"])
@pytest.mark.parametrize("window", [0, 24])
def test_hybrid_fast_sp_matches_reference(jax_out, inp, strategy, window):
    name = f"hybrid_{strategy}_w{window}"
    shape, axes, kw = HYBRID[name]
    got = fast_sp_attention(*(_t(inp[n]) for n in "qkv"),
                            mesh=GangMesh(["cpu"] * 8, shape, axes),
                            causal=True, **kw).numpy()
    _close(got, jref.mha_reference(inp["q"], inp["k"], inp["v"], causal=True,
                                   sliding_window=window))
    _close(got, jax_out[name])


def test_multipod_three_axis_ring(jax_out, inp):
    shape, axes, kw = HYBRID["multipod"]
    got = fast_sp_attention(*(_t(inp[n]) for n in "qkv"),
                            mesh=GangMesh(["cpu"] * 8, shape, axes),
                            causal=True, **kw).numpy()
    _close(got, jref.mha_reference(inp["q"], inp["k"], inp["v"], causal=True))
    _close(got, jax_out["multipod"])


@pytest.mark.parametrize("strategy", ["a2a", "allgather"])
def test_mqa_kv_heads_not_divisible_by_axis(jax_out, inp, strategy):
    """MQA: 1 KV head on a 2-wide inner axis exercises the replicate-KV
    corner of both strategies."""
    name = f"mqa_{strategy}"
    shape, axes, kw = HYBRID[name]
    got = fast_sp_attention(*(_t(a) for a in _qkv(inp, name)),
                            mesh=GangMesh(["cpu"] * 8, shape, axes),
                            causal=True, **kw).numpy()
    _close(got, jref.mha_reference(*_qkv(inp, name), causal=True))
    _close(got, jax_out[name])


@pytest.mark.parametrize("window", [0, 16])
def test_distributed_decode_matches_reference(jax_out, inp, window):
    got = distributed_decode_attention(
        _t(inp["dq"]), _t(inp["dk"]), _t(inp["dv"]), _t(inp["cl"]),
        mesh=GangMesh(["cpu"] * 8, (8,), ("data",)), seq_axes=("data",),
        sliding_window=window).numpy()
    _close(got, jref.decode_attention_reference(
        inp["dq"], inp["dk"], inp["dv"], inp["cl"], sliding_window=window))
    _close(got, jax_out[f"decode_w{window}"])


# ---- the port's own corners ------------------------------------------------
@pytest.mark.parametrize("fn", [a2a_attention, allgather_attention])
def test_inner_strategy_alone_matches_oracle(inp, fn):
    """The inner layouts without a ring, over a 2-wide axis, with the LSE
    (returned head-complete in sequence shards)."""
    q, k, v = (_t(inp[n]) for n in "qkv")
    mesh = GangMesh(["cpu"] * 2, (2,), ("model",))
    o, lse = fn(*(mesh.shard(t, 2, "model") for t in (q, k, v)), mesh=mesh,
                axis_name="model", causal=True, return_lse=True)
    _close(mesh.unshard(o, 2, "model").numpy(),
           jref.mha_reference(inp["q"], inp["k"], inp["v"], causal=True))
    _, want_lse = jops.xla_attention(inp["q"], inp["k"], inp["v"], causal=True,
                                     return_lse=True)
    _close(mesh.unshard(lse, 2, "model").numpy(), want_lse)


def test_distributed_decode_with_batch_axes(inp):
    """The cache sharded on batch over "model" and on sequence over "data"
    (the reference's `batch_axes`), against the oracle."""
    dq = np.concatenate([inp["dq"], inp["dq"][:1]])
    dk = np.concatenate([inp["dk"], inp["dk"][:1]])
    dv = np.concatenate([inp["dv"], inp["dv"][:1]])
    cl = np.asarray([10, 40, 64, 33], np.int32)
    got = distributed_decode_attention(
        _t(dq), _t(dk), _t(dv), _t(cl),
        mesh=GangMesh(["cpu"] * 8, (4, 2), ("data", "model")),
        seq_axes=("data",), batch_axes=("model",)).numpy()
    _close(got, jref.decode_attention_reference(dq, dk, dv, cl))


if __name__ == "__main__":
    _jax_outputs(sys.argv[1])
