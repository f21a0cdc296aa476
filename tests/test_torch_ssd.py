"""Port SSD scan vs the JAX reference: the port's chunked plain version
("torch") and sequential oracle ("ref") against the reference's Pallas
kernel B3 (in interpret mode, as tests/test_kernels.py runs it) and its
sequential oracle, on the same numpy inputs, at the (chunk, seq) cases of
tests/test_kernels.py.  f32 throughout.  Tolerances: 1e-4 between two
versions of the same algorithm (chunked against chunked, sequential against
sequential: f32 sums in another order), 2e-3 across the two algorithms, as
the reference's own test holds its kernel to its oracle.

The hand CUDA kernel runs only on the card: tests/test_torch_cuda.py holds
it to `torch_ssd_scan` there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_kernel import ssd_scan_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_kernel import ssd_scan, torch_ssd_scan

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

SAME = dict(atol=1e-4, rtol=1e-4)
CROSS = dict(atol=2e-3, rtol=2e-3)
CASES = [(16, 64), (32, 96), (32, 70), (8, 8)]       # (chunk, seq)


def _inputs(seq, seed, b=2, nh=4, hd=8, ns=16):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32)
    x = t(b, seq, nh, hd)
    dt = np.logaddexp(t(b, seq, nh), 0).astype(np.float32)     # softplus
    A = -np.exp(t(nh))
    B, C, D = t(b, seq, ns), t(b, seq, ns), t(nh)
    h0 = t(b, nh, hd, ns) * 0.1
    return (x, dt, A, B, C, D), h0


@functools.lru_cache(maxsize=None)
def _case(chunk, seq):
    """Inputs (numpy) and the JAX outputs (y, final state) of the Pallas
    kernel and of the sequential oracle."""
    args, h0 = _inputs(seq, seed=chunk * 1000 + seq)
    jargs = [jnp.asarray(a) for a in args]
    want = {
        "pallas": ssd_scan_pallas(*jargs, chunk=chunk, init_state=jnp.asarray(h0),
                                  return_state=True, interpret=True),
        "sequential": jref.ssd_reference(*jargs, init_state=jnp.asarray(h0),
                                         return_state=True),
    }
    return args, h0, {k: tuple(np.asarray(a) for a in v) for k, v in want.items()}


@pytest.mark.parametrize("impl", ["torch", "ref"])
@pytest.mark.parametrize("chunk,seq", CASES)
def test_ssd_scan_matches_jax(chunk, seq, impl):
    args, h0, want = _case(chunk, seq)
    y, h = ops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk,
                        init_state=torch.from_numpy(h0), return_state=True,
                        impl=impl)
    same = "pallas" if impl == "torch" else "sequential"
    for name, (wy, wh) in want.items():
        tol = SAME if name == same else CROSS
        np.testing.assert_allclose(y.numpy(), wy, err_msg=name, **tol)
        np.testing.assert_allclose(h.numpy(), wh, err_msg=name, **tol)


def test_chunked_plain_matches_xla_without_state():
    """No init_state, y only: the twin of the reference's chunked XLA path."""
    args, _ = _inputs(64, seed=5)
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jops.ssd_scan(*jargs, chunk=16, impl="xla"))
    got = torch_ssd_scan(*map(torch.from_numpy, args), chunk=16)
    np.testing.assert_allclose(got.numpy(), want, **SAME)


def test_ssd_step_chain_equals_scan():
    """The decode step chained over s equals the scan (serving invariant),
    and each step equals the reference's step."""
    (x, dt, A, B, C, D), h0 = _inputs(12, seed=9)
    tx, tdt, tA, tB, tC, tD = map(torch.from_numpy, (x, dt, A, B, C, D))
    want_y, want_h = torch_ssd_scan(tx, tdt, tA, tB, tC, tD, chunk=8,
                                    init_state=torch.from_numpy(h0),
                                    return_state=True)
    state, jstate = torch.from_numpy(h0), jnp.asarray(h0)
    for i in range(x.shape[1]):
        y, state = ops.ssd_step(tx[:, i], tdt[:, i], tA, tB[:, i], tC[:, i],
                                tD, state)
        jy, jstate = jops.ssd_step(jnp.asarray(x[:, i]), jnp.asarray(dt[:, i]),
                                   jnp.asarray(A), jnp.asarray(B[:, i]),
                                   jnp.asarray(C[:, i]), jnp.asarray(D), jstate)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SAME)
        np.testing.assert_allclose(y.numpy(), want_y[:, i].numpy(), **CROSS)
    np.testing.assert_allclose(state.numpy(), want_h.numpy(), **CROSS)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **SAME)


def test_auto_takes_plain_version_for_cpu_tensors():
    args, h0 = _inputs(40, seed=3)
    targs = list(map(torch.from_numpy, args))
    before = ssd_scan.launches
    got = ops.ssd_scan(*targs, chunk=16, init_state=torch.from_numpy(h0),
                       return_state=True)
    want = torch_ssd_scan(*targs, chunk=16, init_state=torch.from_numpy(h0),
                          return_state=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ssd_scan.launches == before
    with pytest.raises(ValueError):
        ops.ssd_scan(*targs, impl="pallas")


def _meta_args(b=2, s=100, nh=4, hd=64, ns=64, dtype=torch.bfloat16):
    """Operands shaped as the model passes them: x, B and C are strided
    views of one conv output (meta tensors: shapes and strides, no data)."""
    xbc = torch.empty((b, s, nh * hd + 2 * ns), dtype=dtype, device="meta")
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    f32 = dict(dtype=torch.float32, device="meta")
    return dict(x=x, dt=torch.empty((b, s, nh), **f32),
                A=torch.empty((nh,), **f32), B=xbc[..., nh * hd:nh * hd + ns],
                C=xbc[..., nh * hd + ns:], D=torch.empty((nh,), **f32))


def _bad(kind):
    a = _meta_args()
    if kind == "dtype":
        a = _meta_args(dtype=torch.float16)
    elif kind == "head_dim":
        a = _meta_args(hd=40)
    elif kind == "state":
        a = _meta_args(ns=48)
    elif kind == "dt_dtype":
        a["dt"] = a["dt"].to(torch.bfloat16)
    elif kind == "B_dtype":
        a["B"] = a["B"].float()
    elif kind == "C_shape":
        a["C"] = a["C"][:, :-1]
    elif kind == "x_stride":
        a["x"] = a["x"].transpose(2, 3)
    elif kind == "B_stride":
        a["B"] = torch.empty((2, 100, 68), dtype=torch.bfloat16,
                             device="meta")[..., :64]        # row stride 68
    elif kind == "A_strided":
        a["A"] = torch.empty((8,), dtype=torch.float32, device="meta")[::2]
    elif kind == "init_state":
        a["init_state"] = torch.empty((2, 4, 64, 32), dtype=torch.float32,
                                      device="meta")
    return a


@pytest.mark.parametrize("kind", ["device", "dtype", "head_dim", "state",
                                  "dt_dtype", "B_dtype", "C_shape", "x_stride",
                                  "B_stride", "A_strided", "init_state"])
def test_wrapper_refuses_what_the_kernel_cannot_take(kind):
    """A tensor off the CPU goes to the kernel or raises: here meta tensors,
    which the wrapper refuses before any build or launch, each malformed one
    for its own fault and the well-formed one because it is not on a CUDA
    device."""
    a = _bad(kind)
    before = ssd_scan.launches
    with pytest.raises((ValueError, TypeError)) as err:
        ssd_scan(a.pop("x"), a.pop("dt"), a.pop("A"), a.pop("B"), a.pop("C"),
                 a.pop("D"), chunk=64, **a)
    assert ("CUDA device" in str(err.value)) == (kind == "device"), err.value
    assert ssd_scan.launches == before
