"""Port SSD scan vs the JAX reference: the port's chunked plain version
("torch") and sequential oracle ("ref") against the reference's Pallas
kernel B3 (in interpret mode, as tests/test_kernels.py runs it) and its
sequential oracle, on the same numpy inputs, at the (chunk, seq) cases of
tests/test_kernels.py.  f32 throughout.  Tolerances: 1e-4 between two
versions of the same algorithm (chunked against chunked, sequential against
sequential: f32 sums in another order), 2e-3 across the two algorithms, as
the reference's own test holds its kernel to its oracle.

`split_ssd`, the bf16 tensor-core kernels' passes in plain f32 at their
own chunk L, is held to the Pallas kernel and to the oracle at 2e-5, with
dt in Mamba2's initial range (softplus(N(0, 1) - 4)), where the chunked and
sequential forms agree that closely.

The hand CUDA kernels run only on the card: tests/test_torch_cuda.py holds
them to `torch_ssd_scan` there, and to the reference's own Pallas outputs
that this file writes, run as a script, to tests/data/ssd_scan_reference.npz
(f32 and bf16, one with an entering state; the plain version is held to
them here).
"""
import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_kernel import ssd_scan_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.checks import (F32_TOL, SSD_REL_TOL, ssd_faults, ssd_inputs,
                                        ssd_judge, ssd_rel)
from repro_torch.kernels.ssd_kernel import (chunk_len, split_ssd, ssd_scan,
                                            torch_ssd_scan)

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

SAME = dict(atol=1e-4, rtol=1e-4)
CROSS = dict(atol=2e-3, rtol=2e-3)
CASES = [(16, 64), (32, 96), (32, 70), (8, 8)]       # (chunk, seq)
SPLIT = dict(atol=2e-5, rtol=2e-5)
# (L, seq, batch, entering state): seq below L, at L, at 2L - 1 and 2L + 1
SPLIT_CASES = [(L, s, 1 + k % 2, k in (0, 3)) for L in (64, 128, 256)
               for k, s in enumerate((L // 2, L, 2 * L - 1, 2 * L + 1))]


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


@pytest.mark.parametrize("L,seq,b,init", SPLIT_CASES)
def test_split_ssd_matches_pallas_and_oracle(L, seq, b, init):
    """The tensor-core kernels' arithmetic pass by pass (C·Bᵀ once per
    (batch, chunk), chunk states, state passing in place, output) against
    the Pallas kernel at chunk L (interpret mode) and the sequential oracle:
    y and the final state at 2e-5."""
    rng = np.random.default_rng(L * 10 + seq)

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32)
    nh, hd, ns = 4, 8, 16
    x = t(b, seq, nh, hd)
    dt = np.logaddexp(t(b, seq, nh) - 4, 0).astype(np.float32)
    A = -np.exp(t(nh))
    B, C, D = t(b, seq, ns), t(b, seq, ns), t(nh)
    h0 = t(b, nh, hd, ns) * 0.1 if init else None
    args = (x, dt, A, B, C, D)
    jargs = [jnp.asarray(a) for a in args]
    jh0 = jnp.asarray(h0) if init else None
    want = {"pallas": ssd_scan_pallas(*jargs, chunk=L, init_state=jh0,
                                      return_state=True, interpret=True),
            "sequential": jref.ssd_reference(*jargs, init_state=jh0,
                                             return_state=True)}
    y, h = split_ssd(*map(torch.from_numpy, args), L=L, return_state=True,
                     init_state=torch.from_numpy(h0) if init else None)
    for name, (wy, wh) in want.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), err_msg=name, **SPLIT)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), err_msg=name, **SPLIT)


def test_chunk_len_from_scratch_bytes():
    """The kernels' own chunk: L >= 2 ns, between one 64-token tile and 256,
    and no longer than the sequence rounded up to a tile."""
    assert [chunk_len(2048, ns) for ns in (16, 32, 64, 128)] == [64, 64, 128, 256]
    assert [chunk_len(s, 128) for s in (0, 1, 64, 65, 200, 16384)] == \
        [64, 64, 64, 128, 256, 256]


@pytest.mark.parametrize("ns,nh,s,init", [(128, 24, 700, True), (64, 16, 700, False)])
def test_bf16_operand_emulation_reads_inside_the_limit(ns, nh, s, init):
    """The limit the card holds bf16 B3 to, from a CPU emulation of its bf16
    operands (`split_ssd(operands=torch.bfloat16)`, y rounded to bf16) at the
    models' head width: the emulation reads below SSD_REL_TOL against the
    plain version in f32, on y and the state, and a dropped 64-token u-tile
    (its B rows zeroed) reads above it (`checks.ssd_judge`)."""
    g = torch.Generator().manual_seed(ns + s)
    _, x, dt, A, B, C, D, h0 = ssd_inputs(2, s, nh, 64, ns, init=init,
                                          generator=g, device="cpu")
    kw = dict(init_state=h0, return_state=True)
    wy, wh = torch_ssd_scan(x.float(), dt, A, B.float(), C.float(), D,
                            chunk=chunk_len(s, ns), **kw)
    ey, eh = split_ssd(x, dt, A, B, C, D, L=chunk_len(s, ns),
                       operands=torch.bfloat16, **kw)
    assert ey.dtype == torch.bfloat16
    got = ssd_judge("emulation", ey, eh, wy, wh, ssd_faults(
        x, dt, A, B, C, D, init_state=h0, carry=False))
    assert set(got) >= {"fault_tile_y", "fault_tile_state"}


@pytest.mark.parametrize("ns,nh,b,s", [(64, 5, 1, 17 * 128 + 37),
                                       (128, 3, 2, 9 * 256 + 5)])
def test_bf16_emulation_sees_the_carry_faults_at_slow_decay(ns, nh, b, s):
    """At a slow decay (a chunk keeps 0.2-0.99 of the state) over more than
    8 chunks with an entering state, the emulation of the bf16 operands
    still reads below SSD_REL_TOL, and a state passing cut to the previous
    chunk's own state (h_in[c] = S[c-1]) or a dropped entering state reads
    above it, on y and on the state: the card's check can see a fault of
    the state passing.  The cut is also held to the plain version on the
    first chunk, where it changes nothing."""
    g = torch.Generator().manual_seed(ns * b)
    _, x, dt, A, B, C, D, h0 = ssd_inputs(b, s, nh, 64, ns, init=True,
                                          generator=g, device="cpu", slow=True)
    L = chunk_len(s, ns)
    kw = dict(init_state=h0, return_state=True)
    wy, wh = torch_ssd_scan(x.float(), dt, A, B.float(), C.float(), D,
                            chunk=L, **kw)
    ey, eh = split_ssd(x, dt, A, B, C, D, L=L, operands=torch.bfloat16, **kw)
    faults = ssd_faults(x, dt, A, B, C, D, init_state=h0, carry=True)
    got = ssd_judge("emulation", ey, eh, wy, wh, faults)
    assert min(got["fault_carry"] + got["fault_init"]) > 10 * SSD_REL_TOL
    torch.testing.assert_close(faults["carry"][0][:, :L], wy[:, :L],
                               atol=2e-5, rtol=2e-5)


# ---- the reference's own outputs, for the card ----------------------------------
#: the reference's `ssd_scan_pallas` outputs (interpret mode, CPU) with their
#: inputs, written by this file run as a script; tests/test_torch_cuda.py holds
#: the card's kernel to them, which imports no JAX
FIXTURE = Path(__file__).resolve().parent / "data" / "ssd_scan_reference.npz"
#: name -> (dtype, b, s, nh, hd, ns, chunk, entering state): the f32 kernel's
#: 64-token chunks against the reference's 32 / 64, the bf16 kernel's
#: chunk_len (64 at ns 32) against 64, ragged lengths
FIXTURE_CASES = {
    "f32_96": ("float32", 2, 96, 2, 32, 16, 32, False),
    "f32_200_init": ("float32", 1, 200, 2, 64, 64, 64, True),
    "bf16_130_init": ("bfloat16", 1, 130, 2, 64, 32, 64, True),
}


def _fixture_inputs(name):
    """Numpy f32 inputs from a seed, dt in Mamba2's initial range
    (softplus(N(0, 1) - 4)); a bf16 case's x, B and C rounded to bf16
    (exact in f32)."""
    dtype, b, s, nh, hd, ns, _, init = FIXTURE_CASES[name]
    rng = np.random.default_rng(len(name) * 1000 + s)

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32)
    out = dict(x=t(b, s, nh, hd), dt=np.logaddexp(t(b, s, nh) - 4, 0).astype(np.float32),
               A=-np.exp(t(nh)), B=t(b, s, ns), C=t(b, s, ns), D=t(nh))
    if init:
        out["init_state"] = t(b, nh, hd, ns) * 0.1
    if dtype == "bfloat16":
        for k in ("x", "B", "C"):
            out[k] = torch.from_numpy(out[k]).bfloat16().float().numpy()
    return out


def fixture_cases():
    """{name: (dtype, chunk, inputs, y, state)} from FIXTURE, numpy f32 (a
    bf16 case's y is the reference's bf16 output widened)."""
    data = np.load(FIXTURE)
    out = {}
    for name, (dtype, *_, chunk, init) in FIXTURE_CASES.items():
        keys = ("x", "dt", "A", "B", "C", "D") + (("init_state",) if init else ())
        out[name] = (dtype, chunk, {k: data[f"{name}.{k}"] for k in keys},
                     data[f"{name}.y"], data[f"{name}.state"])
    return out


def _write_fixture(path):
    from jax import numpy as jnp_
    arrays = {}
    for name, (dtype, *_, chunk, init) in FIXTURE_CASES.items():
        inp = _fixture_inputs(name)
        j = {k: jnp_.asarray(v) for k, v in inp.items()}
        if dtype == "bfloat16":
            j.update({k: j[k].astype(jnp_.bfloat16) for k in ("x", "B", "C")})
        y, h = ssd_scan_pallas(j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"], chunk=chunk,
                               init_state=j.get("init_state"), return_state=True,
                               interpret=True)
        arrays.update({f"{name}.{k}": v for k, v in inp.items()})
        arrays[f"{name}.y"] = np.asarray(y.astype(jnp_.float32))
        arrays[f"{name}.state"] = np.asarray(h)
        arrays[f"{name}.chunk"], arrays[f"{name}.dtype"] = np.array(chunk), np.array(dtype)
    path.parent.mkdir(exist_ok=True)
    np.savez_compressed(path, **arrays)
    print(f"{path}: {path.stat().st_size} bytes")


@pytest.mark.parametrize("name", list(FIXTURE_CASES))
def test_plain_version_matches_the_reference_fixture(name):
    """`torch_ssd_scan` on the fixture's inputs against the reference's
    outputs stored beside them, within `kernels/checks.py`'s limits for the
    card's kernels (f32: F32_TOL elementwise; bf16: SSD_REL_TOL per (batch,
    head) on y and the state); the stored inputs are this file's."""
    dtype, chunk, inp, wy, wh = fixture_cases()[name]
    for k, v in _fixture_inputs(name).items():
        np.testing.assert_array_equal(inp[k], v, err_msg=k)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    if dtype == "bfloat16":
        t.update({k: t[k].bfloat16() for k in ("x", "B", "C")})
    y, h = torch_ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], t["D"], chunk=chunk,
                          init_state=t.get("init_state"), return_state=True)
    if dtype == "bfloat16":
        assert max(ssd_rel(y, h, torch.from_numpy(wy), torch.from_numpy(wh))) < SSD_REL_TOL
    else:
        np.testing.assert_allclose(y.numpy(), wy, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(h.numpy(), wh, atol=F32_TOL, rtol=F32_TOL)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_ssd.py
    _write_fixture(FIXTURE)
