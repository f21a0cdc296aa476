"""Port kernels vs the JAX reference: the port's plain ("torch") and oracle
("ref") attention and decode against the reference's Pallas kernels (run in
interpret mode, as tests/test_kernels.py runs them), its XLA paths and its
oracles, on the same numpy inputs.  f32 throughout; tolerance 2e-5, the
reference's own kernel tolerance (f32 sums taken in another order).

The hand CUDA kernels run only on the card: tests/test_torch_cuda.py holds
them to their plain versions there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.flash_decode import flash_decode as j_flash_decode
from repro_torch.kernels import _build, ops
from repro_torch.kernels.flash_attention import flash_attention, torch_attention
from repro_torch.kernels.flash_decode import flash_decode, torch_decode

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

TOL = dict(atol=2e-5, rtol=2e-5)

ATTN_CASES = [
    # b, h, kv, sq, sk, d, causal, win, qoff  (tests/test_kernels.py)
    (1, 2, 1, 32, 32, 16, True, 0, 0),
    (2, 4, 2, 40, 40, 8, True, 0, 0),
    (1, 4, 4, 17, 64, 8, False, 0, 0),
    (2, 2, 2, 32, 32, 8, True, 12, 0),
    (1, 2, 2, 8, 64, 8, True, 0, 56),
    (1, 8, 1, 24, 24, 32, True, 0, 0),     # MQA
    (3, 6, 3, 9, 33, 16, True, 7, 0),      # uneven
]


@functools.lru_cache(maxsize=None)
def _attn_case(i):
    """Inputs (numpy) and the three JAX outputs for ATTN_CASES[i], with a
    ragged kv_len that leaves every query row at least one visible key."""
    b, h, kv, sq, sk, d, causal, win, qo = ATTN_CASES[i]
    rng = np.random.default_rng(100 + i)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, kv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, kv, sk, d)).astype(np.float32)
    kvl = rng.integers(max(sq, 1), sk + 1, size=b).astype(np.int32)
    kw = dict(causal=causal, sliding_window=win, q_offset=qo,
              kv_len=jnp.asarray(kvl))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = {
        "pallas": np.asarray(j_flash_attention(jq, jk, jv, interpret=True,
                                               **kw)),
        "xla": np.asarray(jops.xla_attention(jq, jk, jv, q_block=8,
                                             kv_block=8, **kw)),
        "ref": np.asarray(jref.mha_reference(jq, jk, jv, **kw)),
    }
    _, lse = jops.xla_attention(jq, jk, jv, return_lse=True, **kw)
    return (q, k, v, kvl), want, np.asarray(lse)


@pytest.mark.parametrize("impl", ["torch", "ref"])
@pytest.mark.parametrize("i", range(len(ATTN_CASES)))
def test_attention_matches_jax(i, impl):
    b, h, kv, sq, sk, d, causal, win, qo = ATTN_CASES[i]
    (q, k, v, kvl), want, _ = _attn_case(i)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, sliding_window=win,
                        q_offset=qo, kv_len=torch.from_numpy(kvl), impl=impl)
    for name, w in want.items():
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("i", range(len(ATTN_CASES)))
def test_attention_lse_matches_xla(i):
    b, h, kv, sq, sk, d, causal, win, qo = ATTN_CASES[i]
    (q, k, v, kvl), want, want_lse = _attn_case(i)
    out, lse = torch_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               sliding_window=win, q_offset=qo,
                               kv_len=torch.from_numpy(kvl), q_block=8,
                               kv_block=16, return_lse=True)
    np.testing.assert_allclose(out.numpy(), want["xla"], **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)


def test_fully_masked_rows_follow_xla_attention():
    """A row with no visible key: output 0 and LSE -inf, as
    ops.xla_attention gives (the ring merge needs it)."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 2, 8, 8)).astype(np.float32)
    k = rng.normal(size=(1, 2, 16, 8)).astype(np.float32)
    kw = dict(causal=True, q_offset=-4)           # rows 0-3 see no key
    wo, wl = jops.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                return_lse=True, **kw)
    go, gl = torch_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(k), return_lse=True, **kw)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), **TOL)
    np.testing.assert_array_equal(np.isneginf(gl.numpy()),
                                  np.isneginf(np.asarray(wl)))
    assert np.isneginf(gl.numpy()[0, :, :4]).all()
    assert (go.numpy()[0, :, :4] == 0).all()


@pytest.mark.parametrize("impl", ["torch", "ref"])
@pytest.mark.parametrize("win", [0, 24])
def test_decode_matches_jax(win, impl):
    b, h, kv, s, d = 3, 8, 2, 64, 16
    rng = np.random.default_rng(7 + win)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    cl = np.asarray([5, 33, 64], np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl))
    want = {
        "pallas": np.asarray(j_flash_decode(*jargs, sliding_window=win,
                                            block_k=16, interpret=True)),
        "xla": np.asarray(jops.decode_attention(*jargs, sliding_window=win,
                                                impl="xla")),
    }
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(cl),
                               sliding_window=win, impl=impl)
    for name, w in want.items():
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **TOL)


def test_auto_takes_plain_version_for_cpu_tensors():
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(2, 4, 12, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 2, 12, 32)).astype(np.float32))
    before = flash_attention.launches, flash_decode.launches
    assert torch.equal(ops.attention(q, k, k, impl="auto"),
                       torch_attention(q, k, k))
    cl = torch.tensor([3, 12], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, :, 0], k, k, cl, impl="auto"),
                       torch_decode(q[:, :, 0], k, k, cl))
    assert (flash_attention.launches, flash_decode.launches) == before
    with pytest.raises(ValueError):
        ops.attention(q, k, k, impl="xla")


@pytest.mark.parametrize("which", ["attention", "decode"])
def test_non_cpu_tensor_never_falls_back(which):
    """A tensor off the CPU goes to the kernel or raises — here a meta
    tensor, which the kernel refuses before any build or launch."""
    q = torch.empty((1, 4, 8, 64), device="meta")
    k = torch.empty((1, 2, 8, 64), device="meta")
    with pytest.raises(ValueError):
        if which == "attention":
            flash_attention(q, k, k)
        else:
            flash_decode(q[:, :, 0], k, k, torch.empty((1,), device="meta"))


def test_failed_build_and_launch_raise(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "_lib_path", lambda n: tmp_path / f"lib{n}.so")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        _build.check(700, "flash_decode")
