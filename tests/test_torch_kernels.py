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
from repro_torch.kernels.flash_decode import (flash_decode, split_decode,
                                              split_plan, torch_decode)

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


@pytest.mark.parametrize("win", [0, 24])
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8])
def test_split_decode_matches_jax(n_split, win):
    """B2's split-and-merge arithmetic (`split_decode`: a partial per key
    range, empty ranges m = -inf, merged in split order) against the
    reference's Pallas kernel (interpret mode) and its XLA decode path."""
    b, h, kv, s, d = 4, 8, 2, 64, 16
    rng = np.random.default_rng(40 + n_split + win)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, d)).astype(np.float32)
    chunk = -(-s // n_split)
    cl = np.asarray([1, chunk, min(chunk + 1, s), s], np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cl))
    want = {
        "pallas": np.asarray(j_flash_decode(*jargs, sliding_window=win,
                                            block_k=16, interpret=True)),
        "xla": np.asarray(jops.decode_attention(*jargs, sliding_window=win,
                                                impl="xla")),
    }
    got = split_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(cl),
                       sliding_window=win, n_split=n_split, chunk=chunk)
    for name, w in want.items():
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **TOL)


def test_split_decode_empty_sequence_gives_zero():
    """cache_len 0: every split is empty and the merge gives 0, as the
    TPU kernel does, with or without a window."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 2, 32, 8)).astype(np.float32))
    for win in (0, 5):
        got = split_decode(q, k, k, torch.tensor([0, 9]), sliding_window=win,
                           n_split=4, chunk=8)
        assert (got[0] == 0).all()
        torch.testing.assert_close(got[1], torch_decode(
            q, k, k, torch.tensor([0, 9]), sliding_window=win)[1], **TOL)


@pytest.mark.parametrize("b,kvh,s,sms,want", [
    (8, 8, 2048, 132, (8, 256)),       # the serving batch: 512 blocks
    (8, 32, 2048, 132, (3, 704)),      # zamba2's MHA block: 768 blocks
    (1, 8, 64, 132, (1, 64)),
    (4, 8, 300, 132, (5, 64)),
    (64, 32, 4096, 132, (1, 4096)),    # a grid that fills the card unsplit
    (1, 8, 2048, 132, (32, 64)),       # one sequence: 256 blocks of 64 keys
    (4, 32, 2048, 132, (5, 448)),      # zamba2's block at batch 4: 640 blocks
    (8, 8, 256, 132, (4, 64)),         # a short cache: splits of one 64-key step
    (8, 2, 128, 132, (2, 64)),         # the engine cells' decode: two splits
])
def test_split_plan(b, kvh, s, sms, want):
    n_split, chunk = split_plan(b, kvh, s, sms)
    assert (n_split, chunk) == want
    assert chunk % 64 == 0 and n_split * chunk >= s > (n_split - 1) * chunk


def test_engine_f32_cases_are_the_engine_shapes_and_see_their_faults():
    """`checks.engine_f32_checks`, which chip_smoke.py runs on the card, holds
    B1 and B2 at the evaluation path's engine shapes (the runner's reduced
    f32 stack: 4 query / 2 KV heads of 64, a 128-token context, 8 decode
    slots).  On the CPU the wrappers run their plain versions, so the
    kernel readings are 0, and every dropped-keys fault (the last key, a
    64-key tile or split) must read above the limit of its check."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.experiments import runner
    from repro_torch.kernels import checks
    cfg = reduced_config(get_config("mistral_7b"), layers=runner.ENGINE_LAYERS)
    assert checks.ENGINE_F32_HEADS == (cfg.num_heads, cfg.num_kv_heads,
                                       cfg.head_dim)
    assert all(sk <= runner.ENGINE_MAX_LEN
               for _, _, _, sk, _, _ in checks.ENGINE_F32_ATTENTION)
    assert all(len(lens) == 8 and max(lens) <= runner.ENGINE_MAX_LEN
               for _, lens in checks.ENGINE_F32_DECODE)
    out = checks.engine_f32_checks(generator=torch.Generator().manual_seed(16),
                                   device="cpu")
    assert len(out) == len(checks.ENGINE_F32_ATTENTION) + len(checks.ENGINE_F32_DECODE)
    for r in out:
        assert r["max_abs_err"] == 0.0 and r["tol"] == checks.F32_TOL
        faults = {k: v for k, v in r.items() if k.startswith("fault_")}
        assert len(faults) == len(checks.ENGINE_F32_FAULT_KEYS)
        assert min(faults.values()) > checks.F32_TOL


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("k_dtype", TypeError), ("head_dim", ValueError),
    ("gqa", ValueError), ("last_dim_stride", ValueError),
    ("row_stride", ValueError), ("offset", ValueError), ("device", ValueError),
    ("v_shape", ValueError), ("batch", ValueError),
])
def test_attention_wrapper_refuses(case, exc):
    """What the kernels cannot take is refused before any build or launch
    (meta tensors: never a CPU fallback, never a launch)."""
    q, k = _meta(1, 4, 8, 64), _meta(1, 2, 8, 64)
    v = k
    if case == "dtype":
        q, k = _meta(1, 4, 8, 64, dtype=torch.float16), _meta(1, 2, 8, 64, dtype=torch.float16)
    elif case == "k_dtype":
        k = _meta(1, 2, 8, 64, dtype=torch.float32)
    elif case == "head_dim":
        q, k = _meta(1, 4, 8, 96), _meta(1, 2, 8, 96)
    elif case == "gqa":
        q = _meta(1, 3, 8, 64)
    elif case == "last_dim_stride":
        q = _meta(1, 4, 64, 8).transpose(2, 3)
    elif case == "row_stride":                    # rows 68 elements apart
        q = _meta(1, 4, 8, 68)[..., :64]
    elif case == "offset":                        # base 2 bytes past 16-byte alignment
        q = _meta(4 * 8 * 64 + 1)[1:].view(1, 4, 8, 64)
    elif case == "v_shape":
        v = _meta(1, 2, 9, 64)
    elif case == "batch":
        k = v = _meta(2, 2, 8, 64)
    before = flash_attention.launches
    with pytest.raises(exc, match="flash_attention"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("k_dtype", TypeError), ("head_dim", ValueError),
    ("n_rep", ValueError), ("contiguous", ValueError), ("device", ValueError),
    ("gqa", ValueError), ("v_shape", ValueError),
])
def test_decode_wrapper_refuses(case, exc):
    q, k = _meta(2, 8, 64), _meta(2, 2, 16, 64)
    v = k
    if case == "dtype":
        q, k = _meta(2, 8, 64, dtype=torch.float16), _meta(2, 2, 16, 64, dtype=torch.float16)
    elif case == "k_dtype":
        k = _meta(2, 2, 16, 64, dtype=torch.float32)
    elif case == "head_dim":
        q, k = _meta(2, 8, 32), _meta(2, 2, 16, 32)
    elif case == "n_rep":
        q = _meta(2, 6, 64)
    elif case == "contiguous":
        k = _meta(2, 16, 2, 64).transpose(1, 2)
    elif case == "gqa":                           # 5 query heads on 2 KV heads
        q = _meta(2, 5, 64)
    elif case == "v_shape":
        v = _meta(2, 2, 17, 64)
    before = flash_decode.launches
    with pytest.raises(exc, match="flash_decode"):
        flash_decode(q, k, v, torch.empty((2,), dtype=torch.int32, device="meta"))
    assert flash_decode.launches == before
