"""Kernel dispatch with the reference's signatures (``kernels/ops.py``).

``impl``:
  "auto"  — the hand CUDA kernel for CUDA tensors; the plain version for CPU
            tensors (the wrappers decide from the tensor's device, and a CUDA
            tensor never falls back).  The kernels have no backward, as the
            reference's Pallas kernels have none: under autograd, with an
            input that requires grad, "auto" raises on either device
  "torch" — the plain version: chunked online-softmax attention, the twin of
            the reference's ``ops.xla_attention`` / ``_decode_xla_window``;
            the chunked SSD, the twin of ``_ssd_chunked_xla``.  The training
            path asks for it by name, as the reference trains with "xla"
  "ref"   — the naive oracle (small shapes only): full-materialisation
            attention, the sequential SSD scan
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import replay
from repro_torch.kernels.flash_attention import flash_attention, torch_attention
from repro_torch.kernels.flash_decode import flash_decode, torch_decode
from repro_torch.kernels.moe_grouped_gemm import (moe_grouped_gemm,
                                                  torch_grouped_gemm)
from repro_torch.kernels.ssd_kernel import ssd_scan as _ssd_kernel
from repro_torch.kernels.ssd_kernel import torch_ssd_scan


def attention(q, k, v, *, causal=True, sliding_window=0, q_offset=0,
              kv_len=None, impl="auto", scale=None, return_lse=False):
    """Multi-head GQA attention.  q (B,H,Sq,D), k/v (B,KV,Sk,D).
    return_lse: also the f32 row log-sum-exp (B,H,Sq), -inf for a row with
    no visible key (the SP ring merges hops on it; not from "ref")."""
    kw = dict(causal=causal, sliding_window=sliding_window, q_offset=q_offset,
              kv_len=kv_len, scale=scale)
    if impl == "auto":
        return flash_attention(q, k, v, return_lse=return_lse, **kw)
    if impl == "torch":
        return torch_attention(q, k, v, return_lse=return_lse, **kw)
    if impl == "ref":
        if return_lse:
            raise ValueError("the naive oracle gives no LSE")
        return _ref.mha_reference(q, k, v, **kw)
    raise ValueError(f"unknown impl {impl}")


def decode_attention(q, k, v, cache_len, *, sliding_window=0, impl="auto"):
    """Single new token vs KV cache.  q (B,H,D), k/v (B,KV,S,D), cache_len (B,)."""
    if impl == "auto":
        return flash_decode(q, k, v, cache_len, sliding_window=sliding_window)
    if impl == "torch":
        return torch_decode(q, k, v, cache_len, sliding_window=sliding_window)
    if impl == "ref":
        return _ref.decode_attention_reference(q, k, v, cache_len,
                                               sliding_window=sliding_window)
    raise ValueError(f"unknown impl {impl}")


def ssd_scan(x, dt, A, B, C, D, *, chunk=256, init_state=None,
             return_state=False, impl="auto"):
    """Mamba2 SSD over a whole sequence.  x (b,s,nh,hd), dt (b,s,nh), A/D
    (nh,), B/C (b,s,ns); returns y [, the final f32 state (b,nh,hd,ns)]."""
    kw = dict(init_state=init_state, return_state=return_state)
    if impl == "auto":
        return _ssd_kernel(x, dt, A, B, C, D, chunk=chunk, **kw)
    if impl == "torch":
        return replay.call("ssd_scan", torch_ssd_scan, x, dt, A, B, C, D,
                           chunk=chunk, **kw)
    if impl == "ref":
        return _ref.ssd_reference(x, dt, A, B, C, D, **kw)
    raise ValueError(f"unknown impl {impl}")


def grouped_gemm(a, b, offsets, *, impl="auto"):
    """The routed experts' products: a (rows, K) sorted by expert, b (E, K,
    N), offsets (E + 1,) int32 -> (rows, N), rows past offsets[E] unset
    ("auto" on the card) or zero."""
    if impl == "auto":
        return moe_grouped_gemm(a, b, offsets)
    if impl in ("torch", "ref"):
        return torch_grouped_gemm(a, b, offsets)
    raise ValueError(f"unknown impl {impl}")


def ssd_step(x, dt, A, B, C, D, state):
    """Decode-time single step, plain PyTorch as in the reference (a few
    elementwise ops and two small contractions per layer)."""
    return _ref.ssd_step_reference(x, dt, A, B, C, D, state)
