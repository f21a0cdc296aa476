"""Kernel dispatch with the reference's signatures (``kernels/ops.py``).

``impl``:
  "auto"  — the hand CUDA kernel for CUDA tensors; the plain version for CPU
            tensors (the wrappers decide from the tensor's device, and a CUDA
            tensor never falls back)
  "torch" — the plain version: chunked online-softmax attention, the twin of
            the reference's ``ops.xla_attention`` / ``_decode_xla_window``
  "ref"   — the naive full-materialisation oracle (small shapes only)
"""
from __future__ import annotations

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention, torch_attention
from repro_torch.kernels.flash_decode import flash_decode, torch_decode


def attention(q, k, v, *, causal=True, sliding_window=0, q_offset=0,
              kv_len=None, impl="auto", scale=None):
    """Multi-head GQA attention.  q (B,H,Sq,D), k/v (B,KV,Sk,D)."""
    kw = dict(causal=causal, sliding_window=sliding_window, q_offset=q_offset,
              kv_len=kv_len, scale=scale)
    if impl == "auto":
        return flash_attention(q, k, v, **kw)
    if impl == "torch":
        return torch_attention(q, k, v, **kw)
    if impl == "ref":
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
