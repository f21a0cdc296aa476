"""Decode attention: the hand CUDA kernel (``csrc/flash_decode.cu``,
replacing the Pallas kernel B2) and its plain PyTorch version.

`flash_decode` launches the kernel for CUDA tensors and runs the plain
version `torch_decode` only for tensors on the CPU.  `torch_decode` twins
the reference's ``ops.decode_attention(impl="xla")``: chunked attention with
``kv_len=cache_len`` without a window, and ``_decode_xla_window`` with one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import torch_attention
from repro_torch.kernels.ref import NEG_INF, _repeat_kv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_N_REP = (1, 2, 4, 7, 8)


def torch_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor, *, sliding_window: int = 0
                 ) -> torch.Tensor:
    """q (B,H,D); k, v (B,KV,S,D); cache_len (B,); returns (B,H,D)."""
    if not sliding_window:
        return torch_attention(q[:, :, None], k, v, causal=False,
                               kv_len=cache_len)[:, :, 0]
    b, h, d = q.shape
    s = k.shape[2]
    n_rep = h // k.shape[1]
    logits = torch.einsum("bhd,bhkd->bhk", q.float(),
                          _repeat_kv(k, n_rep).float()) * d ** -0.5
    kpos = torch.arange(s, device=q.device)[None]
    newest = cache_len.to(q.device)[:, None] - 1
    valid = (kpos <= newest) & (newest - kpos < sliding_window)
    logits = torch.where(valid[:, None], logits, NEG_INF)
    p = torch.softmax(logits, -1)
    return torch.einsum("bhk,bhkd->bhd", p,
                        _repeat_kv(v, n_rep).float()).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor, *, sliding_window: int = 0
                 ) -> torch.Tensor:
    """q (B,H,D); k, v (B,KV,S,D); cache_len (B,) int; returns (B,H,D) in
    q's dtype.  CUDA tensors go to the hand kernel, CPU tensors to
    `torch_decode`.  The kernel reads keys [cache_len - window, cache_len)
    only; a sequence with cache_len 0 yields 0."""
    if q.device.type == "cpu":
        return torch_decode(q, k, v, cache_len, sliding_window=sliding_window)
    b, h, d = q.shape
    kb, kvh, s, kd = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode: unsupported dtype {q.dtype}")
    if d not in _HEAD_DIMS or kd != d or kb != b or h % kvh \
            or h // kvh not in _N_REP or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_decode: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != q.dtype:
            raise ValueError(f"flash_decode: {name} is {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and "
                             "16-byte aligned")
    if cache_len.shape != (b,) or cache_len.device != q.device:
        raise ValueError("flash_decode: cache_len must be (B,) on q's device")
    cache_len = cache_len.to(torch.int32).contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_decode")
    fn = lib.fd_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             cache_len.data_ptr(), b, h, kvh, s, d, int(sliding_window),
             float(d ** -0.5), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


#: launches of the CUDA kernel since the count was last set to 0
flash_decode.launches = 0
