"""Decode attention: the hand CUDA kernel (``csrc/flash_decode.cu``,
replacing the Pallas kernel B2) and its plain PyTorch version.

`flash_decode` launches the kernel for CUDA tensors and runs the plain
version `torch_decode` only for tensors on the CPU.  `torch_decode` twins
the reference's ``ops.decode_attention(impl="xla")``: chunked attention with
``kv_len=cache_len`` without a window, and ``_decode_xla_window`` with one.

The kernel splits the key axis across blocks (`split_plan`), each writing
an f32 online-softmax partial that a second kernel merges in split order;
`split_decode` is the same arithmetic in plain PyTorch, for the CPU tests.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import torch_attention
from repro_torch.kernels.ref import NEG_INF, _repeat_kv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 80, 128)
_N_REP = (1, 2, 3, 4, 5, 7, 8)
_SPLIT_ALIGN = 64            # keys: a split's length is a multiple of this
_BLOCKS_PER_SM = 4           # grid the split aims at


def split_plan(b: int, kvh: int, s: int, n_sms: int) -> Tuple[int, int]:
    """(n_split, chunk): split i covers keys [i * chunk, (i + 1) * chunk).
    From the shapes and the card's SM count only (cache_len lies on the
    device): enough splits that the (KV, B, n_split) grid puts about
    `_BLOCKS_PER_SM` blocks on every SM, each split a multiple of 64 keys.
    8 sequences x KV 8 x 2048 keys on 132 SMs: 8 splits of 256, 512 blocks."""
    want = -(-_BLOCKS_PER_SM * n_sms // max(b * kvh, 1))
    n = max(1, min(want, -(-s // _SPLIT_ALIGN)))
    chunk = -(-(-(-s // n)) // _SPLIT_ALIGN) * _SPLIT_ALIGN
    return max(1, -(-s // chunk)), chunk


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _plan(b: int, kvh: int, s: int, index: int) -> Tuple[int, int]:
    """`split_plan` on card `index`, kept per shape: a decode step asks for
    the same few shapes on every layer."""
    return split_plan(b, kvh, s, _n_sms(index))


@functools.lru_cache(maxsize=None)
def _fd_forward():
    fn = _build.load("flash_decode").fd_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def split_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cache_len: torch.Tensor, *, sliding_window: int = 0,
                 n_split: int, chunk: int) -> torch.Tensor:
    """The kernel's split-and-merge arithmetic in plain PyTorch (f32): each
    split's (m, l, acc) over keys [max(lo, i * chunk), min(len, (i + 1) *
    chunk)), an empty split m = -inf, merged in split order."""
    b, h, d = q.shape
    s = k.shape[2]
    n_rep = h // k.shape[1]
    logits = torch.einsum("bhd,bhkd->bhk", q.float(),
                          _repeat_kv(k, n_rep).float()) * d ** -0.5
    vf = _repeat_kv(v, n_rep).float()
    kpos = torch.arange(s, device=q.device)[None]
    length = cache_len.to(q.device).long().clamp(0, s)[:, None]
    lo = (length - sliding_window).clamp_min(0) if sliding_window else 0
    ms, ls, accs = [], [], []
    for i in range(n_split):
        valid = ((kpos >= lo) & (kpos < length) & (kpos >= i * chunk)
                 & (kpos < (i + 1) * chunk))[:, None]            # (B, 1, S)
        x = torch.where(valid, logits, float("-inf"))
        m = x.amax(-1)                                           # (B, H)
        p = torch.exp(x - torch.where(torch.isneginf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhk,bhkd->bhd", p, vf))
    m_all = torch.stack(ms)                                      # (n_split, B, H)
    mx = m_all.amax(0)
    c = torch.where(torch.isneginf(m_all), 0.0,
                    torch.exp(m_all - torch.where(torch.isneginf(mx), 0.0, mx)))
    den = (torch.stack(ls) * c).sum(0)
    num = (torch.stack(accs) * c[..., None]).sum(0)
    return (num / den.clamp_min(1e-30)[..., None]).to(q.dtype)


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
    only; a sequence with cache_len 0 yields 0.  Under autograd it raises
    (the kernel has no backward: use `torch_decode`)."""
    _build.refuse_autograd("flash_decode", q, k, v)
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
    operands = (("q", q), ("k", k), ("v", v))
    for name, t in operands:
        if t.dtype != q.dtype:
            raise TypeError(f"flash_decode: {name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
    for name, t in operands:
        if not t.is_cuda:
            raise ValueError(f"flash_decode: {name} is on {t.device}, not CUDA")
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    for (name, _), ptr in zip(operands, ptrs):
        if ptr % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned")
    dev = q.device
    if cache_len.shape != (b,) or cache_len.device != dev:
        raise ValueError("flash_decode: cache_len must be (B,) on q's device")
    if cache_len.dtype != torch.int32 or not cache_len.is_contiguous():
        cache_len = cache_len.to(torch.int32).contiguous()
    out = torch.empty_like(q)             # (B, H, D), contiguous as q is
    if b == 0 or s == 0:                  # nothing to launch: no key is cached
        return out.zero_()
    n_split, chunk = _plan(b, kvh, s, dev.index or 0)
    # f32 partials of every (batch, head, split): acc (.., D), then (m, l)
    part = q.new_empty(b * h * n_split * (d + 2), dtype=torch.float32)
    part_acc = part.data_ptr()
    err = _fd_forward()(*ptrs, out.data_ptr(),
                        cache_len.data_ptr(), part_acc,
                        part_acc + 4 * b * h * n_split * d,
                        b, h, kvh, s, d, int(sliding_window), n_split, chunk,
                        float(d ** -0.5), _DTYPES[q.dtype], _build.raw_stream(dev))
    _build.check(err, "flash_decode")
    _build.count_launch(flash_decode)
    return out


#: calls that launched the kernels (split + combine count as one) since
#: the count was last set to 0
flash_decode.launches = 0
