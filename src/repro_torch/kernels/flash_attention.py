"""Prefill attention: the hand CUDA kernels (``csrc/flash_attention.cu``,
replacing the Pallas kernel B1) and its plain PyTorch version.

`flash_attention` launches a kernel for CUDA tensors and runs the plain
version `torch_attention` only for tensors on the CPU.  The launcher picks
one of two kernels by dtype and head dim: bf16 at D 64, 80 and 128 goes to
the tensor-core kernel (wgmma + TMA), float32 and bf16 D 32 to the
CUDA-core one (f32 on tensor cores would run as TF32 and miss the 2e-5 the
f32 path is held to).  `torch_attention` is the twin of the reference's
``ops.xla_attention``: chunked online softmax with true -inf masking, so a
row with no visible key gives 0 and LSE -inf.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import _build, replay

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 128)


def _q_column(qb: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
              eff_len: torch.Tensor, q0: int, *, causal: bool,
              sliding_window: int, q_offset: int, kv_block: int, scale: float):
    """One q-block's online softmax over every kv block: (out, lse) in f32."""
    dev = qb.device
    qpos = q0 + torch.arange(qb.shape[2], device=dev) + q_offset
    m = torch.full(qb.shape[:3], float("-inf"), device=dev)
    l = torch.zeros(qb.shape[:3], device=dev)
    acc = torch.zeros(qb.shape, device=dev)
    for k0 in range(0, kf.shape[2], kv_block):
        kb, vb = kf[:, :, k0:k0 + kv_block], vf[:, :, k0:k0 + kv_block]
        kpos = k0 + torch.arange(kb.shape[2], device=dev)
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
        mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if sliding_window > 0:
            mask &= qpos[:, None] - kpos[None, :] < sliding_window
        s = s.masked_fill(~mask[None, None], float("-inf"))
        valid = kpos[None, :] < eff_len[:, None]                 # (B, bk)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])                     # 0 where masked
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), float("-inf"))
    return out, lse


def torch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    q_offset: int = 0, kv_len: Optional[torch.Tensor] = None,
                    q_block: int = 1024, kv_block: int = 1024,
                    scale: Optional[float] = None, return_lse: bool = False):
    """GQA attention with O(block^2) live memory.  q (B,H,Sq,D); k, v
    (B,KV,Sk,D).  return_lse: also return the f32 row log-sum-exp (B,H,Sq).

    Under autograd each q-block column runs under a checkpoint, as the
    reference's ``jax.checkpoint`` of ``do_q_block``: the backward
    recomputes a column's probabilities instead of keeping every
    (q_block, kv_block) tile of every head."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = q.float()
    kf = k.float().repeat_interleave(n_rep, 1) if n_rep > 1 else k.float()
    vf = v.float().repeat_interleave(n_rep, 1) if n_rep > 1 else v.float()
    eff_len = (torch.full((b,), sk, device=dev) if kv_len is None
               else kv_len.to(dev))
    kw = dict(causal=causal, sliding_window=sliding_window, q_offset=q_offset,
              kv_block=kv_block, scale=scale)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    outs, lses = [], []
    for q0 in range(0, sq, q_block):
        args = (qf[:, :, q0:q0 + q_block], kf, vf, eff_len, q0)
        o, lse = (checkpoint(_q_column, *args, use_reentrant=False, **kw) if remat
                  else replay.call("q_column", _q_column, *args, **kw))
        outs.append(o)
        lses.append(lse)
    if not outs:                                   # Sq = 0
        out = q.new_zeros((b, h, 0, d), dtype=torch.float32)
        lse = q.new_zeros((b, h, 0), dtype=torch.float32)
    else:
        out, lse = torch.cat(outs, 2), torch.cat(lses, 2)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


@functools.lru_cache(maxsize=None)
def _fa_forward():
    fn = _build.load("flash_attention").fa_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


def _check_layout(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {dtype}")
    align = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % align for s in t.stride()[:3]) \
            or t.storage_offset() % align:
        raise ValueError(f"flash_attention: {name} needs a contiguous last dim, "
                         f"strides that are multiples of {align} elements and "
                         "a 16-byte aligned base (TMA boxes, 16-byte loads)")


def _check_device(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"flash_attention: {name} is on {t.device}, not CUDA")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} has a base that is not "
                         "16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    q_offset: int = 0, kv_len: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """q (B,H,Sq,D); k, v (B,KV,Sk,D); returns (B,H,Sq,D) in q's dtype
    (and the f32 LSE (B,H,Sq) with return_lse).  CUDA tensors go to the
    hand kernel, CPU tensors to `torch_attention`; under autograd it raises
    (the kernel has no backward: use `torch_attention`)."""
    _build.refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return torch_attention(q, k, v, causal=causal,
                               sliding_window=sliding_window,
                               q_offset=q_offset, kv_len=kv_len, scale=scale,
                               return_lse=return_lse)
    b, h, sq, d = q.shape
    kb, kvh, sk, kd = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if d not in _HEAD_DIMS or kd != d or kb != b or h % kvh \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: unsupported shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    operands = (("q", q), ("k", k), ("v", v))
    for name, t in operands:
        _check_layout(name, t, q.dtype)
    for name, t in operands:
        _check_device(name, t)
    if kv_len is not None:
        if kv_len.shape != (b,) or kv_len.device != q.device:
            raise ValueError("flash_attention: kv_len must be (B,) on q's device")
        if kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
            kv_len = kv_len.to(torch.int32).contiguous()
    out = q.new_empty((b, h, sq, d))
    lse = q.new_empty((b, h, sq), dtype=torch.float32) if return_lse else None
    if sq == 0 or sk == 0:                 # nothing to launch: no key is visible
        out.zero_()
        if lse is not None:
            lse.fill_(float("-inf"))
        return (out, lse) if return_lse else out
    err = _fa_forward()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if lse is not None else None,
             kv_len.data_ptr() if kv_len is not None else None,
             b, h, kvh, sq, sk, d,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             int(causal), int(sliding_window), int(q_offset),
             float(scale if scale is not None else d ** -0.5),
             _DTYPES[q.dtype], _build.raw_stream(q.device))
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention)
    return (out, lse) if return_lse else out


#: launches of the CUDA kernel since the count was last set to 0
flash_attention.launches = 0
