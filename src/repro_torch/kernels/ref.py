"""Naive oracles: torch twins of the reference's ``kernels/ref.py`` —
full-materialisation attention, the sequential SSD scan and one SSD decode
step.

Small shapes only; they are the ground truth for the plain versions in
``ops.py`` and, on the card, for the hand kernels.  ``ssd_step_reference``
is also the decode path itself (``ops.ssd_step``), as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, KV, S, D) -> (B, KV*n_rep, S, D) by head repetition (GQA)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=1)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sliding_window: int = 0,
                  q_offset: int = 0, kv_len: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, KV, Sk, D) with KV | H.

    q_offset: absolute position of q[..., 0, :].  kv_len: optional (B,)
    valid KV lengths.  Masking is by the finite NEG_INF, as the reference
    oracle does (a fully-masked row averages V uniformly)."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    k = _repeat_kv(k, h // kvh)
    v = _repeat_kv(v, h // kvh)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    sk = k.shape[2]
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if sliding_window > 0:
        mask &= q_pos - k_pos < sliding_window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    if kv_len is not None:
        valid = k_pos[None] < kv_len.to(q.device)[:, None, None]   # (B,1,Sk)
        logits = torch.where(valid[:, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, cache_len: torch.Tensor, *,
                               sliding_window: int = 0) -> torch.Tensor:
    """Single-token decode: q (B, H, D) vs cache k/v (B, KV, S, D) with
    valid length ``cache_len`` (B,); the query sits at cache_len - 1."""
    b, h, d = q.shape
    if sliding_window <= 0:
        return mha_reference(q[:, :, None], k, v, causal=False,
                             kv_len=cache_len)[:, :, 0]
    s = k.shape[2]
    k_pos = torch.arange(s, device=q.device)[None]
    newest = cache_len.to(q.device)[:, None] - 1
    valid = (k_pos <= newest) & (newest - k_pos < sliding_window)
    kk = torch.where(valid[:, None, :, None], k, torch.zeros((), dtype=k.dtype,
                                                             device=k.device))
    n_rep = h // k.shape[1]
    logits = torch.einsum("bhd,bhkd->bhk", q.float(),
                          _repeat_kv(kk, n_rep).float()) * d ** -0.5
    logits = torch.where(valid[:, None], logits, NEG_INF)
    p = torch.softmax(logits, -1)
    vv = _repeat_kv(v, n_rep).float()
    return torch.einsum("bhk,bhkd->bhd", p, vv).to(q.dtype)


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                  init_state: Optional[torch.Tensor] = None,
                  return_state: bool = False):
    """Mamba2 SSD sequential-scan oracle.

    x (b, s, nh, hd); dt (b, s, nh) softplus-activated step sizes; A, D
    (nh,); B, C (b, s, ns); state (b, nh, hd, ns) f32.
    y = C·h + D*x with h_t = exp(A*dt_t) h_{t-1} + dt_t * (x_t ⊗ B_t)."""
    b, s, nh, hd = x.shape
    ns = B.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    Af = A.float()
    h = (torch.zeros((b, nh, hd, ns), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(Af[None] * dtf[:, t])                       # (b, nh)
        dBx = torch.einsum("bnh,bs->bnhs", xf[:, t] * dtf[:, t, :, None],
                           Bf[:, t])
        h = h * decay[..., None, None] + dBx
        ys.append(torch.einsum("bnhs,bs->bnh", h, Cf[:, t]))
    y = torch.stack(ys, 1) + D.float()[None, None, :, None] * xf
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def ssd_step_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                       state: torch.Tensor):
    """One decode step.  x (b, nh, hd), dt (b, nh), B/C (b, ns), state
    (b, nh, hd, ns) f32; returns (y in x's dtype, the new state)."""
    xf = x.float()
    decay = torch.exp(A.float()[None] * dt)                           # (b, nh)
    dBx = torch.einsum("bnh,bs->bnhs", xf * dt[..., None], B.float())
    state = state * decay[..., None, None] + dBx
    y = torch.einsum("bnhs,bs->bnh", state, C.float())
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), state
