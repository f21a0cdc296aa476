"""Shared building blocks: RMSNorm, RoPE, SwiGLU, GQA attention (prefill and
cached decode).  Parameters are plain dicts of tensors, one dict per layer.

Rounding follows the reference (``models/layers.py``) step for step: norms
cast back to x's dtype before the weight multiply, RoPE angles in f32 with
the half-split rotation, and linear layers cast the weight to x's dtype.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, n, hd), positions (..., S) or (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    g = F.silu(linear(x, p["w_gate"]))
    u = linear(x, p["w_up"])
    return linear(g * u, p["w_down"])


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, KV, S, hd)
    v: torch.Tensor


def attention_block(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, positions: torch.Tensor, *,
                    causal: bool = True, sliding_window: int = 0,
                    write_cache: bool = False, impl: str = "auto",
                    attn_fn=None):
    """Full-sequence self-attention (prefill).  x (B, S, d).

    write_cache: also return a KVCache of the projected K/V (B, KV, S, hd).
    attn_fn: replaces the core ``ops.attention(qh, kh, vh)`` call, called as
    ``attn_fn(qh, kh, vh, causal=..., sliding_window=...)`` — the hook the
    gang-SP path uses to keep projections, RoPE and residuals shared."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(B, S, KV, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if attn_fn is None:
        o = ops.attention(qh, kh, vh, causal=causal,
                          sliding_window=sliding_window, impl=impl)
    else:
        o = attn_fn(qh, kh, vh, causal=causal, sliding_window=sliding_window)
    out = linear(o.transpose(1, 2).reshape(B, S, H * hd), p["wo"])
    if write_cache:
        return out, KVCache(k=kh, v=vh)
    return out


def decode_attention_block(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                           x: torch.Tensor, cache: KVCache,
                           cache_len: torch.Tensor, *, sliding_window: int = 0,
                           impl: str = "auto"):
    """One-token decode.  x (B, d); cache k/v (B, KV, S_max, hd); cache_len
    (B,) = tokens already cached.  Returns (out (B, d), cache).

    The new token's K/V is written IN PLACE into ``cache`` at each
    sequence's own position (an index write, where the reference rewrites
    the whole cache through a one-hot mask), so the returned cache is the
    same storage as the one passed in.  (The reference's ring-buffer
    long-context mode is not ported: no serving path uses it.)
    """
    B, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, H, hd)
    k = linear(x, p["wk"], p.get("bk")).reshape(B, KV, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, KV, hd)
    q = rope(q[:, None], cache_len[:, None], cfg.rope_theta)[:, 0]   # pos = len
    k = rope(k[:, None], cache_len[:, None], cfg.rope_theta)[:, 0]
    rows = torch.arange(B, device=x.device)
    cache.k[rows, :, cache_len] = k.to(cache.k.dtype)
    cache.v[rows, :, cache_len] = v.to(cache.v.dtype)
    o = ops.decode_attention(q, cache.k, cache.v, cache_len + 1,
                             sliding_window=sliding_window, impl=impl)
    return linear(o.reshape(B, H * hd), p["wo"]), cache


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
              device) -> Dict[str, torch.Tensor]:
    """One layer's attention weights, stored (in, out) like the reference."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    std = d ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std
    p = {"wq": normal(d, H * hd), "wk": normal(d, KV * hd),
         "wv": normal(d, KV * hd), "wo": normal(H * hd, d)}
    if cfg.qkv_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros(n, dtype=dtype, device=device)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device) -> Dict[str, torch.Tensor]:
    d, ff = cfg.d_model, cfg.d_ff

    def normal(*shape, std):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std
    return {"w_gate": normal(d, ff, std=d ** -0.5),
            "w_up": normal(d, ff, std=d ** -0.5),
            "w_down": normal(ff, d, std=ff ** -0.5)}
