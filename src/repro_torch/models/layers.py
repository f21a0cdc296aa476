"""Shared building blocks: RMSNorm, RoPE, SwiGLU, GQA attention (prefill and
cached decode).  Parameters are plain dicts of tensors, one dict per layer.

Rounding follows the reference (``models/layers.py``) step for step: norms
cast back to x's dtype before the weight multiply, RoPE angles in f32 with
the half-split rotation, and linear layers cast the weight to x's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.layered import Rope, Yarn
from repro_torch.kernels import ops
from repro_torch.models.sharding import current_rules, divides
from repro_torch.sp.common import as_axes


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def yarn_inv_freq(theta: float, hd: int, y: Yarn, device) -> torch.Tensor:
    """YaRN's inverse frequencies (hd/2,) in f32: dims rotating fewer than
    ``beta_slow`` times over the original context are interpolated (1 /
    (factor x theta^(2i/hd))), those rotating more than ``beta_fast`` times
    kept, and a linear ramp blends the dims between."""
    half = hd // 2

    def dim(rotations):   # the dim that turns `rotations` times over the context
        return hd * math.log(y.original_max_position_embeddings
                             / (rotations * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(dim(y.beta_fast)), 0)
    high = min(math.ceil(dim(y.beta_slow)), hd - 1)
    pos = theta ** (torch.arange(half, dtype=torch.float32, device=device) / half)
    ramp = ((torch.arange(half, dtype=torch.float32, device=device) - low)
            / ((high - low) or 0.001)).clamp(0, 1)
    return (1.0 / pos) * (1 - ramp) + (1.0 / (y.factor * pos)) * ramp


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         yarn: Optional[Yarn] = None) -> torch.Tensor:
    """x (..., S, n, hd), positions (..., S) or (S,).  With `yarn`, YaRN's
    frequencies (`yarn_inv_freq`) and cos and sin scaled by its attention
    factor."""
    hd = x.shape[-1]
    half = hd // 2
    if yarn is None:
        freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                              device=x.device) / half))
    else:
        freqs = yarn_inv_freq(theta, hd, yarn, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    if yarn is not None:
        cos, sin = cos * yarn.attention_factor, sin * yarn.attention_factor
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
                    write_cache: bool = False,
                    cross_kv: Optional[KVCache] = None,
                    cross_len: Optional[torch.Tensor] = None,
                    impl: str = "auto", attn_fn=None,
                    rot: Optional[Rope] = None):
    """Full-sequence attention (prefill).  x (B, S, d).  rot: the layer's
    RoPE (`configs.layered.layer_rope`; default: cfg.rope_theta's).

    write_cache: also return a KVCache of the projected K/V (B, KV, S, hd).
    cross_kv: attend to these K/V (B, KV, Skv, hd) instead (cross
    attention): no RoPE, not causal, keys up to ``cross_len`` (B,) if given,
    and no KVCache returned.
    attn_fn: replaces the core ``ops.attention(qh, kh, vh)`` call, called as
    ``attn_fn(qh, kh, vh, causal=..., sliding_window=...)`` — the hook the
    gang-SP path uses to keep projections, RoPE and residuals shared."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    if cross_kv is None:
        k = linear(x, p["wk"], p.get("bk")).reshape(B, S, KV, hd)
        v = linear(x, p["wv"], p.get("bv")).reshape(B, S, KV, hd)
        rot = rot or Rope(cfg.rope_theta)
        q = rope(q, positions, *rot)
        k = rope(k, positions, *rot)
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    else:
        kh, vh = cross_kv
        causal = False
    qh = q.transpose(1, 2)
    if attn_fn is None:
        o = ops.attention(qh, kh, vh, causal=causal,
                          sliding_window=sliding_window, kv_len=cross_len,
                          impl=impl)
    else:
        o = attn_fn(qh, kh, vh, causal=causal, sliding_window=sliding_window)
    out = linear(o.transpose(1, 2).reshape(B, S, H * hd), p["wo"])
    if write_cache and cross_kv is None:
        return out, KVCache(k=kh, v=vh)
    return out


def decode_attention_block(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                           x: torch.Tensor, cache: KVCache,
                           cache_len: torch.Tensor, *, sliding_window: int = 0,
                           ring_buffer: bool = False, cross: bool = False,
                           cross_len: Optional[torch.Tensor] = None,
                           impl: str = "auto", rot: Optional[Rope] = None):
    """One-token decode.  x (B, d); cache k/v (B, KV, S_max, hd); cache_len
    (B,) = tokens already cached.  Returns (out (B, d), cache).  rot: the
    layer's RoPE, as in `attention_block`.

    The new token's K/V is written IN PLACE into ``cache`` at each
    sequence's own position (an index write, where the reference rewrites
    the whole cache through a one-hot mask), so the returned cache is the
    same storage as the one passed in.
    ring_buffer: the sliding-window long-context mode — write at
    cache_len % S_max and attend over the min(cache_len + 1, S_max) keys the
    ring holds, with no window (the ring is the window).
    cross: attend to a fixed cross cache of ``cross_len`` (B,) keys: no
    write, no RoPE.
    """
    B, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = linear(x, p["wq"], p.get("bq")).reshape(B, H, hd)
    if cross:
        o = ops.decode_attention(q, cache.k, cache.v, cross_len, impl=impl)
        return linear(o.reshape(B, H * hd), p["wo"]), cache
    k = linear(x, p["wk"], p.get("bk")).reshape(B, KV, hd)
    v = linear(x, p["wv"], p.get("bv")).reshape(B, KV, hd)
    rot = rot or Rope(cfg.rope_theta)
    q = rope(q[:, None], cache_len[:, None], *rot)[:, 0]   # pos = len
    k = rope(k[:, None], cache_len[:, None], *rot)[:, 0]
    S_max = cache.k.shape[2]
    pos = cache_len % S_max if ring_buffer else cache_len
    rows = torch.arange(B, device=x.device)
    cache.k[rows, :, pos] = k.to(cache.k.dtype)
    cache.v[rows, :, pos] = v.to(cache.v.dtype)
    if ring_buffer:
        eff_len, window = torch.clamp(cache_len + 1, max=S_max), 0
    else:
        eff_len, window = cache_len + 1, sliding_window
    o = _cached_decode_attention(q, cache.k, cache.v, eff_len, window, impl)
    return linear(o.reshape(B, H * hd), p["wo"]), cache


def _cached_decode_attention(q, k, v, eff_len, sliding_window, impl):
    """Decode attention over a cache: when the active sharding rules shard
    the cache's sequence ("cache_seq") over mesh axes that divide its
    length, the sequence-sharded decode of `sp.decode` (each shard's
    partial in f32, merged by LSE across the shards) over the rules' mesh,
    as the reference's shard_map flash-decode; otherwise
    `ops.decode_attention`."""
    rules = current_rules()
    seq_axes = as_axes(rules.rules.get("cache_seq")) if rules is not None else ()
    if seq_axes and divides(rules.mesh, k.shape[2], seq_axes):
        from repro_torch.sp.decode import distributed_decode_attention
        return distributed_decode_attention(
            q, k, v, eff_len, mesh=rules.mesh, seq_axes=seq_axes,
            sliding_window=sliding_window,
            batch_axes=as_axes(rules.rules.get("batch")))
    return ops.decode_attention(q, k, v, eff_len, sliding_window=sliding_window,
                                impl=impl)


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
