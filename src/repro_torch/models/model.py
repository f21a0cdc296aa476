"""Dense decoder model: init / forward / decode_step over per-layer weight
dicts (a Python loop over layers where the reference scans a stacked L axis).

Parameters: {"embed" (V, d), "final_norm" (d,), "lm_head" (d, V),
"layers": [{"attn": {...}, "mlp": {...}, "ln1": (d,), "ln2": (d,)}, ...]}.

Cache (dict): "len" (B,) int32 tokens already cached, and "k"/"v"
(L, B, KV, S_max, hd).  `decode_step` updates "k"/"v" in place.

Only the dense family is ported; the other families of the reference raise
NotImplementedError until ROADMAP Queue A8.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A8); "
            "the port serves the dense family")


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Params:
    """Random weights from a seeded generator on `device`, with the
    reference's distributions (it draws other numbers from the same seed;
    `bridge.params_from_jax` carries the reference's own weights)."""
    _require_dense(cfg)
    dt = _dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, V, nl = cfg.d_model, cfg.padded_vocab, cfg.num_layers

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)
    return {
        "embed": torch.randn((V, d), generator=gen, dtype=dt, device=device) * 0.02,
        "final_norm": ones(d),
        "lm_head": torch.randn((d, V), generator=gen, dtype=dt,
                               device=device) * d ** -0.5,
        "layers": [{"attn": L.init_attn(gen, cfg, dt, device),
                    "mlp": L.init_mlp(gen, cfg, dt, device),
                    "ln1": ones(d), "ln2": ones(d)} for _ in range(nl)],
    }


def _dense_layer(cfg, pl, x, positions, *, sliding_window, impl, write_cache,
                 attn_fn=None):
    h = L.attention_block(cfg, pl["attn"], L.rms_norm(x, pl["ln1"], cfg.norm_eps),
                          positions, sliding_window=sliding_window,
                          write_cache=write_cache, impl=impl, attn_fn=attn_fn)
    kv = None
    if write_cache:
        h, kv = h
    x = x + h
    x = x + L.swiglu(L.rms_norm(x, pl["ln2"], cfg.norm_eps), pl["mlp"])
    return x, kv


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            impl: str = "auto", write_cache: bool = False,
            sliding_window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced full-sequence forward.  batch: tokens (B, S).
    Returns (logits (B, S, V), aux); with write_cache aux["kv"] holds the
    per-layer KVCache list."""
    _require_dense(cfg)
    dt = _dtype(cfg)
    sw = cfg.sliding_window if sliding_window is None else sliding_window
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens].to(dt)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    kvs = []
    for pl in params["layers"]:
        x, kv = _dense_layer(cfg, pl, x, positions, sliding_window=sw,
                             impl=impl, write_cache=write_cache)
        kvs.append(kv)
    aux: Dict[str, Any] = {}
    if write_cache:
        aux["kv"] = kvs
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(x, params["lm_head"].to(dt))
    return _mask_padded_vocab(cfg, logits), aux


def _mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Vocab is padded to a multiple of 256 (ModelConfig.padded_vocab);
    padding positions never win softmax/argmax."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> Dict[str, Any]:
    _require_dense(cfg)
    dt = _dtype(cfg)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"len": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any],
                token: torch.Tensor, *, impl: str = "auto"):
    """token (B,) int -> (logits (B, V), cache).  One serve step; the new
    token's K/V is written into cache["k"]/["v"] in place and cache["len"]
    advances by one."""
    _require_dense(cfg)
    dt = _dtype(cfg)
    x = params["embed"][token].to(dt)                        # (B, d)
    clen = cache["len"]
    for li, pl in enumerate(params["layers"]):
        h, _ = L.decode_attention_block(
            cfg, pl["attn"], L.rms_norm(x, pl["ln1"], cfg.norm_eps),
            L.KVCache(cache["k"][li], cache["v"][li]), clen,
            sliding_window=cfg.sliding_window, impl=impl)
        x = x + h
        x = x + L.swiglu(L.rms_norm(x, pl["ln2"], cfg.norm_eps), pl["mlp"])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, torch.matmul(x, params["lm_head"].to(dt)))
    cache["len"] = clen + 1
    return logits, cache

