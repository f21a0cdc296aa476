"""Decoder models of the dense, ssm (Mamba2) and hybrid (Zamba2) families:
init / forward / prefill / decode_step over per-layer weight dicts (a Python
loop over layers where the reference scans a stacked L axis).

Parameters: {"embed" (V, d), "final_norm" (d,), "lm_head" (d, V), "layers":
[...one dict per layer...]}, each layer {"attn", "mlp", "ln1", "ln2"}
(dense) or {"mamba", "ln"} (ssm, hybrid); the hybrid adds ONE "shared"
{"attn", "mlp", "ln1", "ln2"} block, applied after every `attn_every`
Mamba2 layers.

Cache (dict), the reference's layout:
  len         (B,) int32                tokens already cached
  k, v        (L, B, KV, S_max, hd)     dense
  ssm         SSMState: conv (L, B, K-1, Cd), ssm (L, B, nh, hd, ns) f32
  sh_k, sh_v  (Ns, B, KV, S_max, hd)    hybrid, one per shared-block use
`prefill` and `decode_step` update these tensors in place (the reference
returns new arrays), so the cache returned is the storage passed in.  The
reference's ring-buffer mode is not ported: a prompt longer than S_max
raises.

The moe, audio and vlm families raise NotImplementedError until ROADMAP
Queue A8.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M

Params = Dict[str, Any]
FAMILIES = ("dense", "ssm", "hybrid")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A8); "
            f"the port serves the {', '.join(FAMILIES)} families")


def _segments(cfg: ModelConfig) -> int:
    """Hybrid: Mamba2 segments, each followed by the shared block."""
    assert cfg.num_layers % cfg.attn_every == 0, \
        "hybrid layers must be a multiple of attn_every"
    return cfg.num_layers // cfg.attn_every


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Params:
    """Random weights from a seeded generator on `device`, with the
    reference's distributions (it draws other numbers from the same seed;
    `bridge.params_from_jax` carries the reference's own weights)."""
    _require_ported(cfg)
    dt = _dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    d, V, nl = cfg.d_model, cfg.padded_vocab, cfg.num_layers

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)
    p: Params = {
        "embed": torch.randn((V, d), generator=gen, dtype=dt, device=device) * 0.02,
        "final_norm": ones(d),
        "lm_head": torch.randn((d, V), generator=gen, dtype=dt,
                               device=device) * d ** -0.5,
    }
    if cfg.family == "dense":
        p["layers"] = [{"attn": L.init_attn(gen, cfg, dt, device),
                        "mlp": L.init_mlp(gen, cfg, dt, device),
                        "ln1": ones(d), "ln2": ones(d)} for _ in range(nl)]
    else:
        p["layers"] = [{"mamba": M.init_mamba2(gen, cfg, dt, device),
                        "ln": ones(d)} for _ in range(nl)]
    if cfg.family == "hybrid":
        p["shared"] = {"attn": L.init_attn(gen, cfg, dt, device),
                       "mlp": L.init_mlp(gen, cfg, dt, device),
                       "ln1": ones(d), "ln2": ones(d)}
    return p


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


def _shared_block(cfg, ps, x, positions, *, impl, write_cache):
    """The hybrid's shared attention + MLP block (no sliding window)."""
    return _dense_layer(cfg, ps, x, positions, sliding_window=0, impl=impl,
                        write_cache=write_cache)


def _mamba_layer(cfg, pl, x, *, impl, write_cache):
    h = M.mamba2_block(cfg, pl["mamba"], L.rms_norm(x, pl["ln"], cfg.norm_eps),
                       return_state=write_cache, impl=impl)
    st = None
    if write_cache:
        h, st = h
    return x + h, st


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            impl: str = "auto", write_cache: bool = False,
            sliding_window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced full-sequence forward.  batch: tokens (B, S).
    Returns (logits (B, S, V), aux); with write_cache aux holds per-layer
    lists: "kv" (dense KVCache), "ssm" (SSMState) and "sh_kv" (hybrid
    KVCache, one per shared-block use)."""
    _require_ported(cfg)
    dt = _dtype(cfg)
    sw = cfg.sliding_window if sliding_window is None else sliding_window
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens].to(dt)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux: Dict[str, Any] = {}
    kvs, sts = [], []
    if cfg.family == "dense":
        for pl in params["layers"]:
            x, kv = _dense_layer(cfg, pl, x, positions, sliding_window=sw,
                                 impl=impl, write_cache=write_cache)
            kvs.append(kv)
    else:
        every = cfg.attn_every if cfg.family == "hybrid" else 0
        for li, pl in enumerate(params["layers"]):
            x, st = _mamba_layer(cfg, pl, x, impl=impl, write_cache=write_cache)
            sts.append(st)
            if every and (li + 1) % every == 0:
                x, kv = _shared_block(cfg, params["shared"], x, positions,
                                      impl=impl, write_cache=write_cache)
                kvs.append(kv)
    if write_cache:
        if cfg.family == "dense":
            aux["kv"] = kvs
        else:
            aux["ssm"] = sts
        if cfg.family == "hybrid":
            aux["sh_kv"] = kvs
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
    _require_ported(cfg)
    dt = _dtype(cfg)
    cache: Dict[str, Any] = {
        "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    kv_shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if cfg.family == "dense":
        cache["k"] = torch.zeros((cfg.num_layers,) + kv_shape, dtype=dt, device=device)
        cache["v"] = torch.zeros((cfg.num_layers,) + kv_shape, dtype=dt, device=device)
    else:
        cache["ssm"] = M.init_ssm_state(cfg, cfg.num_layers, batch, dt, device)
    if cfg.family == "hybrid":
        ns = _segments(cfg)
        cache["sh_k"] = torch.zeros((ns,) + kv_shape, dtype=dt, device=device)
        cache["sh_v"] = torch.zeros((ns,) + kv_shape, dtype=dt, device=device)
    return cache


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache: Dict[str, Any], *, impl: str = "auto",
            sliding_window: Optional[int] = None):
    """Full-sequence prefill: fills the cache in place (the KV prefix, or
    the SSM and conv states) and sets "len".  Returns (last-token logits
    (B, V), cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    for name in ("k", "sh_k"):
        if name in cache and S > cache[name].shape[3]:
            raise ValueError(f"prefill of {S} tokens exceeds the cache's "
                             f"{cache[name].shape[3]} (the ring buffer is "
                             "not ported)")
    logits, aux = forward(cfg, params, batch, impl=impl, write_cache=True,
                          sliding_window=sliding_window)
    for li, kv in enumerate(aux.get("kv", [])):
        cache["k"][li, :, :, :S] = kv.k
        cache["v"][li, :, :, :S] = kv.v
    for li, st in enumerate(aux.get("ssm", [])):
        cache["ssm"].conv[li].copy_(st.conv)
        cache["ssm"].ssm[li].copy_(st.ssm)
    for si, kv in enumerate(aux.get("sh_kv", [])):
        cache["sh_k"][si, :, :, :S] = kv.k
        cache["sh_v"][si, :, :, :S] = kv.v
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any],
                token: torch.Tensor, *, impl: str = "auto"):
    """token (B,) int -> (logits (B, V), cache).  One serve step; the new
    token's K/V and the new SSM/conv states are written into the cache in
    place, and cache["len"] advances by one."""
    _require_ported(cfg)
    dt = _dtype(cfg)
    x = params["embed"][token].to(dt)                        # (B, d)
    clen = cache["len"]
    if cfg.family == "dense":
        for li, pl in enumerate(params["layers"]):
            h, _ = L.decode_attention_block(
                cfg, pl["attn"], L.rms_norm(x, pl["ln1"], cfg.norm_eps),
                L.KVCache(cache["k"][li], cache["v"][li]), clen,
                sliding_window=cfg.sliding_window, impl=impl)
            x = x + h
            x = x + L.swiglu(L.rms_norm(x, pl["ln2"], cfg.norm_eps), pl["mlp"])
    else:
        every = cfg.attn_every if cfg.family == "hybrid" else 0
        conv, ssm = cache["ssm"]
        for li, pl in enumerate(params["layers"]):
            h, st = M.mamba2_step(cfg, pl["mamba"],
                                  L.rms_norm(x, pl["ln"], cfg.norm_eps),
                                  M.SSMState(conv[li], ssm[li]))
            conv[li].copy_(st.conv)
            ssm[li].copy_(st.ssm)
            x = x + h
            if every and (li + 1) % every == 0:
                si = (li + 1) // every - 1
                ps = params["shared"]
                h, _ = L.decode_attention_block(
                    cfg, ps["attn"], L.rms_norm(x, ps["ln1"], cfg.norm_eps),
                    L.KVCache(cache["sh_k"][si], cache["sh_v"][si]), clen,
                    impl=impl)
                x = x + h
                x = x + L.swiglu(L.rms_norm(x, ps["ln2"], cfg.norm_eps), ps["mlp"])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _mask_padded_vocab(cfg, torch.matmul(x, params["lm_head"].to(dt)))
    cache["len"] = clen + 1
    return logits, cache
