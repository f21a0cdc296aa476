"""Models of the reference's six families (dense, moe, ssm, hybrid, audio
enc-dec, vlm): init / forward / prefill / decode_step over per-layer weight
dicts (a Python loop over layers where the reference scans a stacked L
axis).

Parameters: {"embed" (V, d), "final_norm" (d,), "lm_head" (d, V), "layers":
[...one dict per layer...]}, each layer {"attn", "mlp", "ln1", "ln2"}
(dense, vlm), {"attn", "moe", "ln1", "ln2"} (moe), {"mamba", "ln"} (ssm,
hybrid) or the audio decoder's {"attn", "xattn", "mlp", "ln1", "ln2",
"ln3"}.  The hybrid adds ONE "shared" {"attn", "mlp", "ln1", "ln2"} block,
applied after every `attn_every` Mamba2 layers; audio adds "encoder" (one
{"attn", "mlp", "ln1", "ln2"} per encoder layer) and "enc_norm" (d,).

Cache (dict), the reference's layout:
  len         (B,) int32                tokens already cached
  k, v        (L, B, KV, S_max, hd)     dense, moe, vlm, audio (decoder)
  ssm         SSMState: conv (L, B, K-1, Cd), ssm (L, B, nh, hd, ns) f32
  sh_k, sh_v  (Ns, B, KV, S_max, hd)    hybrid, one per shared-block use
  cross_k, cross_v (L, B, KV, F, hd)    audio cross attention (fixed)
  cross_len   (B,) int32
`prefill` and `decode_step` update these tensors in place (the reference
returns new arrays), so the cache returned is the storage passed in.  A
prefill longer than a cache keeps its most recent S_max positions, token t
at slot t % S_max: the sliding-window ring buffer that
`decode_step(ring_buffer=True)` continues.

Training: `loss_fn` (next-token cross entropy, chunked over the sequence)
and `forward(remat=True)`, which runs each layer body (hybrid: each
segment) under an activation checkpoint where the reference puts
``jax.checkpoint``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.layered import LayeredConfig, layer_rope, layer_window
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE

Params = Dict[str, Any]
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _segments(cfg: ModelConfig) -> int:
    """Hybrid: Mamba2 segments, each followed by the shared block."""
    assert cfg.num_layers % cfg.attn_every == 0, \
        "hybrid layers must be a multiple of attn_every"
    return cfg.num_layers // cfg.attn_every


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Params:
    """Random weights from a seeded generator on `device`, with the
    reference's distributions (it draws other numbers from the same seed;
    `bridge.params_from_jax` carries the reference's own weights).  On the
    "meta" device nothing is drawn: the tree holds each weight's shape and
    dtype only (`launch.steps.params_structs`)."""
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown model family {fam!r}")
    dt = _dtype(cfg)
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    d, V, nl = cfg.d_model, cfg.padded_vocab, cfg.num_layers

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def block(**extra):
        return dict({"attn": L.init_attn(gen, cfg, dt, device),
                     "mlp": L.init_mlp(gen, cfg, dt, device),
                     "ln1": ones(d), "ln2": ones(d)}, **extra)
    p: Params = {
        "embed": torch.randn((V, d), generator=gen, dtype=dt, device=device) * 0.02,
        "final_norm": ones(d),
        "lm_head": torch.randn((d, V), generator=gen, dtype=dt,
                               device=device) * d ** -0.5,
    }
    if fam in ("dense", "vlm"):
        p["layers"] = [block() for _ in range(nl)]
    elif fam == "moe":
        p["layers"] = [{"attn": L.init_attn(gen, cfg, dt, device),
                        "moe": MOE.init_moe(gen, cfg, dt, device),
                        "ln1": ones(d), "ln2": ones(d)} for _ in range(nl)]
    elif fam == "audio":
        p["encoder"] = [block() for _ in range(cfg.encoder_layers)]
        p["enc_norm"] = ones(d)
        p["layers"] = [block(xattn=L.init_attn(gen, cfg, dt, device), ln3=ones(d))
                       for _ in range(nl)]
    else:
        p["layers"] = [{"mamba": M.init_mamba2(gen, cfg, dt, device),
                        "ln": ones(d)} for _ in range(nl)]
    if fam == "hybrid":
        p["shared"] = block()
    return p


def moe_window(cfg: ModelConfig, li: int) -> int:
    """The window of moe layer `li` in `forward`: its own where the config
    sets one per layer; none for a plain config, whose moe layers the
    reference's forward runs without its ``sliding_window`` (a plain moe
    config given a window keeps it for its cache's ring alone, as the
    ring-buffer decode's parity with the reference needs)."""
    return layer_window(cfg, li) if isinstance(cfg, LayeredConfig) else 0


def _remat(fn, remat: bool):
    """fn, or fn under an activation checkpoint: the backward recomputes the
    body's activations from its inputs (the reference's jax.checkpoint)."""
    return functools.partial(checkpoint, fn, use_reentrant=False) if remat else fn


def _dense_layer(cfg, pl, x, positions, *, sliding_window, impl, write_cache,
                 attn_fn=None, rot=None):
    h = L.attention_block(cfg, pl["attn"], L.rms_norm(x, pl["ln1"], cfg.norm_eps),
                          positions, sliding_window=sliding_window,
                          write_cache=write_cache, impl=impl, attn_fn=attn_fn,
                          rot=rot)
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


def _hybrid_segment(cfg, pls, ps, x, positions, *, impl, write_cache):
    """`attn_every` Mamba2 layers, then the shared block: one segment, the
    reference's unit of remat."""
    sts = []
    for pl in pls:
        x, st = _mamba_layer(cfg, pl, x, impl=impl, write_cache=write_cache)
        sts.append(st)
    x, kv = _shared_block(cfg, ps, x, positions, impl=impl, write_cache=write_cache)
    return x, sts, kv


def _moe_layer(cfg, pl, x, positions, *, impl, write_cache, moe_cf=None,
               sliding_window=0, rot=None, attn_fn=None, live=None, aux=True):
    """Attention, then the moe block: (x, KV or None, the block's aux or
    None).  live (B, S): the rows that are tokens (`moe.expert_partial`)."""
    h = L.attention_block(cfg, pl["attn"], L.rms_norm(x, pl["ln1"], cfg.norm_eps),
                          positions, sliding_window=sliding_window,
                          write_cache=write_cache, impl=impl, attn_fn=attn_fn,
                          rot=rot)
    kv = None
    if write_cache:
        h, kv = h
    x = x + h
    y, a = MOE.moe_block(cfg, pl["moe"], L.rms_norm(x, pl["ln2"], cfg.norm_eps),
                         capacity_factor=moe_cf, live=live, impl=impl, aux=aux)
    return x + y, kv, a


def serve_layer(cfg: ModelConfig, params: Params, li: int, x: torch.Tensor,
                positions: torch.Tensor, *, impl: str = "auto", attn_fn=None,
                live: Optional[torch.Tensor] = None):
    """Layer `li` of a dense, vlm or moe stack as a serving prefill runs it:
    its own window and RoPE (`configs.layered`), the K/V kept: (x, KVCache
    (B, KV, S, hd)).  attn_fn: the core attention's hook (`attention_block`;
    a suffix prefill puts the cached prefix before the keys there).  live
    (B, S): the rows that are tokens, for moe (pad rows take no expert)."""
    pl = params["layers"][li]
    kw = dict(sliding_window=layer_window(cfg, li), rot=layer_rope(cfg, li),
              impl=impl, write_cache=True, attn_fn=attn_fn)
    if cfg.family == "moe":
        x, kv, _ = _moe_layer(cfg, pl, x, positions, live=live, aux=False, **kw)
        return x, kv
    return _dense_layer(cfg, pl, x, positions, **kw)


def _project_cross(cfg: ModelConfig, p, enc_out: torch.Tensor) -> L.KVCache:
    """Encoder output (B, F, d) to one decoder layer's cross K/V (B, KV, F, hd)."""
    B, F, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    k = L.linear(enc_out, p["wk"], p.get("bk")).reshape(B, F, KV, hd)
    v = L.linear(enc_out, p["wv"], p.get("bv")).reshape(B, F, KV, hd)
    return L.KVCache(k=k.transpose(1, 2), v=v.transpose(1, 2))


def _encoder_layer(cfg, pl, enc, enc_pos, *, impl):
    enc = enc + L.attention_block(cfg, pl["attn"],
                                  L.rms_norm(enc, pl["ln1"], cfg.norm_eps),
                                  enc_pos, causal=False, impl=impl)
    return enc + L.swiglu(L.rms_norm(enc, pl["ln2"], cfg.norm_eps), pl["mlp"])


def _decoder_layer(cfg, pl, x, positions, enc_out, *, impl, write_cache):
    """Causal self attention, cross attention onto K/V projected from the
    encoder output, SwiGLU.  Returns (x, self KV or None, cross KV)."""
    h = L.attention_block(cfg, pl["attn"], L.rms_norm(x, pl["ln1"], cfg.norm_eps),
                          positions, write_cache=write_cache, impl=impl)
    kv = None
    if write_cache:
        h, kv = h
    x = x + h
    cross = _project_cross(cfg, pl["xattn"], enc_out)
    x = x + L.attention_block(cfg, pl["xattn"], L.rms_norm(x, pl["ln2"], cfg.norm_eps),
                              positions, cross_kv=cross, impl=impl)
    x = x + L.swiglu(L.rms_norm(x, pl["ln3"], cfg.norm_eps), pl["mlp"])
    return x, kv, cross


def _audio(cfg, params, frames, x, positions, *, impl, write_cache, remat, aux):
    """The encoder over `frames` (not causal, RoPE on frame positions), then
    the decoder over x."""
    enc = frames.to(x.dtype)
    B, F, _ = enc.shape
    enc_pos = torch.arange(F, device=enc.device)[None].expand(B, F)
    enc_fn = _remat(_encoder_layer, remat)
    for pl in params["encoder"]:
        enc = enc_fn(cfg, pl, enc, enc_pos, impl=impl)
    enc_out = L.rms_norm(enc, params["enc_norm"], cfg.norm_eps)
    aux["enc_out"] = enc_out
    dec_fn = _remat(_decoder_layer, remat)
    kvs, crosses = [], []
    for pl in params["layers"]:
        x, kv, cross = dec_fn(cfg, pl, x, positions, enc_out, impl=impl,
                              write_cache=write_cache)
        kvs.append(kv)
        crosses.append(cross)
    if write_cache:
        aux["kv"], aux["cross_kv"] = kvs, crosses
    return x


def forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            impl: str = "auto", remat: bool = False, write_cache: bool = False,
            sliding_window: Optional[int] = None, moe_cf: Optional[float] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced full-sequence forward.  batch: tokens (B, S) [,
    embeds (B, P, d) for vlm, prepended to the tokens][, frames (B, F, d)
    for audio, the encoder's input].  Returns (logits (B, S, V), aux): moe
    adds "lb_loss" and "dropped_frac" (means over layers), audio "enc_out";
    with write_cache aux also holds per-layer lists: "kv" (KVCache over the
    P + S positions), "ssm" (SSMState), "sh_kv" (hybrid, one per
    shared-block use) and "cross_kv" (audio).  remat: each layer body (the
    hybrid: each segment; audio: each encoder and decoder layer) runs under
    an activation checkpoint.  A dense, vlm or moe layer attends within its
    own window with its own RoPE (`configs.layered`); `sliding_window`,
    where given, replaces the dense and vlm layers' windows."""
    fam = cfg.family
    dt = _dtype(cfg)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = params["embed"][tokens].to(dt)
    n_prefix = 0
    if fam == "vlm":
        emb = batch["embeds"].to(dt)
        x = torch.cat([emb, x], 1)
        n_prefix = emb.shape[1]
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux: Dict[str, Any] = {}
    kvs, sts = [], []
    if fam in ("dense", "vlm"):
        layer = _remat(_dense_layer, remat)
        for li, pl in enumerate(params["layers"]):
            x, kv = layer(cfg, pl, x, positions, impl=impl,
                          sliding_window=layer_window(cfg, li) if sliding_window is None
                          else sliding_window,
                          write_cache=write_cache, rot=layer_rope(cfg, li))
            kvs.append(kv)
    elif fam == "moe":
        layer = _remat(_moe_layer, remat)
        moe_aux = []
        for li, pl in enumerate(params["layers"]):
            x, kv, a = layer(cfg, pl, x, positions, impl=impl,
                             write_cache=write_cache, moe_cf=moe_cf,
                             sliding_window=moe_window(cfg, li),
                             rot=layer_rope(cfg, li))
            kvs.append(kv)
            moe_aux.append(a)
        for name in ("lb_loss", "dropped_frac"):
            aux[name] = torch.stack([a[name] for a in moe_aux]).mean()
    elif fam == "audio":
        x = _audio(cfg, params, batch["frames"], x, positions, impl=impl,
                   write_cache=write_cache, remat=remat, aux=aux)
    elif fam == "hybrid":
        every = cfg.attn_every
        segment = _remat(_hybrid_segment, remat)
        for si in range(_segments(cfg)):
            x, seg_sts, kv = segment(cfg, params["layers"][si * every:(si + 1) * every],
                                     params["shared"], x, positions, impl=impl,
                                     write_cache=write_cache)
            sts += seg_sts
            kvs.append(kv)
    else:
        layer = _remat(_mamba_layer, remat)
        for pl in params["layers"]:
            x, st = layer(cfg, pl, x, impl=impl, write_cache=write_cache)
            sts.append(st)
    if write_cache:
        if fam in ("dense", "vlm", "moe"):
            aux["kv"] = kvs
        elif fam in ("ssm", "hybrid"):
            aux["ssm"] = sts
        if fam == "hybrid":
            aux["sh_kv"] = kvs
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)[:, n_prefix:]
    logits = torch.matmul(x, params["lm_head"].to(dt))
    return _mask_padded_vocab(cfg, logits), aux


def _chunk_nll(logits: torch.Tensor, labels: torch.Tensor):
    """Summed f32 negative log-likelihood of the labels >= 0, and their count."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels >= 0
    safe = torch.where(valid, labels, 0)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * valid).sum(), valid.sum()


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            impl: str = "auto", remat: bool = False, loss_chunk: int = 512):
    """Mean next-token cross entropy over the labels >= 0 (default: the
    tokens shifted left, the last position -1), + 0.01 x the load-balance
    loss for moe.  The f32 log-softmax runs over chunks of the largest
    divisor of S at or below `loss_chunk` positions, each under a checkpoint,
    so the backward never holds the whole (B, S, V) in f32.  Returns (loss,
    aux) with aux["ce_loss"] (the loss, as the reference sets it).  Training
    asks for impl="torch": the hand kernels have no backward."""
    logits, aux = forward(cfg, params, batch, impl=impl, remat=remat)
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        labels = F.pad(tokens[:, 1:], (0, 1), value=-1)
    S = logits.shape[1]
    ck = min(loss_chunk, S)
    while S % ck:
        ck -= 1
    nll = _remat(_chunk_nll, torch.is_grad_enabled() and logits.requires_grad)
    sums, counts = zip(*(nll(logits[:, i:i + ck], labels[:, i:i + ck])
                         for i in range(0, S, ck)))
    loss = torch.stack(sums).sum() / torch.stack(counts).sum().clamp_min(1)
    if "lb_loss" in aux:
        loss = loss + 0.01 * aux["lb_loss"]
    aux["ce_loss"] = loss
    return loss, aux


def param_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params-shaped tree, depth first in key order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in param_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def tree_like(tree, leaves):
    """`tree`'s structure over `leaves`, taken in `param_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    return build(tree)


def param_count(params: Params) -> int:
    """Elements over every leaf of the tree."""
    return sum(t.numel() for t in param_leaves(params))


def _mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor,
                       offset: int = 0) -> torch.Tensor:
    """Vocab is padded to a multiple of 256 (ModelConfig.padded_vocab);
    padding positions never win softmax/argmax.  `logits` holds the vocab
    columns from `offset` on (a vocab-parallel slice)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = offset + torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 0,
               device="cuda") -> Dict[str, Any]:
    """An empty cache for `batch` sequences of up to `max_len` positions
    (vlm: patch embeddings included) and, for audio, `enc_len` frames."""
    fam = cfg.family
    dt = _dtype(cfg)
    cache: Dict[str, Any] = {
        "len": torch.zeros((batch,), dtype=torch.int32, device=device)}

    def kv(n, length):
        return torch.zeros((n, batch, cfg.num_kv_heads, length, cfg.head_dim),
                           dtype=dt, device=device)
    if fam in ("dense", "vlm", "moe", "audio"):
        cache["k"], cache["v"] = kv(cfg.num_layers, max_len), kv(cfg.num_layers, max_len)
    if fam in ("ssm", "hybrid"):
        cache["ssm"] = M.init_ssm_state(cfg, cfg.num_layers, batch, dt, device)
    if fam == "hybrid":
        ns = _segments(cfg)
        cache["sh_k"], cache["sh_v"] = kv(ns, max_len), kv(ns, max_len)
    if fam == "audio":
        cache["cross_k"] = kv(cfg.num_layers, enc_len)
        cache["cross_v"] = kv(cfg.num_layers, enc_len)
        cache["cross_len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return cache


def _prefix_slots(src: torch.Tensor, S_max: int) -> torch.Tensor:
    """What a cache of S_max slots holds from slot 0 after a prefill of src
    (B, KV, S, hd) from position 0: src itself, or past S_max the
    sliding-window ring buffer: the most recent S_max positions, rolled so
    that token t sits at slot t % S_max (decode writes at
    cache_len % S_max)."""
    S = src.shape[2]
    if S <= S_max:
        return src
    return torch.roll(src[:, :, S - S_max:], S % S_max, dims=2)


def _write_prefix(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst (B, KV, S_max, hd) <- src (B, KV, S, hd) from position 0, in the
    slots `_prefix_slots` gives."""
    slots = _prefix_slots(src, dst.shape[2])
    dst[:, :, :slots.shape[2]] = slots


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            cache: Dict[str, Any], *, impl: str = "auto",
            sliding_window: Optional[int] = None, moe_cf: Optional[float] = None):
    """Full-sequence prefill: fills the cache in place (the KV prefix over
    the P + S positions, the SSM and conv states, the cross K/V) and sets
    "len" (and "cross_len").  A sequence longer than a cache keeps its
    most recent positions in ring order (`_write_prefix`).  Returns
    (last-token logits (B, V), cache).  For audio, batch["frames"] is
    encoded and only BOS enters the decoder: batch["tokens"] is then (B, 1).
    A model without a sliding window raises on a sequence longer than its
    self-attention cache: it has no ring to decode into."""
    S = batch["tokens"].shape[1] + (batch["embeds"].shape[1]
                                    if cfg.family == "vlm" else 0)
    S_max = min([cache[n].shape[3] for n in ("k", "sh_k") if n in cache],
                default=S)
    if S > S_max and not cfg.sliding_window:
        raise ValueError(
            f"a prefill of {S} positions exceeds the cache of {S_max}: only a "
            "sliding-window model keeps its most recent positions in a ring buffer")
    logits, aux = forward(cfg, params, batch, impl=impl, write_cache=True,
                          sliding_window=sliding_window, moe_cf=moe_cf)
    B = batch["tokens"].shape[0]
    for kname, vname, kvs in (("k", "v", aux.get("kv", [])),
                              ("sh_k", "sh_v", aux.get("sh_kv", [])),
                              ("cross_k", "cross_v", aux.get("cross_kv", []))):
        for li, kv in enumerate(kvs):
            _write_prefix(cache[kname][li], kv.k)
            _write_prefix(cache[vname][li], kv.v)
    for li, st in enumerate(aux.get("ssm", [])):
        cache["ssm"].conv[li].copy_(st.conv)
        cache["ssm"].ssm[li].copy_(st.ssm)
    if "cross_kv" in aux:
        cache["cross_len"].fill_(aux["enc_out"].shape[1])
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=logits.device)
    return logits[:, -1], cache


def decode_step(cfg: ModelConfig, params: Params, cache: Dict[str, Any],
                token: torch.Tensor, *, impl: str = "auto",
                ring_buffer: bool = False,
                active: Optional[torch.Tensor] = None):
    """token (B,) int -> (logits (B, V), cache).  One serve step; the new
    token's K/V and the new SSM/conv states are written into the cache in
    place, and cache["len"] advances by one.  moe routes with the capacity
    factor min(decode_capacity_factor, E).  ring_buffer: the self-attention
    caches of the dense, vlm and moe layers and the hybrid's shared block
    are rings (written at len % S_max, attended in full, no window), as the
    reference passes it; audio's decoder keeps its linear cache.  Each
    layer attends within its own window with its own RoPE
    (`configs.layered`).  active (B,) bool: the lanes that decode a
    request; moe gives the others no expert."""
    fam = cfg.family
    dt = _dtype(cfg)
    x = params["embed"][token].to(dt)                        # (B, d)
    clen = cache["len"]
    eps = cfg.norm_eps
    if fam in ("dense", "vlm", "moe", "audio"):
        for li, pl in enumerate(params["layers"]):
            ring = ring_buffer and fam != "audio"
            h, _ = L.decode_attention_block(
                cfg, pl["attn"], L.rms_norm(x, pl["ln1"], eps),
                L.KVCache(cache["k"][li], cache["v"][li]), clen,
                sliding_window=0 if fam == "audio" or ring else layer_window(cfg, li),
                ring_buffer=ring, impl=impl, rot=layer_rope(cfg, li))
            x = x + h
            if fam == "audio":
                h, _ = L.decode_attention_block(
                    cfg, pl["xattn"], L.rms_norm(x, pl["ln2"], eps),
                    L.KVCache(cache["cross_k"][li], cache["cross_v"][li]), clen,
                    cross=True, cross_len=cache["cross_len"], impl=impl)
                x = x + h
                x = x + L.swiglu(L.rms_norm(x, pl["ln3"], eps), pl["mlp"])
            elif fam == "moe":
                y, _ = MOE.moe_block(cfg, pl["moe"],
                                     L.rms_norm(x, pl["ln2"], eps)[:, None],
                                     capacity_factor=min(float(cfg.decode_capacity_factor),
                                                         float(cfg.num_experts)),
                                     live=None if active is None else active[:, None],
                                     impl=impl, aux=False)
                x = x + y[:, 0]
            else:
                x = x + L.swiglu(L.rms_norm(x, pl["ln2"], eps), pl["mlp"])
    else:
        every = cfg.attn_every if fam == "hybrid" else 0
        conv, ssm = cache["ssm"]
        for li, pl in enumerate(params["layers"]):
            h, st = M.mamba2_step(cfg, pl["mamba"], L.rms_norm(x, pl["ln"], eps),
                                  M.SSMState(conv[li], ssm[li]))
            conv[li].copy_(st.conv)
            ssm[li].copy_(st.ssm)
            x = x + h
            if every and (li + 1) % every == 0:
                si = (li + 1) // every - 1
                ps = params["shared"]
                h, _ = L.decode_attention_block(
                    cfg, ps["attn"], L.rms_norm(x, ps["ln1"], eps),
                    L.KVCache(cache["sh_k"][si], cache["sh_v"][si]), clen,
                    ring_buffer=ring_buffer, impl=impl)
                x = x + h
                x = x + L.swiglu(L.rms_norm(x, ps["ln2"], eps), ps["mlp"])
    x = L.rms_norm(x, params["final_norm"], eps)
    logits = _mask_padded_vocab(cfg, torch.matmul(x, params["lm_head"].to(dt)))
    cache["len"] = clen + 1
    return logits, cache
