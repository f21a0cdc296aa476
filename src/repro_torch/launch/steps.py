"""Step functions of the reference's ``launch/steps.py``: a train step
(loss, gradients, AdamW), a prefill step and a serve step, for any
(arch x shape).

The train step differentiates the plain PyTorch attention and SSD
(``impl="torch"``), as the reference's trains with ``impl="xla"``: the hand
kernels have no backward, nor do the reference's Pallas kernels.  The
prefill and serve steps run the hand kernels (``impl="auto"``); the serve
step of a sliding-window model at the long_500k shape decodes into a ring
buffer of one window.  Each builder takes the reference's ``mesh=``: the
step then runs under `standard_rules` of that mesh (train with fsdp, the
serving steps with long_context when the batch is one sequence), which
sends the serve step's decode attention over a sharded cache sequence to
the sequence-sharded decode (`layers._cached_decode_attention`).

Given `launch.partition.Sharded` arguments (`partition.shard_tree` over
the spec trees of `launch/shardings.py`), the three steps of every family
(`models/tp.FAMILIES`: moe with its experts over "model", the Mamba2 scan
over "model" by heads or rows, audio's encoder, decoder and cross cache)
run partitioned over the arguments' mesh, as XLA
partitions the reference's under its rules: each rank holds its shards and
runs `models/tp.py`'s body in lockstep with the others; the train step
under the fsdp rules (`partition.train`).  Whole tensors take the path
above.

`params_structs`, `opt_structs`, `batch_structs` and `cache_structs` are
the reference's ``ShapeDtypeStruct`` helpers: the same trees on the "meta"
device, shapes and dtypes without storage (`launch/dryrun.py`).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import partition
from repro_torch.models import model as mdl
from repro_torch.models.sharding import standard_rules, use_rules
from repro_torch.training.optimizer import adamw_init, adamw_update

AUDIO_DECODER_TRAIN_LEN = 512   # transcript length for enc-dec train batches
AUDIO_SELF_CACHE = 1024         # decoder self-KV budget (outputs <= 800)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full softmax attention at 524K context is quadratic; "
                       "run only for SSM/hybrid/SWA archs (DESIGN.md §4)")
    return True, ""


def ring_buffer(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether the serve step decodes into a ring of one window."""
    return bool(cfg.sliding_window) and shape.name == "long_500k"


def cache_lengths(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[int, int]:
    """(max_len, enc_len) of the serve step's cache, as the reference sizes
    it: a ring holds one window; audio's decoder AUDIO_SELF_CACHE positions
    and its cross cache the shape's frames."""
    S = shape.seq_len
    max_len = min(cfg.sliding_window, S) if ring_buffer(cfg, shape) else S
    if cfg.family == "audio":
        return AUDIO_SELF_CACHE, S
    return max_len, 0


def batch_structs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The step's batch on "meta": tokens (and labels) int32; vlm's patch
    embeddings and audio's frames in the model's dtype; decode one token
    per sequence."""
    B, S = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    i32, act = torch.int32, getattr(torch, cfg.dtype)
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            P = min(cfg.frontend_tokens, S // 2)
            out = {"tokens": sds((B, S - P), i32), "embeds": sds((B, P, cfg.d_model), act)}
        elif cfg.family == "audio":
            # the encoder takes the frames; the decoder teacher-forces a
            # transcript (train) or starts from BOS (prefill)
            dec = AUDIO_DECODER_TRAIN_LEN if shape.kind == "train" else 1
            out = {"tokens": sds((B, dec), i32), "frames": sds((B, S, cfg.d_model), act)}
        else:
            out = {"tokens": sds((B, S), i32)}
        if shape.kind == "train":
            out["labels"] = sds(out["tokens"].shape, i32)
        return out
    return {"token": sds((B,), i32)}


def cache_structs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    max_len, enc_len = cache_lengths(cfg, shape)
    return mdl.init_cache(cfg, shape.global_batch, max_len, enc_len=enc_len,
                          device="meta")


def params_structs(cfg: ModelConfig):
    return mdl.init_params(cfg, device="meta")


def opt_structs(params):
    return adamw_init(params)


def _rules(mesh, **kw):
    return standard_rules(mesh, **kw) if mesh is not None else None


def loss_and_grads(cfg: ModelConfig, params, batch: Dict[str, Any], *,
                   impl: str = "torch", remat: bool = True):
    """(loss, gradients as a tree like params): `loss_fn` and its gradient
    over every parameter.  The parameters require grad only inside."""
    leaves = mdl.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, _ = mdl.loss_fn(cfg, params, batch, impl=impl, remat=remat)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), mdl.tree_like(params, grads)


def build_train_step(cfg: ModelConfig, *, impl: str = "torch", remat: bool = True,
                     mesh=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}): `loss_and_grads` with remat, then one AdamW update in
    place.  With `Sharded` arguments (params cut by
    ``shardings.param_specs(fsdp=True)``, the optimizer state by
    `opt_specs`, the batch by `batch_specs`) the FSDP step partitioned over
    their mesh (`partition.train`: weights gathered per layer, gradients
    reduce-scattered back to their shards, AdamW on the shards, the global
    grad norm, a vocab-parallel loss); params and opt_state come back
    `Sharded`.  With whole tensors and `mesh`, the step runs under the
    mesh's fsdp rules, as the reference's; they steer nothing there (a
    train step never decodes)."""
    rules = _rules(mesh, fsdp=True)

    def train_step(params, opt_state, batch: Dict[str, Any]):
        if isinstance(params, partition.Sharded):
            return partition.train(cfg, params, opt_state, batch, impl=impl, remat=remat)
        with use_rules(rules):
            loss, grads = loss_and_grads(cfg, params, batch, impl=impl, remat=remat)
            params, opt_state, info = adamw_update(params, grads, opt_state)
            return params, opt_state, {"loss": loss, "grad_norm": info["grad_norm"]}
    return train_step


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *, impl: str = "auto",
                       mesh=None):
    """prefill_step(params, batch, cache) -> (last-token logits, cache);
    with `Sharded` arguments partitioned (`partition.prefill`)."""
    long_context = shape.global_batch == 1
    rules = _rules(mesh, long_context=long_context)

    def prefill_step(params, batch, cache):
        if isinstance(params, partition.Sharded):
            return partition.prefill(cfg, params, batch, cache, impl=impl,
                                     long_context=long_context)
        with use_rules(rules), torch.no_grad():
            return mdl.prefill(cfg, params, batch, cache, impl=impl)
    return prefill_step


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, *, impl: str = "auto",
                     mesh=None):
    """serve_step(params, cache, token) -> (logits, cache); with `Sharded`
    arguments partitioned (`partition.serve`)."""
    ring = ring_buffer(cfg, shape)
    long_context = shape.global_batch == 1
    rules = _rules(mesh, long_context=long_context)

    def serve_step(params, cache, token):
        if isinstance(params, partition.Sharded):
            return partition.serve(cfg, params, cache, token, impl=impl,
                                   ring_buffer=ring, long_context=long_context)
        with use_rules(rules), torch.no_grad():
            return mdl.decode_step(cfg, params, cache, token, impl=impl,
                                   ring_buffer=ring)
    return serve_step
