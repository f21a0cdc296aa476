"""Step functions of the reference's ``launch/steps.py``: a train step
(loss, gradients, AdamW), a prefill step and a serve step, for any
(arch x shape).

The train step differentiates the plain PyTorch attention and SSD
(``impl="torch"``), as the reference's trains with ``impl="xla"``: the hand
kernels have no backward, nor do the reference's Pallas kernels.  The
prefill and serve steps run the hand kernels (``impl="auto"``); the serve
step of a sliding-window model at the long_500k shape decodes into a ring
buffer of one window.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as mdl
from repro_torch.training.optimizer import adamw_update

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


def build_train_step(cfg: ModelConfig, *, impl: str = "torch", remat: bool = True):
    """train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"}): `loss_and_grads` with remat, then one AdamW update in
    place."""
    def train_step(params, opt_state, batch: Dict[str, Any]):
        loss, grads = loss_and_grads(cfg, params, batch, impl=impl, remat=remat)
        params, opt_state, info = adamw_update(params, grads, opt_state)
        return params, opt_state, {"loss": loss, "grad_norm": info["grad_norm"]}
    return train_step


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *, impl: str = "auto"):
    def prefill_step(params, batch, cache):
        with torch.no_grad():
            return mdl.prefill(cfg, params, batch, cache, impl=impl)
    return prefill_step


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, *, impl: str = "auto"):
    ring = ring_buffer(cfg, shape)

    def serve_step(params, cache, token):
        with torch.no_grad():
            return mdl.decode_step(cfg, params, cache, token, impl=impl,
                                   ring_buffer=ring)
    return serve_step
