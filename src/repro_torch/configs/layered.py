"""A config whose layers differ in their attention: a window and a RoPE per
layer (the port's own; ``configs/base.py`` stays the reference's copy).

`LayeredConfig` adds to `ModelConfig` one window per layer (0: full
causal attention) and the YaRN parameters of the full layers' RoPE, as a
config with ``layer_types`` of ``sliding_attention`` and ``full_attention``
and a ``rope_parameters`` section per type publishes them.  The base
``sliding_window`` stays 0: the model as a whole keeps every position, so
it has no ring buffer to decode into and no long_500k serve step.

`layer_window` and `layer_rope` give what a layer runs with.  For a plain
`ModelConfig` they give ``cfg.sliding_window`` and the default RoPE at
``cfg.rope_theta``, so every other config keeps its arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

from repro_torch.configs.base import ModelConfig


class Yarn(NamedTuple):
    """YaRN's rescaled RoPE (the ``rope_type: yarn`` parameters)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    attention_factor: float


class Rope(NamedTuple):
    """A layer's rotary embedding: base theta, and YaRN or None (default)."""
    theta: float
    yarn: Optional[Yarn] = None


@dataclass(frozen=True)
class LayeredConfig(ModelConfig):
    #: one window per layer, counting the query itself; 0 = full attention
    layer_windows: Tuple[int, ...] = ()
    #: the RoPE of the full layers (window 0); the windowed layers take the
    #: default RoPE at ``rope_theta``
    full_rope: Optional[Rope] = None

    def __post_init__(self):
        super().__post_init__()
        assert len(self.layer_windows) == self.num_layers, \
            "one window per layer"


def layer_window(cfg: ModelConfig, li: int) -> int:
    """The keys layer `li` attends to, counting the query itself (0: all)."""
    if isinstance(cfg, LayeredConfig):
        return cfg.layer_windows[li]
    return cfg.sliding_window


def layer_rope(cfg: ModelConfig, li: int) -> Rope:
    """The rotary embedding of layer `li`."""
    if isinstance(cfg, LayeredConfig) and cfg.full_rope is not None \
            and not cfg.layer_windows[li]:
        return cfg.full_rope
    return Rope(cfg.rope_theta)
