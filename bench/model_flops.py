"""Model FLOPs of the work the engines did, counted from shapes alone, for the
whole step's share of the chip's peak (the ``mfu.*`` metrics).

Per token and layer: 2 FLOPs per weight of the layer's matrices (q, k, v and
o projections and the three SwiGLU matrices), plus 4 * H * hd per query-key
pair that the query sees (the QK^T and PV products); per token whose logits
are computed, 2 * d * vocab for the head.  Work a step does for an idle
decode lane, or for the padded vocabulary, is not the model's and is not
counted.
"""
from __future__ import annotations

from typing import Dict


def visible_pairs(S: int, P: int, W: int) -> int:
    """Query-key pairs seen by S queries at positions P..P+S-1, causal,
    within a window of W keys counting the query itself (W = 0: none)."""
    if not W:
        return S * P + S * (S + 1) // 2
    n1 = max(0, min(P + S, W) - P)           # queries that see every key
    return n1 * P + n1 * (n1 + 1) // 2 + (S - n1) * W


def layer_weights(c: Dict) -> int:
    d, hd, ff = c["d_model"], c["head_dim"], c["d_ff"]
    H, KV = c["num_heads"], c["num_kv_heads"]
    return d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff


def prefill_flops(c: Dict, S: int, P: int, layers: int, logits: bool) -> int:
    """A prefill quantum: `layers` layers over S new tokens after P cached
    ones, and the head on the last token when `logits`."""
    attn = 4 * c["num_heads"] * c["head_dim"] * visible_pairs(
        S, P, c["sliding_window"])
    head = 2 * c["d_model"] * c["vocab_size"] if logits else 0
    return layers * (2 * S * layer_weights(c) + attn) + head


def decode_flops(c: Dict, cached: int) -> int:
    """One decode token after `cached` tokens, through every layer and the
    head."""
    attn = 4 * c["num_heads"] * c["head_dim"] * visible_pairs(
        1, cached, c["sliding_window"])
    return (c["num_layers"] * (2 * layer_weights(c) + attn)
            + 2 * c["d_model"] * c["vocab_size"])
