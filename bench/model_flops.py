"""The attention's share of the model FLOPs, counted from shapes alone, for
the whole step's share of the chip's peak (the ``mfu`` metrics) and B1's
roofline.  A model's own count, layer by layer, is its module's
(``models/<kind>.py``: ``prefill_flops``, ``decode_flops``).
"""
from __future__ import annotations

from typing import Tuple


def visible_pairs(S: int, P: int, W: int) -> int:
    """Query-key pairs seen by S queries at positions P..P+S-1, causal,
    within a window of W keys counting the query itself (W = 0: none)."""
    if not W:
        return S * P + S * (S + 1) // 2
    n1 = max(0, min(P + S, W) - P)           # queries that see every key
    return n1 * P + n1 * (n1 + 1) // 2 + (S - n1) * W


def attention_flops(layer: Tuple[int, int, int, int], S: int, P: int) -> int:
    """One attention layer of shape (H, KV, hd, window) over S new tokens
    after P cached ones: 4 * H * hd per visible query-key pair (the QK^T and
    PV products)."""
    H, _, hd, W = layer
    return 4 * H * hd * visible_pairs(S, P, W)
