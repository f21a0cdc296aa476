"""The work of one prefill attention call (B1, ``csrc/flash_attention.cu``),
from shapes alone, whatever implements it: its FLOPs and the bytes its
inputs and output need, each counted once.

For S queries after P cached keys, H query heads and KV key/value heads of
width hd: 4 * H * hd FLOPs per visible query-key pair (QK^T and PV), and
q and o (H * S rows), k and v (KV rows per key a query sees) of hd
elements each.
"""
from __future__ import annotations

from typing import Dict, Tuple

from model_flops import visible_pairs

#: the device kernels that carry B1, by the name the profiler gives them
KERNEL_NAMES = ("fa_tc_kernel", "fa_kernel")


def work(c: Dict, S: int, P: int, elt_bytes: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one layer's attention over S new tokens after P."""
    H, KV, hd, W = (c["num_heads"], c["num_kv_heads"], c["head_dim"],
                    c["sliding_window"])
    flops = 4 * H * hd * visible_pairs(S, P, W)
    first_key = max(0, P - W + 1) if W else 0
    keys = P + S - first_key
    return flops, (2 * H * S + 2 * KV * keys) * hd * elt_bytes


def roofline_s(flops: int, nbytes: int, peaks: Dict[str, float]) -> float:
    """The least time the chip could take: the larger of the compute and
    the memory bound."""
    return max(flops / peaks["flops"], nbytes / peaks["bytes_per_s"])
