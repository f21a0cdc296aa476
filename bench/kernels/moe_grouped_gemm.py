"""The work of the routed experts' grouped GEMM (B4,
``csrc/moe_grouped_gemm.cu``) in one moe layer run, from shapes alone,
whatever implements it: its FLOPs and the bytes its inputs and outputs
need, each counted once per product.

For `rows` (token, expert) assignments of width d over `experts` distinct
experts of width ff: the gate and up products (d -> ff) and the down
product (ff -> d), 2 * 3 * d * ff FLOPs per row; each product reads its
rows' inputs and the weights of the experts it touches once and writes its
rows' outputs once.
"""
from __future__ import annotations

from typing import Dict, Tuple

#: the device kernels that carry B4, by (a part of) the name the profiler
#: gives them
KERNEL_NAMES = ("moe_grouped_gemm",)


def work(c: Dict, rows: float, experts: float,
         elt_bytes: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer run's three products."""
    d, ff = c["d_model"], c["d_ff"]
    return (2 * 3 * d * ff * rows,
            3 * (experts * d * ff + rows * (d + ff)) * elt_bytes)
