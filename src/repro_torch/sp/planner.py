"""Fast-SP strategy planner — the paper's §5.3 closed-form cost model.

For each of the two stages (attention, MLP) the paper gives per-node
communication volumes and per-GPU computation volumes for the Megatron-SP
and Ulysses-SP variants; the scheduler evaluates all four combinations and
picks the lowest estimated latency. We implement the formulas verbatim
(notation: T = TP size, G = GPUs/node ≡ inner-axis size, s = per-GPU segment
length, Nh/Nkv = query/KV heads, dh = head dim, d = model dim), then map the
chosen variant onto our TPU implementations:

  Megatron-SP  -> inner.allgather_attention  (all-gather / reduce-scatter)
  Ulysses-SP   -> inner.a2a_attention        (two all-to-alls)

Hardware constants default to TPU v5e (HBM 819 GB/s, ICI ~50 GB/s/link,
197 bf16 TFLOP/s) but are injectable so the simulator can model the paper's
A100 cluster too.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HardwareSpec:
    name: str = "tpu_v5e"
    flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9          # bytes/s per chip
    link_bw: float = 50e9          # bytes/s per ICI link (intra "node")
    inter_bw: float = 25e9         # bytes/s effective cross-outer-axis
    bytes_per_elt: int = 2         # bf16
    mfu: float = 0.55              # achievable fraction of peak on matmuls


TPU_V5E = HardwareSpec()
A100_40G = HardwareSpec(name="a100", flops=312e12, hbm_bw=1550e9,
                        link_bw=300e9, inter_bw=50e9, mfu=0.5)


@dataclass(frozen=True)
class SPPlan:
    attn_strategy: str      # "megatron" | "ulysses"
    mlp_strategy: str       # "megatron" | "ulysses"
    est_time: float         # seconds per layer
    breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def inner_impl(self) -> str:
        """Map paper terminology onto our shard_map implementations."""
        return {"megatron": "allgather", "ulysses": "a2a"}[self.attn_strategy]


def stage_costs(cfg: ModelConfig, s: int, T: int, G: int,
                hw: HardwareSpec = TPU_V5E) -> Dict[str, Dict[str, float]]:
    """Per-layer comm/compute volumes from §5.3, in elements and FLOPs.

    s: per-GPU sequence segment length. T: TP size. G: GPUs per node.
    """
    d = cfg.d_model
    Nh, Nkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # --- attention stage ---
    # Megatron SP: all-gather + reduce-scatter of activations
    mg_attn_comm = 2 * s * d * (T - 1) * G
    mg_attn_comp = (2 * s * d * (Nh + 2 * Nkv) * dh / T
                    + 4 * (s * T) ** 2 * d / T + 2 * s * d ** 2)
    # Ulysses SP: two A2As on QKV/output + parameter transfer when TP holds
    ul_attn_comm = (2 * s * (Nh + 2 * Nkv) * dh * (G - 1)
                    + (d * (Nh + 2 * Nkv) * dh + d ** 2) * G * (T - 1) / T)
    ul_attn_comp = (2 * s * d * (Nh + 2 * Nkv) * dh
                    + 4 * (s * G) ** 2 * d / G + 2 * s * d ** 2)
    # --- MLP stage (SwiGLU ~ 3 mats, paper uses 16 s d^2 for 4d FFN) ---
    ff_flops = 2 * 3 * s * d * cfg.d_ff  # fwd FLOPs per segment
    mg_mlp_comm = 2 * s * d * (T - 1) * G
    ul_mlp_comm = 2 * 3 * d * cfg.d_ff * (T - 1) * G / T  # parameter transfer
    return {
        "attn": {"megatron_comm": mg_attn_comm, "megatron_comp": mg_attn_comp,
                 "ulysses_comm": ul_attn_comm, "ulysses_comp": ul_attn_comp},
        "mlp": {"megatron_comm": mg_mlp_comm, "megatron_comp": ff_flops,
                "ulysses_comm": ul_mlp_comm, "ulysses_comp": ff_flops},
    }


def plan_fast_sp(cfg: ModelConfig, seq_len: int, n_nodes: int, gpus_per_node: int,
                 tp: int = 0, hw: HardwareSpec = TPU_V5E) -> SPPlan:
    """Choose the per-stage SP variant minimizing estimated per-layer latency
    (the paper's four-combination search)."""
    G = gpus_per_node
    T = tp or G
    s = max(seq_len // (n_nodes * G), 1)
    vols = stage_costs(cfg, s, T, G, hw)
    bpe = hw.bytes_per_elt
    eff_flops = hw.flops * hw.mfu

    def t_comm(elements: float) -> float:
        return elements * bpe / hw.link_bw

    def t_comp(flops: float) -> float:
        return flops / eff_flops

    best = None
    for a in ("megatron", "ulysses"):
        for m in ("megatron", "ulysses"):
            t = (t_comm(vols["attn"][f"{a}_comm"]) + t_comp(vols["attn"][f"{a}_comp"])
                 + t_comm(vols["mlp"][f"{m}_comm"]) + t_comp(vols["mlp"][f"{m}_comp"]))
            if best is None or t < best.est_time:
                best = SPPlan(attn_strategy=a, mlp_strategy=m, est_time=t,
                              breakdown={
                                  "attn_comm_s": t_comm(vols["attn"][f"{a}_comm"]),
                                  "attn_comp_s": t_comp(vols["attn"][f"{a}_comp"]),
                                  "mlp_comm_s": t_comm(vols["mlp"][f"{m}_comm"]),
                                  "mlp_comp_s": t_comp(vols["mlp"][f"{m}_comp"]),
                              })
    return best


def ring_hop_time(cfg: ModelConfig, seg_len: int, hw: HardwareSpec = TPU_V5E
                  ) -> float:
    """Cross-node ring attention per-hop KV transfer time (per layer)."""
    kv_bytes = 2 * seg_len * cfg.num_kv_heads * cfg.head_dim * hw.bytes_per_elt
    return kv_bytes / hw.inter_bw
