"""Zamba2-2.7B — Mamba2 backbone with shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", source="arXiv:2411.15242",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    ssm_chunk=64,  # §Perf iter A: SSD tile 256->64; intra-chunk decay
    # bytes scale with chunk x seq, compute unchanged (EXPERIMENTS.md)
    attn_every=6,  # one shared attention+MLP block applied every 6 Mamba2 layers
)
