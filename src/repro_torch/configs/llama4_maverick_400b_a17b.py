"""Llama-4 Maverick 400B-A17B — MoE 128 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_shared_expert=True,
)
