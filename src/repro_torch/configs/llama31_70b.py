"""Llama-3.1 70B — paper evaluation model."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama31-70b", family="dense", source="paper §6.2",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256,
)
