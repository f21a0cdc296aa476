"""Phi-3 14B (medium) — paper evaluation model."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-14b", family="dense", source="paper §6.2",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
    d_ff=17920, vocab_size=32064,
)
