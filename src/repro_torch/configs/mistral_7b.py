"""Mistral-v0.3 7B — paper evaluation model [hf:mistralai/Mistral-7B-Instruct-v0.3]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-7b", family="dense", source="paper §6.2",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32768,
)
