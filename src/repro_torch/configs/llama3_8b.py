"""Llama-3-8B — GQA, 128k vocab [arXiv:2407.21783].

sliding_window>0 is our block-local SWA variant so this dense arch exercises
the long_500k shape (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense", source="arXiv:2407.21783",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    sliding_window=8192,
)
