"""InternVL2-76B — InternViT + InternLM2 backbone [arXiv:2404.16821].

VLM: we implement the LLM backbone; the vision frontend (ViT + projector) is a
stub per assignment — input_specs() supplies precomputed patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", source="arXiv:2404.16821",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    frontend="vision", frontend_tokens=256,
)
