"""Mamba2-130M — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm", source="arXiv:2405.21060",
    num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,  # unused (attn-free)
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
)
