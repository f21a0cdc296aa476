"""SeamlessM4T-large-v2 — encoder-decoder, multimodal [arXiv:2308.11596].

Audio: we implement the transformer backbone; the mel-spectrogram + conv
feature extractor is a stub per assignment — input_specs() supplies frame
embeddings for the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", source="arXiv:2308.11596",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    encoder_layers=24, frontend="audio", frontend_tokens=1024,
)
