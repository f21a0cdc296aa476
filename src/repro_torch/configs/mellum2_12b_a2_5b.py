"""Mellum2-12B-A2.5B-Instruct — a code model of 28 layers, three windowed
(1024 keys) to one full, YaRN RoPE on the full layers, 64 experts top-8 in
every layer [hf:JetBrains/Mellum2-12B-A2.5B-Instruct].

``d_ff`` is the expert width (``moe_intermediate_size``): every MLP is
sparse, so the published ``intermediate_size`` of 7168 belongs to no layer.
Both capacity factors are E, so an expert's buffer holds every assignment
of its group and none is dropped, as in the published model (it routes
without a capacity).
"""
from repro_torch.configs.layered import LayeredConfig, Rope, Yarn

#: three ``sliding_attention`` layers, then one ``full_attention``, x 7
WINDOWS = (1024, 1024, 1024, 0) * 7

CONFIG = LayeredConfig(
    name="mellum2-12b-a2.5b", family="moe",
    source="https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct/blob/main/config.json",
    num_layers=28, d_model=2304, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=896, vocab_size=98304, num_experts=64, experts_per_token=8,
    capacity_factor=64.0, decode_capacity_factor=64.0,
    rope_theta=500000.0, norm_eps=1e-6, layer_windows=WINDOWS,
    full_rope=Rope(500000.0, Yarn(factor=16.0,
                                  original_max_position_embeddings=8192,
                                  beta_fast=32.0, beta_slow=1.0,
                                  attention_factor=1.2772588722239782)),
)
