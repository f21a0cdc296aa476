"""Config system: model architecture configs + canonical input shapes.

Every assigned architecture gets a module ``repro/configs/<id>.py`` exporting
``CONFIG``; they are registered here and selectable via ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. All models are pure-JAX pytree models.

    ``family`` drives the block layout:
      dense   — pre-norm GQA attention + SwiGLU MLP
      moe     — attention + top-k routed experts (einsum dispatch, EP-shardable)
      ssm     — Mamba2 SSD blocks (attention-free)
      hybrid  — Mamba2 blocks with a periodic *shared* attention block (Zamba2)
      audio   — encoder-decoder; frame embeddings feed the encoder (frontend stub)
      vlm     — decoder-only; patch embeddings are concatenated with text embeds
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    source: str = ""   # citation

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False
    capacity_factor: float = 1.25
    # decode-time routing capacity (§Perf iter B): C = Tg*K*cf/E. The safe
    # no-drop setting is cf=E (every token fits every expert); cf=8 keeps the
    # expert GEMMs 16x smaller with negligible drop probability at top-1/128
    decode_capacity_factor: float = 8.0

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (Zamba2): one shared attention block applied every k layers ---
    attn_every: int = 0

    # --- attention variants ---
    qkv_bias: bool = False
    sliding_window: int = 0        # 0 = full causal; >0 = SWA (enables long_500k)
    rope_theta: float = 500000.0

    # --- encoder-decoder ---
    encoder_layers: int = 0        # >0 => enc-dec; num_layers = decoder layers

    # --- modality frontend (STUB by assignment: embeddings arrive precomputed) ---
    frontend: str = "none"         # none | vision | audio
    frontend_tokens: int = 0       # patches / frames per sample

    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0 or self.family == "ssm"

    # ---- derived quantities -------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the lm_head/logits shard over
        a 16-wide TP axis (standard TP practice). Logits at padded positions
        are masked to -inf in loss/sampling."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:  # Mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Whether long_500k decode is supported (sub-quadratic / bounded KV)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (used by roofline + simulator cost model)."""
        d, dff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, KV = self.head_dim, self.num_heads, self.num_kv_heads
        attn = d * hd * (H + 2 * KV) + H * hd * d
        mlp = 3 * d * dff
        if self.family == "moe":
            mlp = mlp * self.num_experts + (3 * d * dff if self.moe_shared_expert else 0) \
                + d * self.num_experts  # router
        ssm = 0
        if self.family in ("ssm", "hybrid"):
            di, st = self.d_inner, self.ssm_state
            nh = self.ssm_heads
            # in_proj (x,z,B,C,dt) + conv + out_proj + A,D,dt_bias + norm
            ssm = d * (2 * di + 2 * st + nh) + self.ssm_conv * (di + 2 * st) + di * d + 3 * nh + di
        per_layer = 0
        if self.family == "dense" or self.family == "vlm":
            per_layer = attn + mlp
        elif self.family == "moe":
            per_layer = attn + mlp
        elif self.family == "ssm":
            per_layer = ssm
        elif self.family == "hybrid":
            per_layer = ssm  # + shared attention block counted once below
        elif self.family == "audio":
            per_layer = attn + mlp  # decoder layer also has cross-attn, added below
        total = self.num_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += attn + mlp  # one shared block
        if self.is_encdec:
            total += self.encoder_layers * (attn + mlp)
            total += self.num_layers * attn  # cross-attention in decoder
        total += V * d  # embedding
        total += V * d  # lm head (untied)
        total += 2 * d * self.num_layers  # norms (approx)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        dense_like = dataclasses.replace(
            self, family="dense", num_experts=0, experts_per_token=0)
        active_mlp = 3 * d * dff * (
            self.experts_per_token + (1 if self.moe_shared_expert else 0))
        base = dense_like.param_count() - self.num_layers * 3 * d * dff
        return base + self.num_layers * active_mlp


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "internvl2_76b",
    "llama4_maverick_400b_a17b",
    "olmoe_1b_7b",
    "mamba2_130m",
    "minitron_8b",
    "zamba2_2_7b",
    "seamless_m4t_large_v2",
    "llama3_8b",
    "qwen2_7b",
    "phi4_mini_3_8b",
]

# Paper's own evaluation models (used by the simulator cost model).
PAPER_ARCH_IDS = ["mistral_7b", "phi3_14b", "yi_34b", "llama31_70b"]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
                   n_heads: int = 4, n_kv: int = 2, d_ff: int = 512,
                   vocab: int = 512, experts: int = 4) -> ModelConfig:
    """Smoke-test variant of the same family (2 layers, d_model<=512, <=4 experts)."""
    kw = dict(
        num_layers=layers, d_model=d_model, d_ff=min(cfg.d_ff, d_ff),
        vocab_size=min(cfg.vocab_size, vocab), head_dim=0,
    )
    if not cfg.attention_free:
        kw.update(num_heads=n_heads, num_kv_heads=min(n_kv, n_heads))
        if cfg.num_kv_heads == cfg.num_heads:
            kw["num_kv_heads"] = n_heads  # preserve MHA family trait
    if cfg.family == "moe":
        kw.update(num_experts=min(cfg.num_experts, experts),
                  experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=min(cfg.ssm_state, 16), ssm_headdim=32, ssm_chunk=32)
    if cfg.family == "hybrid":
        kw.update(attn_every=2)
    if cfg.is_encdec:
        kw.update(encoder_layers=layers)
    if cfg.frontend_tokens:
        kw.update(frontend_tokens=16)
    if cfg.sliding_window:
        kw.update(sliding_window=64)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
