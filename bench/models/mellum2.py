"""Mellum2 (JetBrains' Mellum2-12B-A2.5B): GQA attention, three windowed
layers to one full, YaRN RoPE on the full layers, and 64 routed experts,
top-8, in every layer.  Its sizes, its weights and its model FLOPs (the
interface is in ``models/__init__.py``).

The weights are drawn from the run seed on the device, in the dtype they are
served in, one call per kind of matrix for all layers at once, with the
port's own ``init_params`` distributions: normal with std d^-0.5 for the
attention projections, the router (kept in float32, as the port keeps it)
and the experts' W_gate and W_up, ff^-0.5 for W_down, 0.02 for the
embedding, ones for the norms.  The vocabulary (98,304) is a multiple of
256, so nothing is padded.

Model FLOPs per token and layer: 2 per weight of the attention's q, k, v
and o projections, the attention's own (`model_flops.attention_flops`,
within the layer's window), 2 * d * E for the router, and 2 * 3 * d * ff
for each of the K experts the token is routed to (not the E held); per
token whose logits are computed, 2 * d * vocab for the head.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from model_flops import attention_flops

#: the rehearsal's sizes (CPU, float32): every width cut, for tests only;
#: one period of the layer pattern
REHEARSAL = {"num_layers": 4, "d_model": 64, "num_heads": 4,
             "num_kv_heads": 1, "head_dim": 16, "d_ff": 32,
             "num_experts": 8, "experts_per_token": 2, "vocab_size": 512,
             "max_len": 128, "dtype": "float32"}
#: the rehearsal's window of the windowed layers
REHEARSAL_WINDOW = 8
ATTN = ("wq", "wk", "wv", "wo")
EXPERTS = ("w_gate", "w_up", "w_down")


def sizes(cf: Dict, rehearse: bool) -> Dict:
    """The configuration file's published keys under the port's names (and
    the serving settings), as the run uses them."""
    rp = cf["rope_parameters"]
    full = rp["full_attention"]
    assert rp["sliding_attention"]["rope_type"] == "default"
    assert full["rope_type"] == "yarn"
    assert set(cf["mlp_layer_types"]) == {"sparse"}
    c = {"num_layers": cf["num_hidden_layers"], "d_model": cf["hidden_size"],
         "num_heads": cf["num_attention_heads"],
         "num_kv_heads": cf["num_key_value_heads"],
         "head_dim": cf["head_dim"], "d_ff": cf["moe_intermediate_size"],
         "num_experts": cf["num_experts"],
         "experts_per_token": cf["num_experts_per_tok"],
         "vocab_size": cf["vocab_size"],
         "rope_theta": float(rp["sliding_attention"]["rope_theta"]),
         "full_rope_theta": float(full["rope_theta"]),
         "yarn": {k: float(full[k]) for k in (
             "factor", "original_max_position_embeddings", "beta_fast",
             "beta_slow", "attention_factor")},
         "norm_eps": float(cf["rms_norm_eps"]), "dtype": cf["torch_dtype"],
         "max_len": cf["serving"]["max_len"]}
    windows = [cf["sliding_window"] if t == "sliding_attention" else 0
               for t in cf["layer_types"]]
    if rehearse:
        c.update(REHEARSAL)
        windows = [REHEARSAL_WINDOW if w else 0
                   for w in windows[:c["num_layers"]]]
    c["padded_vocab"] = -(-c["vocab_size"] // 256) * 256
    c["layers"] = [(c["num_heads"], c["num_kv_heads"], c["head_dim"], w)
                   for w in windows]
    return c


def port_config(cf: Dict, c: Dict):
    from repro_torch.configs import get_config
    from repro_torch.configs.layered import Rope, Yarn
    y = c["yarn"]
    keys = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
            "d_ff", "num_experts", "experts_per_token", "vocab_size",
            "rope_theta", "norm_eps", "dtype")
    E = c["num_experts"]
    return dataclasses.replace(
        get_config(cf["port_config"]), **{k: c[k] for k in keys},
        capacity_factor=float(E), decode_capacity_factor=float(E),
        layer_windows=tuple(w for *_, w in c["layers"]),
        full_rope=Rope(c["full_rope_theta"], Yarn(
            y["factor"], int(y["original_max_position_embeddings"]),
            y["beta_fast"], y["beta_slow"], y["attention_factor"])))


def draw(c: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration `c` (the run's sizes, see `sizes`),
    stacked over layers: (L, in, out) per attention matrix, (L, d, E) f32
    for the router, (L, E, in, out) per expert matrix."""
    g = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    L, d, ff, E = c["num_layers"], c["d_model"], c["d_ff"], c["num_experts"]
    q, kv = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
    V, Vp = c["vocab_size"], c["padded_vocab"]

    def normal(shape, std, dt=dtype):
        return torch.randn(shape, generator=g, dtype=dt, device=device).mul_(std)
    w = {"wq": normal((L, d, q), d ** -0.5), "wk": normal((L, d, kv), d ** -0.5),
         "wv": normal((L, d, kv), d ** -0.5), "wo": normal((L, q, d), d ** -0.5),
         "router": normal((L, d, E), d ** -0.5, torch.float32),
         "w_gate": normal((L, E, d, ff), d ** -0.5),
         "w_up": normal((L, E, d, ff), d ** -0.5),
         "w_down": normal((L, E, ff, d), ff ** -0.5)}
    w["embed"] = torch.zeros((Vp, d), dtype=dtype, device=device)
    w["embed"][:V] = normal((V, d), 0.02)
    w["lm_head"] = torch.zeros((d, Vp), dtype=dtype, device=device)
    w["lm_head"][:, :V] = normal((d, V), d ** -0.5)
    w["norms"] = torch.ones((2 * L + 1, d), dtype=dtype, device=device)
    return w


def port_layout(w: Dict[str, torch.Tensor]) -> Dict:
    """The port's parameter tree (``models.model.init_params``' moe layout),
    made of views of the drawn tensors."""
    L = w["wq"].shape[0]
    layers = [{"attn": {k: w[k][i] for k in ATTN},
               "moe": {k: w[k][i] for k in ("router", *EXPERTS)},
               "ln1": w["norms"][2 * i], "ln2": w["norms"][2 * i + 1]}
              for i in range(L)]
    return {"embed": w["embed"], "final_norm": w["norms"][2 * L],
            "lm_head": w["lm_head"], "layers": layers}


def reference_layout(w: Dict[str, torch.Tensor]) -> Dict:
    """The same tensors as ``reference/mellum2.py`` reads them."""
    L = w["wq"].shape[0]
    layers = [dict({k: w[k][i] for k in (*ATTN, "router", *EXPERTS)},
                   ln1=w["norms"][2 * i], ln2=w["norms"][2 * i + 1])
              for i in range(L)]
    return {"embed": w["embed"], "final_norm": w["norms"][2 * L],
            "lm_head": w["lm_head"], "layers": layers}


def token_layer_flops(c: Dict) -> int:
    """One token through one layer, outside the attention's own: the
    projections, the router and the K experts it is routed to."""
    H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    d, ff, E, K = c["d_model"], c["d_ff"], c["num_experts"], \
        c["experts_per_token"]
    return 2 * (d * (H + 2 * KV) * hd + H * hd * d + d * E + K * 3 * d * ff)


def prefill_flops(c: Dict, S: int, P: int, lo: int, hi: int,
                  logits: bool) -> int:
    """A prefill quantum: layers [lo, hi) over S new tokens after P cached
    ones, and the head on the last token when `logits`."""
    head = 2 * c["d_model"] * c["vocab_size"] if logits else 0
    return head + sum(S * token_layer_flops(c) + attention_flops(layer, S, P)
                      for layer in c["layers"][lo:hi])


def decode_flops(c: Dict, cached: int) -> int:
    """One decode token after `cached` tokens, through every layer and the
    head."""
    return prefill_flops(c, 1, cached, 0, len(c["layers"]), True)
