"""The dense pre-norm GQA transformer (Mistral, Phi-3): its sizes, its weights
and its model FLOPs (the interface is in ``models/__init__.py``).

The weights are drawn from the run seed on the device, in the dtype they are
served in, one call per kind of matrix for all layers at once, with the
port's own ``init_params`` distributions (normal with std d^-0.5 for the
projections, ff^-0.5 for W_down, 0.02 for the embedding, ones for the
norms).  The vocabulary is padded to the port's multiple of 256 with zero
rows and columns, as a checkpoint padded for tensor parallelism is: the
reference ignores them.

Model FLOPs per token and layer: 2 per weight of the layer's matrices (q, k,
v and o projections and the three SwiGLU matrices), plus the attention's
(`model_flops.attention_flops`, within the layer's window); per token whose
logits are computed, 2 * d * vocab for the head.  Work a step does for an
idle decode lane, or for the padded vocabulary, is not the model's and is
not counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from model_flops import attention_flops

#: the rehearsal's sizes (CPU, float32): every width cut, for tests only
REHEARSAL = {"num_layers": 2, "d_model": 64, "num_heads": 4,
             "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
             "vocab_size": 512, "max_len": 128, "dtype": "float32"}
#: the rehearsal's window, where the configuration has one
REHEARSAL_WINDOW = 40
MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def sizes(cf: Dict, rehearse: bool) -> Dict:
    """The configuration file's published keys under the port's names (and
    the serving settings), as the run uses them."""
    H = cf["num_attention_heads"]
    c = {"num_layers": cf["num_hidden_layers"], "d_model": cf["hidden_size"],
         "num_heads": H, "num_kv_heads": cf["num_key_value_heads"],
         "head_dim": cf.get("head_dim") or cf["hidden_size"] // H,
         "d_ff": cf["intermediate_size"], "vocab_size": cf["vocab_size"],
         "rope_theta": float(cf["rope_theta"]),
         "sliding_window": int(cf.get("sliding_window") or 0),
         "norm_eps": float(cf["rms_norm_eps"]), "dtype": cf["torch_dtype"],
         "max_len": cf["serving"]["max_len"]}
    if rehearse:
        if c["sliding_window"]:
            c["sliding_window"] = REHEARSAL_WINDOW
        c.update(REHEARSAL)
    c["padded_vocab"] = -(-c["vocab_size"] // 256) * 256
    c["layers"] = [(c["num_heads"], c["num_kv_heads"], c["head_dim"],
                    c["sliding_window"])] * c["num_layers"]
    return c


def port_config(cf: Dict, c: Dict):
    from repro_torch.configs import get_config
    keys = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
            "d_ff", "vocab_size", "rope_theta", "sliding_window", "norm_eps",
            "dtype")
    return dataclasses.replace(get_config(cf["port_config"]),
                               **{k: c[k] for k in keys})


def draw(c: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration `c` (the run's sizes, see
    `sizes`), stacked over layers: (L, in, out) per matrix."""
    g = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    L, d, ff = c["num_layers"], c["d_model"], c["d_ff"]
    q, kv = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
    V, Vp = c["vocab_size"], c["padded_vocab"]
    shapes = {"wq": (d, q, d ** -0.5), "wk": (d, kv, d ** -0.5),
              "wv": (d, kv, d ** -0.5), "wo": (q, d, d ** -0.5),
              "w_gate": (d, ff, d ** -0.5), "w_up": (d, ff, d ** -0.5),
              "w_down": (ff, d, ff ** -0.5)}
    w = {}
    for name, (i, o, std) in shapes.items():
        w[name] = torch.randn((L, i, o), generator=g, dtype=dtype,
                              device=device).mul_(std)
    w["embed"] = torch.zeros((Vp, d), dtype=dtype, device=device)
    w["embed"][:V] = torch.randn((V, d), generator=g, dtype=dtype,
                                 device=device).mul_(0.02)
    w["lm_head"] = torch.zeros((d, Vp), dtype=dtype, device=device)
    w["lm_head"][:, :V] = torch.randn((d, V), generator=g, dtype=dtype,
                                      device=device).mul_(d ** -0.5)
    w["norms"] = torch.ones((2 * L + 1, d), dtype=dtype, device=device)
    return w


def port_layout(w: Dict[str, torch.Tensor]) -> Dict:
    """The port's parameter tree (``models.model.init_params``' layout),
    made of views of the drawn tensors."""
    L = w["wq"].shape[0]
    layers = [{"attn": {k: w[k][i] for k in ("wq", "wk", "wv", "wo")},
               "mlp": {k: w[k][i] for k in ("w_gate", "w_up", "w_down")},
               "ln1": w["norms"][2 * i], "ln2": w["norms"][2 * i + 1]}
              for i in range(L)]
    return {"embed": w["embed"], "final_norm": w["norms"][2 * L],
            "lm_head": w["lm_head"], "layers": layers}


def reference_layout(w: Dict[str, torch.Tensor]) -> Dict:
    """The same tensors as ``reference/dense.py`` reads them."""
    L = w["wq"].shape[0]
    layers = [dict({k: w[k][i] for k in MATRICES},
                   ln1=w["norms"][2 * i], ln2=w["norms"][2 * i + 1])
              for i in range(L)]
    return {"embed": w["embed"], "final_norm": w["norms"][2 * L],
            "lm_head": w["lm_head"], "layers": layers}


def layer_weights(c: Dict, layer: Tuple[int, int, int, int]) -> int:
    H, KV, hd, _ = layer
    d, ff = c["d_model"], c["d_ff"]
    return d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff


def prefill_flops(c: Dict, S: int, P: int, lo: int, hi: int,
                  logits: bool) -> int:
    """A prefill quantum: layers [lo, hi) over S new tokens after P cached
    ones, and the head on the last token when `logits`."""
    head = 2 * c["d_model"] * c["vocab_size"] if logits else 0
    return head + sum(2 * S * layer_weights(c, layer)
                      + attention_flops(layer, S, P)
                      for layer in c["layers"][lo:hi])


def decode_flops(c: Dict, cached: int) -> int:
    """One decode token after `cached` tokens, through every layer and the
    head."""
    return prefill_flops(c, 1, cached, 0, len(c["layers"]), True)
