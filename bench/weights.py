"""The benchmark's weights: drawn from the run seed on the device, in the
dtype they are served in, one call per kind of matrix for all layers at once.

The distributions are the port's own ``init_params`` (normal with std
d^-0.5 for the projections, ff^-0.5 for W_down, 0.02 for the embedding,
ones for the norms).  The vocabulary is padded to the port's multiple of 256
with zero rows and columns, as a checkpoint padded for tensor parallelism
is: the reference ignores them.  `port_layout` hands the same tensors to the
port; `reference_layout` to the reference.
"""
from __future__ import annotations

from typing import Dict

import torch

MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def draw(c: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration `c` (the run's sizes, see
    `run.model_sizes`), stacked over layers: (L, in, out) per matrix."""
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
    """The same tensors as `Dense` reads them."""
    L = w["wq"].shape[0]
    layers = [dict({k: w[k][i] for k in MATRICES},
                   ln1=w["norms"][2 * i], ln2=w["norms"][2 * i + 1])
              for i in range(L)]
    return {"embed": w["embed"], "final_norm": w["norms"][2 * L],
            "lm_head": w["lm_head"], "layers": layers}
