"""Top-k routed Mixture-of-Experts FFN (the reference's ``models/moe.py``),
dispatched by index.

The reference routes GShard-style in groups of ~2048 tokens with a per-group
capacity C and dispatches through one-hot einsums over a (G, Tg, E, C)
tensor.  At olmoe's prefill with the dropless capacity factor E that tensor
would hold 8.6e9 elements, so `moe_block` computes the same function from
indices: the kept (token, k) assignments are sorted by expert, each expert's
SwiGLU runs on its own rows, and the gated outputs are added back to their
tokens.  Each one-hot term of the reference selects exactly one (token, k),
so the two agree; `moe_block_onehot` is the reference's einsum form in plain
PyTorch, which the tests hold the index path against.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import swiglu

MOE_GROUP_SIZE = 2048  # tokens per routing group (GShard-style)


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device) -> Dict[str, torch.Tensor]:
    """One layer's router (d, E), kept in f32 whatever the model's dtype, the
    experts' (E, d, ff) / (E, ff, d) SwiGLU weights and, if the config has
    one, the shared expert's."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts

    def normal(*shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, dtype=dt, device=device) * std
    p = {"router": normal(d, E, std=d ** -0.5, dt=torch.float32),
         "w_gate": normal(E, d, ff, std=d ** -0.5),
         "w_up": normal(E, d, ff, std=d ** -0.5),
         "w_down": normal(E, ff, d, std=ff ** -0.5)}
    if cfg.moe_shared_expert:
        p["shared"] = {"w_gate": normal(d, ff, std=d ** -0.5),
                       "w_up": normal(d, ff, std=d ** -0.5),
                       "w_down": normal(ff, d, std=ff ** -0.5)}
    return p


class Routing(NamedTuple):
    probs: torch.Tensor        # (G, Tg, E) f32 router softmax
    expert: torch.Tensor       # (G, Tg, K) chosen experts, best first
    gate: torch.Tensor         # (G, Tg, K) f32 renormalised gates, 0 if dropped
    slot: torch.Tensor         # (G, Tg, K) position in the expert's group buffer
    keep: torch.Tensor         # (G, Tg, K) bool, slot < capacity
    capacity: int


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor, *,
          capacity_factor: Optional[float] = None,
          group_size: int = MOE_GROUP_SIZE) -> Routing:
    """The reference's routing of x (B, S, d): G groups (T // group_size,
    lowered until it divides T), f32 softmax over the experts, top-K
    renormalised before the drop, and a slot per assignment counted in
    (token, k) order within its group; an assignment at a slot >= C =
    max(int(Tg * K * cf / E), 1) is dropped and keeps a zero gate."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    cf = capacity_factor or cfg.capacity_factor
    T = B * S
    G = max(T // group_size, 1)
    while T % G:
        G -= 1
    Tg = T // G
    logits = torch.matmul(x.reshape(G, Tg, d).float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate, expert = probs.topk(K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    C = max(int(Tg * K * cf / E), 1)
    # slot = assignments to the same expert earlier in the group's (t, k)
    # order: a stable sort by (group, expert) keeps that order in each run
    key = (torch.arange(G, device=x.device)[:, None] * E
           + expert.reshape(G, Tg * K)).flatten()
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(G * E, dtype=key.dtype, device=x.device).index_add_(
        0, key, torch.ones_like(key))           # bincount, shaped without the data
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.empty_like(key)
    slot[order] = torch.arange(key.numel(), device=x.device) - starts[key[order]]
    slot = slot.reshape(G, Tg, K)
    keep = slot < C
    return Routing(probs, expert, gate * keep, slot, keep, C)


def _aux(cfg: ModelConfig, r: Routing) -> Dict[str, torch.Tensor]:
    """Switch-style load-balance loss and the share of assignments dropped."""
    E = cfg.num_experts
    me = r.probs.mean((0, 1))
    ce = F.one_hot(r.expert[..., 0], E).float().mean((0, 1))
    return {"lb_loss": E * (me * ce).sum(),
            "dropped_frac": 1.0 - r.keep.float().mean()}


def _shared(p, x, y):
    return y + swiglu(x, p["shared"]) if "shared" in p else y


def moe_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
              capacity_factor: Optional[float] = None,
              group_size: int = MOE_GROUP_SIZE):
    """x (B, S, d) -> (y (B, S, d), aux {"lb_loss", "dropped_frac"}).  Each
    expert with kept assignments runs its SwiGLU on its own rows (matmuls in
    x's dtype); the outputs, times the gates in x's dtype, are summed per
    token in f32.  On the "meta" device (the dry run's account, which has no
    values to route by) it is `moe_block_onehot`, the reference's own
    dispatch."""
    if x.device.type == "meta":
        return moe_block_onehot(cfg, p, x, capacity_factor=capacity_factor,
                                group_size=group_size)
    B, S, d = x.shape
    K = cfg.experts_per_token
    r = route(cfg, p["router"], x, capacity_factor=capacity_factor,
              group_size=group_size)
    flat = r.expert.flatten()
    kept = torch.nonzero(r.keep.flatten()).squeeze(1)        # (token, k) order
    kept = kept[torch.sort(flat[kept], stable=True).indices]  # grouped by expert
    rows = torch.bincount(flat[kept], minlength=cfg.num_experts).tolist()
    tokens = kept // K
    xt = x.reshape(B * S, d)
    xin = xt[tokens]
    gate = r.gate.flatten()[kept].to(x.dtype).float()
    out = torch.empty_like(xin)
    start = 0
    for e, n in enumerate(rows):
        if n:
            xe = xin[start:start + n]
            h = F.silu(torch.matmul(xe, p["w_gate"][e].to(x.dtype))) \
                * torch.matmul(xe, p["w_up"][e].to(x.dtype))
            out[start:start + n] = torch.matmul(h, p["w_down"][e].to(x.dtype))
            start += n
    # each kept (token, k) output into its own row, then the sum over k in
    # order: deterministic, where an index_add_ on the card is not
    y = torch.zeros((B * S * K, d), dtype=torch.float32, device=x.device)
    y[kept] = out.float() * gate[:, None]
    y = y.reshape(B, S, K, d).sum(2).to(x.dtype)
    return _shared(p, x, y), _aux(cfg, r)


def moe_block_onehot(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, *, capacity_factor: Optional[float] = None,
                     group_size: int = MOE_GROUP_SIZE):
    """The reference's dispatch as it stands: (G, Tg, E, C) one-hot dispatch
    and combine einsums around batched expert products.  Small shapes only;
    the plain version `moe_block` is held against."""
    B, S, d = x.shape
    E = cfg.num_experts
    r = route(cfg, p["router"], x, capacity_factor=capacity_factor,
              group_size=group_size)
    G, Tg, _ = r.expert.shape
    C = r.capacity
    xt = x.reshape(G, Tg, d)
    dt = x.dtype
    slot_oh = F.one_hot(torch.where(r.keep, r.slot, C), C + 1)[..., :C].to(dt)
    exp_oh = F.one_hot(r.expert, E).to(dt)
    disp = torch.einsum("gtke,gtkc->gtec", exp_oh, slot_oh)
    expert_in = torch.einsum("gtec,gtd->gecd", disp, xt)
    g = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"].to(dt)))
    u = torch.einsum("gecd,edf->gecf", expert_in, p["w_up"].to(dt))
    expert_out = torch.einsum("gecf,efd->gecd", g * u, p["w_down"].to(dt))
    comb = torch.einsum("gtke,gtkc,gtk->gtec", exp_oh, slot_oh, r.gate.to(dt))
    y = torch.einsum("gtec,gecd->gtd", comb, expert_out).reshape(B, S, d).to(dt)
    return _shared(p, x, y), _aux(cfg, r)
