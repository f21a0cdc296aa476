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

The block is cut in two so that a rank of a partitioned step (`models/tp.py`)
can run a subset of the experts: `route` (or `route_logits`, from router
logits gathered over the ranks that hold the router's columns) decides every
assignment of a routing group, and `expert_partial` sums the gated outputs
of one range of experts over the kept assignments of one range of tokens.
`moe_block` is `expert_partial` over every expert and token.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import swiglu

MOE_GROUP_SIZE = 2048  # tokens per routing group (GShard-style)

#: the int64 scalar on the device that `expert_partial` adds the experts it
#: gave rows to (`tally_into`); None: no tally
_TALLY: contextvars.ContextVar = contextvars.ContextVar("moe_tally", default=None)


@contextlib.contextmanager
def tally_into(t: Optional[torch.Tensor]):
    """Within: each `expert_partial` of this thread adds to `t` (a 0-dim
    int64 tensor on its device) how many of its experts it gave rows to,
    as a device operation (a graph captured within adds at each replay)."""
    token = _TALLY.set(t)
    try:
        yield
    finally:
        _TALLY.reset(token)


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


def groups(T: int, group_size: int = MOE_GROUP_SIZE) -> Tuple[int, int]:
    """(G, Tg): the reference's routing groups of T tokens, G = T //
    group_size lowered until it divides T."""
    G = max(T // group_size, 1)
    while T % G:
        G -= 1
    return G, T // G


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor, *,
          capacity_factor: Optional[float] = None,
          group_size: int = MOE_GROUP_SIZE) -> Routing:
    """The reference's routing of x (B, S, d) in `groups`: the f32 router
    logits, then `route_logits`."""
    B, S, d = x.shape
    G, Tg = groups(B * S, group_size)
    logits = torch.matmul(x.reshape(G, Tg, d).float(), router.float())
    return route_logits(cfg, logits, capacity_factor=capacity_factor)


def route_logits(cfg: ModelConfig, logits: torch.Tensor, *,
                 capacity_factor: Optional[float] = None) -> Routing:
    """Routing from the f32 router logits (G, Tg, E): softmax over the
    experts, top-K renormalised before the drop, and a slot per assignment
    counted in (token, k) order within its group; an assignment at a slot
    >= C = max(int(Tg * K * cf / E), 1) is dropped and keeps a zero gate."""
    G, Tg, E = logits.shape
    K = cfg.experts_per_token
    cf = capacity_factor or cfg.capacity_factor
    dev = logits.device
    probs = torch.softmax(logits, dim=-1)
    gate, expert = probs.topk(K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    C = max(int(Tg * K * cf / E), 1)
    # slot = assignments to the same expert earlier in the group's (t, k)
    # order: a stable sort by (group, expert) keeps that order in each run
    key = (torch.arange(G, device=dev)[:, None] * E + expert.reshape(G, Tg * K)).flatten()
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(G * E, dtype=key.dtype, device=dev).index_add_(
        0, key, torch.ones_like(key))           # bincount, shaped without the data
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.empty_like(key)
    slot[order] = torch.arange(key.numel(), device=dev) - starts[key[order]]
    slot = slot.reshape(G, Tg, K)
    keep = slot < C
    return Routing(probs, expert, gate * keep, slot, keep, C)


def balance_terms(cfg: ModelConfig, r: Routing) -> Tuple[torch.Tensor, torch.Tensor]:
    """(me, ce) (E,): the mean router probability and the share of first
    choices of each expert over the routing's groups and tokens."""
    return (r.probs.mean((0, 1)),
            F.one_hot(r.expert[..., 0], cfg.num_experts).float().mean((0, 1)))


def _aux(cfg: ModelConfig, r: Routing) -> Dict[str, torch.Tensor]:
    """Switch-style load-balance loss and the share of assignments dropped."""
    me, ce = balance_terms(cfg, r)
    return {"lb_loss": cfg.num_experts * (me * ce).sum(),
            "dropped_frac": 1.0 - r.keep.float().mean()}


def _shared(p, x, y):
    return y + swiglu(x, p["shared"]) if "shared" in p else y


def expert_partial(cfg: ModelConfig, p: Dict[str, torch.Tensor], r: Routing,
                   x: torch.Tensor, *, e0: int = 0,
                   tokens: Optional[Tuple[int, int]] = None,
                   live: Optional[torch.Tensor] = None,
                   impl: str = "auto") -> torch.Tensor:
    """Per token of `tokens` (a range [t0, t1) of the routing's tokens,
    flattened over its groups in order; default all), the f32 sum over its
    kept assignments to the experts [e0, e0 + E_loc) of gate x SwiGLU_e(x):
    (t1 - t0, d).  `p` holds those experts' weights (w_gate, w_up (E_loc, d,
    ff), w_down (E_loc, ff, d)); `x` (T, d) every routed token's input;
    `live` (T,) bool, where given, the tokens that are tokens (a padded
    bucket's pad rows and idle decode lanes are not, and take no expert).

    Every step runs on x's device, with shapes that follow T alone, so no
    value is read back and a CUDA graph captures the block: the (token, k)
    assignments are sorted by expert (stably: an expert's rows keep their
    (token, k) order; those not run here sort last), each expert's row
    bounds come from the counts, the rows are gathered, and the grouped
    GEMM (`ops.grouped_gemm`: B4 on the card with impl "auto", one product
    per expert otherwise) runs the gate and up products and the down
    product, silu(g) x u between, in x's dtype.  Each row is scaled by its
    gate (in x's dtype), returned to its (token, k) place, and the rows
    are summed over k in order: no atomics, so the result is
    deterministic.  Under `tally_into`, the experts given rows are added
    to the tally.  On the "meta" device (the dry run, which has no values
    to route by) the reference's one-hot dispatch restricted to the range
    (`_expert_partial_onehot`)."""
    T, d = x.shape
    t0, t1 = tokens or (0, T)
    if x.device.type == "meta":
        return _expert_partial_onehot(cfg, p, r, x, e0)[t0:t1]
    K = cfg.experts_per_token
    n_exp = p["w_gate"].shape[0]
    dev, dt = x.device, x.dtype
    flat = r.expert.flatten()[t0 * K:t1 * K]
    mine = r.keep.flatten()[t0 * K:t1 * K] & (flat >= e0) & (flat < e0 + n_exp)
    if live is not None:
        mine &= live[t0:t1, None].expand(-1, K).reshape(-1)
    key = torch.where(mine, flat - e0, n_exp)
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(n_exp + 1, dtype=torch.int32, device=dev).index_add_(
        0, key, torch.ones_like(key, dtype=torch.int32))
    offsets = torch.zeros(n_exp + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts[:n_exp], 0)
    tally = _TALLY.get()
    if tally is not None:
        tally.add_((counts[:n_exp] > 0).sum())
    xin = x[t0:t1][order // K]
    g = ops.grouped_gemm(xin, p["w_gate"].to(dt), offsets, impl=impl)
    u = ops.grouped_gemm(xin, p["w_up"].to(dt), offsets, impl=impl)
    out = ops.grouped_gemm(F.silu(g) * u, p["w_down"].to(dt), offsets,
                           impl=impl)
    gate = r.gate.flatten()[t0 * K:t1 * K][order].to(dt).float()
    rows = torch.where(mine[order][:, None], out.float() * gate[:, None], 0.0)
    y = torch.zeros_like(rows).index_copy(0, order, rows)
    return y.reshape(t1 - t0, K, d).sum(1)


def _expert_partial_onehot(cfg: ModelConfig, p: Dict[str, torch.Tensor], r: Routing,
                           x: torch.Tensor, e0: int = 0) -> torch.Tensor:
    """`expert_partial` of every token through the reference's (G, Tg, E, C)
    one-hot dispatch and combine einsums, restricted to the experts of `p`
    from e0; the combine in x's dtype, as the reference's."""
    G, Tg, _ = r.expert.shape
    C, E, dt = r.capacity, cfg.num_experts, x.dtype
    n_exp = p["w_gate"].shape[0]
    xt = x.reshape(G, Tg, -1)
    slot_oh = F.one_hot(torch.where(r.keep, r.slot, C), C + 1)[..., :C].to(dt)
    exp_oh = F.one_hot(r.expert, E)[..., e0:e0 + n_exp].to(dt)
    disp = torch.einsum("gtke,gtkc->gtec", exp_oh, slot_oh)
    expert_in = torch.einsum("gtec,gtd->gecd", disp, xt)
    g = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"].to(dt)))
    u = torch.einsum("gecd,edf->gecf", expert_in, p["w_up"].to(dt))
    expert_out = torch.einsum("gecf,efd->gecd", g * u, p["w_down"].to(dt))
    comb = torch.einsum("gtke,gtkc,gtk->gtec", exp_oh, slot_oh, r.gate.to(dt))
    return torch.einsum("gtec,gecd->gtd", comb, expert_out).reshape(G * Tg, -1).float()


def moe_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, *,
              capacity_factor: Optional[float] = None,
              group_size: int = MOE_GROUP_SIZE,
              live: Optional[torch.Tensor] = None, impl: str = "auto",
              aux: bool = True):
    """x (B, S, d) -> (y (B, S, d), aux {"lb_loss", "dropped_frac"}):
    `route`, then `expert_partial` over every expert and token (on "meta"
    the reference's one-hot dispatch), rounded to x's dtype, plus the
    shared expert where the config has one.  live (B, S) bool: the rows
    that are tokens (`expert_partial`); aux False: None in aux's place
    (serving, which reads no load-balance loss)."""
    B, S, d = x.shape
    r = route(cfg, p["router"], x, capacity_factor=capacity_factor, group_size=group_size)
    y = expert_partial(cfg, p, r, x.reshape(B * S, d),
                       live=None if live is None else live.reshape(B * S),
                       impl=impl).reshape(B, S, d).to(x.dtype)
    return _shared(p, x, y), (_aux(cfg, r) if aux else None)


def moe_block_onehot(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, *, capacity_factor: Optional[float] = None,
                     group_size: int = MOE_GROUP_SIZE):
    """The reference's dispatch as it stands: (G, Tg, E, C) one-hot dispatch
    and combine einsums around batched expert products.  Small shapes only;
    the plain version `moe_block` is held against."""
    B, S, d = x.shape
    r = route(cfg, p["router"], x, capacity_factor=capacity_factor, group_size=group_size)
    y = _expert_partial_onehot(cfg, p, r, x.reshape(B * S, d)).reshape(B, S, d).to(x.dtype)
    return _shared(p, x, y), _aux(cfg, r)
