"""Mamba2 (SSD) block: in_proj -> causal depthwise conv -> SSD scan -> gated
RMSNorm -> out_proj.  Prefill runs the chunked SSD (``ops.ssd_scan``, the
hand kernel on the card); decode carries (conv_state, ssm_state), constant
memory per token.  The block is composed of pieces the partitioned steps
(`models/tp._mamba`) call on their own: `mamba2_in` (in_proj, the conv,
dt), `mamba2_scan` over a range of heads, `pass_states` / `enter_state`
(the state entering a range of rows, from the states of the rows before
it) and `mamba2_out` (the gated norm, out_proj).

Rounding follows the reference (``models/mamba2.py``): ``A_log``, ``D`` and
``dt_bias`` stay f32 in a bf16 model, dt goes through softplus in f32, and
the conv sums its K taps in the reference's order.  Weights are one dict per
layer, (in, out) like the reference's.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, conv_w - 1, di + 2*ns), model dtype
    ssm: torch.Tensor    # (B, nh, hd, ns) float32


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                device) -> Dict[str, torch.Tensor]:
    """One layer's Mamba2 weights, with the reference's distributions."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ns
    proj_out = 2 * di + 2 * ns + nh   # z, x, B, C, dt

    def normal(*shape, std):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std

    def f32(t):
        return t.to(device=device, dtype=torch.float32)
    return {
        "in_proj": normal(d, proj_out, std=d ** -0.5),
        "conv_w": normal(cfg.ssm_conv, conv_dim, std=0.2),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "dt_bias": f32(torch.zeros(nh)),
        "A_log": f32(torch.log(torch.arange(1, nh + 1, dtype=torch.float32))),
        "D": f32(torch.ones(nh)),
        "norm": torch.ones(di, dtype=dtype, device=device),
        "out_proj": normal(di, d, std=di ** -0.5),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  xbc (B, S, Cd), w (K, Cd).  Returns (y, the
    last K-1 inputs as the new conv state)."""
    K = w.shape[0]
    B, S, Cd = xbc.shape
    pad = (torch.zeros((B, K - 1, Cd), dtype=xbc.dtype, device=xbc.device)
           if prev is None else prev.to(xbc.dtype))
    xp = torch.cat([pad, xbc], dim=1)               # (B, S + K - 1, Cd)
    y = sum(xp[:, i:i + S] * w[i][None, None] for i in range(K)) + b[None, None]
    return F.silu(y), xp[:, S:]


def _split_proj(cfg: ModelConfig, u: torch.Tensor):
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(u, [di, di, ns, ns, nh], dim=-1)     # z, x, B, C, dt


def mamba2_in(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              prev_conv: Optional[torch.Tensor] = None):
    """in_proj, the causal conv and the step sizes of x (B, S, d): (z (B,
    S, di), x (B, S, nh, hd), B, C (B, S, ns), dt (B, S, nh) f32 after
    softplus, A (nh,), the conv state).  x, B and C are strided views of
    the conv's output (the kernel reads them in place)."""
    B, S, _ = x.shape
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    u = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xs, Bm, Cm, dt = _split_proj(cfg, u)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], prev_conv)
    xs, Bm, Cm = torch.split(xbc, [di, ns, ns], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    return z, xs.reshape(B, S, nh, hd), Bm, Cm, dt, A, conv_state


def mamba2_scan(cfg: ModelConfig, p: Dict[str, torch.Tensor], xh, dt, A, Bm, Cm, *,
                heads: Optional[Tuple[int, int]] = None,
                init_state: Optional[torch.Tensor] = None, impl: str = "auto"):
    """The SSD scan (`ops.ssd_scan`) of the heads [h0, h0 + n) (`heads` =
    (h0, n); None: every head) over the rows it is given, B and C shared by
    every head: (y (B, S, n, hd), the final f32 state (B, n, hd, ns))."""
    h0, n = heads if heads is not None else (0, xh.shape[2])
    sl = slice(h0, h0 + n)
    return ops.ssd_scan(xh[:, :, sl], dt[..., sl], A[sl], Bm, Cm, p["D"][sl],
                        chunk=cfg.ssm_chunk, init_state=init_state, return_state=True,
                        impl=impl)


def pass_states(states: torch.Tensor, totals: torch.Tensor,
                n: Optional[int] = None) -> torch.Tensor:
    """The f32 state after the first `n` (default: all k) of k consecutive
    row pieces, each scanned from a zero state: states (k, B, nh, hd, ns)
    their final states, totals (k, B, nh) their rows' summed dt·A; h <-
    exp(T_j) h + S_j from h = 0.  The pieces past `n` enter times 0, so
    that every rank of a mesh runs the same operations on the same
    gathered pieces, as an SPMD program does."""
    h = states.new_zeros(states.shape[1:])
    for j, (s, t) in enumerate(zip(states, totals)):
        on = float(n is None or j < n)
        h = h * torch.exp(t * on)[..., None, None] + s * on
    return h


def enter_state(y: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
                h_in: torch.Tensor) -> torch.Tensor:
    """y (B, s, nh, hd) of a scan from a zero state made the scan's from
    the entering state h_in (B, nh, hd, ns): y_t + exp(Σ_{u<=t} dt_u·A)
    (C_t · h_in), in f32, rounded to y's dtype."""
    seg = torch.cumsum(dt * A, dim=1)                                 # (B, s, nh)
    corr = torch.einsum("bsn,bhpn->bshp", C.float(), h_in) * torch.exp(seg)[..., None]
    return (y.float() + corr).to(y.dtype)


def mamba2_out(cfg: ModelConfig, p: Dict[str, torch.Tensor], y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """The gated RMSNorm over d_inner and out_proj: y, z (B, S, di) -> (B,
    S, d) in z's dtype."""
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"].to(z.dtype))


def mamba2_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 state: Optional[SSMState] = None, *, return_state: bool = False,
                 impl: str = "auto"):
    """x (B, S, d) -> y (B, S, d) [, SSMState]: `mamba2_in`, `mamba2_scan`
    over every head, `mamba2_out`."""
    B, S, _ = x.shape
    z, xh, Bm, Cm, dt, A, conv_state = mamba2_in(
        cfg, p, x, state.conv if state is not None else None)
    y, ssm_state = mamba2_scan(cfg, p, xh, dt, A, Bm, Cm, impl=impl,
                               init_state=state.ssm if state is not None else None)
    out = mamba2_out(cfg, p, y.reshape(B, S, cfg.d_inner), z)
    if return_state:
        return out, SSMState(conv=conv_state, ssm=ssm_state)
    return out


def mamba2_step(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                state: SSMState):
    """One-token decode.  x (B, d) -> (y (B, d), the new SSMState)."""
    B, d = x.shape
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    u = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xs, Bm, Cm, dt = _split_proj(cfg, u)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)           # (B, Cd)
    window = torch.cat([state.conv.to(xbc.dtype), xbc[:, None]], dim=1)  # (B,K,Cd)
    y = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(xbc.dtype)) + p["conv_b"]
    xbc = F.silu(y)
    xs, Bm, Cm = torch.split(xbc, [di, ns, ns], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"][None])
    A = -torch.exp(p["A_log"])
    yh, new_ssm = ops.ssd_step(xs.reshape(B, nh, hd), dt, A, Bm, Cm, p["D"],
                               state.ssm)
    y = rms_norm(yh.reshape(B, di) * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    return out, SSMState(conv=window[:, 1:], ssm=new_ssm)


def init_ssm_state(cfg: ModelConfig, n_layers: int, batch: int,
                   dtype: torch.dtype, device) -> SSMState:
    """Zero states for `n_layers` layers: conv (L, B, K-1, Cd) in `dtype`,
    ssm (L, B, nh, hd, ns) f32."""
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    return SSMState(
        conv=torch.zeros((n_layers, batch, cfg.ssm_conv - 1, di + 2 * ns),
                         dtype=dtype, device=device),
        ssm=torch.zeros((n_layers, batch, nh, hd, ns), dtype=torch.float32,
                        device=device))
