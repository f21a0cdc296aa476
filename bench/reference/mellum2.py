"""Plain reference of Mellum2 (JetBrains' Mellum2-12B-A2.5B), in float32
PyTorch, for the benchmark's check and the port's CPU tests.

It follows the published configuration (``config.json``: ``layer_types``,
``rope_parameters``, ``mlp_layer_types``): RMSNorm before attention and
before the experts; grouped-query causal softmax attention, within
``sliding_window`` keys (counting the query itself) on the
``sliding_attention`` layers and over every earlier key on the
``full_attention`` ones; rotary embeddings in the half-split
("rotate_half") form, the default frequencies at theta on the windowed
layers and YaRN's on the full layers (dims that turn fewer than
``beta_slow`` times over the original context interpolated by ``factor``,
more than ``beta_fast`` kept, a linear ramp between; cos and sin scaled by
``attention_factor``); a softmax router over every expert, the top K
renormalised to sum to 1 (``norm_topk_prob``), and each expert's SwiGLU
(silu(x W_gate) * x W_up) W_down over its tokens, with no capacity and so
none dropped; a final RMSNorm and an untied head.

Departures from the published model, each also an ``assumed`` entry of the
configuration file: no per-head q/k norm, since the configuration names
none; no MTP head (serving does not use it, and the configuration has no
key for it); the router's product in float32 as everything here.

It imports nothing of the program and runs with TF32 off, one layer at a
time: attention per sequence in blocks of queries, the experts over every
sequence's tokens at once, so it fits beside the weights.

``precision="fp8"`` is the check's control: every linear layer's input (per
token) and weight (per output column) rounded to float8 e4m3 with a
per-row scale before an f32 product, as an fp8 GEMM would compute it: the
projections, the router, each expert's three matrices and the head.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

Q_BLOCK = 1024


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` rounded to e4m3 with one scale per slice along `dim` (the slice
    maximum maps to e4m3's largest normal, 448)."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def rope_tables(hd: int, theta: float, S: int, yarn=None, device=None):
    """cos and sin (S, 1, hd/2) at positions 0..S-1, in float64 then f32:
    the default frequencies theta^(-2i/hd), or YaRN's (a dict of
    ``factor``, ``original_max_position_embeddings``, ``beta_fast``,
    ``beta_slow``, ``attention_factor``)."""
    i = torch.arange(0, hd, 2, dtype=torch.float64, device=device)
    inv = 1.0 / theta ** (i / hd)
    scale = 1.0
    if yarn is not None:
        def dim(rot):
            return hd * math.log(yarn["original_max_position_embeddings"]
                                 / (rot * 2 * math.pi)) / (2 * math.log(theta))
        low = max(math.floor(dim(yarn["beta_fast"])), 0)
        high = min(math.ceil(dim(yarn["beta_slow"])), hd - 1)
        ramp = ((torch.arange(hd // 2, dtype=torch.float64, device=device)
                 - low) / max(high - low, 1e-3)).clamp(0, 1)
        inv = inv * (1 - ramp) + inv / yarn["factor"] * ramp
        scale = yarn["attention_factor"]
    ang = torch.arange(S, dtype=torch.float64, device=device)[:, None] * inv
    return ((torch.cos(ang) * scale).float()[:, None, :],
            (torch.sin(ang) * scale).float()[:, None, :])


class Mellum2:
    """The reference over per-layer weights given as a dict of (in, out)
    matrices (``wq wk wv wo``), the router (d, E), the experts' stacks
    (``w_gate w_up`` (E, d, ff), ``w_down`` (E, ff, d)) and norm vectors
    (``ln1 ln2``), with ``embed`` (V', d), ``final_norm`` (d,) and
    ``lm_head`` (d, V'); V' >= vocab (columns past the vocabulary are
    ignored).  `cfg` holds the sizes (``num_heads``, ``num_kv_heads``,
    ``head_dim``, ``num_experts``, ``experts_per_token``, ``vocab_size``,
    ``norm_eps``, ``rope_theta``, ``full_rope_theta``, ``yarn``) and
    ``layers``, one (H, KV, hd, window) per layer (window 0: a full layer).
    The tensors may be of any dtype and device: each is widened to float32
    when its layer runs."""

    def __init__(self, cfg: Dict, weights: Dict, precision: str = "f32"):
        assert precision in ("f32", "fp8"), precision
        self.cfg, self.w, self.precision = cfg, weights, precision
        _no_tf32()

    def _weight(self, w: torch.Tensor, dim: int = 0) -> torch.Tensor:
        w = w.float()
        return _fp8(w, dim) if self.precision == "fp8" else w

    def _linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w for a weight that `_weight` prepared."""
        return (_fp8(x, -1) if self.precision == "fp8" else x) @ w

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.cfg["norm_eps"]) * w

    @staticmethod
    def _rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    @staticmethod
    def _attention(q, k, v, win: int) -> torch.Tensor:
        """q (S, H, hd), k/v (S, KV, hd) -> (S, H*hd), causal, within `win`
        keys (0: all)."""
        S, H, hd = q.shape
        rep = H // k.shape[1]
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)    # (H, S, hd)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        kpos = torch.arange(S, device=q.device)
        out = torch.empty_like(q)
        for q0 in range(0, S, Q_BLOCK):
            q1 = min(S, q0 + Q_BLOCK)
            k0 = max(0, q0 - win + 1) if win else 0
            s = (q[:, q0:q1] @ k[:, k0:q1].transpose(1, 2)) * hd ** -0.5
            qp = torch.arange(q0, q1, device=q.device)[:, None]
            kp = kpos[None, k0:q1]
            vis = kp <= qp
            if win:
                vis &= qp - kp < win
            s = s.masked_fill(~vis, float("-inf"))
            out[:, q0:q1] = torch.softmax(s, -1) @ v[:, k0:q1]
        return out.transpose(0, 1).reshape(S, H * hd)

    def _attend(self, p: Dict, x: torch.Tensor, li: int) -> torch.Tensor:
        c = self.cfg
        H, KV, hd, win = c["layers"][li]
        S = x.shape[0]
        if win:
            cos, sin = rope_tables(hd, c["rope_theta"], S, device=x.device)
        else:
            cos, sin = rope_tables(hd, c["full_rope_theta"], S, c["yarn"],
                                   device=x.device)
        h = self._norm(x, p["ln1"])
        q = self._rope(self._linear(h, p["wq"]).view(S, H, hd), cos, sin)
        k = self._rope(self._linear(h, p["wk"]).view(S, KV, hd), cos, sin)
        v = self._linear(h, p["wv"]).view(S, KV, hd)
        return x + self._linear(self._attention(q, k, v, win), p["wo"])

    def _experts(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        """x (T, d), any tokens: x + the routed experts' weighted sum."""
        c = self.cfg
        h = self._norm(x, p["ln2"])
        probs = torch.softmax(self._linear(h, p["router"]), -1)
        top, idx = probs.topk(c["experts_per_token"], dim=-1)
        top = top / top.sum(-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(c["num_experts"]):
            tok, k = (idx == e).nonzero(as_tuple=True)
            if not tok.numel():
                continue
            he = h[tok]
            g = torch.nn.functional.silu(self._linear(he, p["w_gate"][e]))
            y = self._linear(g * self._linear(he, p["w_up"][e]), p["w_down"][e])
            # one row per token here: the adds never meet
            out.index_add_(0, tok, y * top[tok, k][:, None])
        return x + out

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               last: Sequence[int]) -> List[torch.Tensor]:
        """For each token sequence (1-D, on the weights' device), the f32
        logits (last_i, vocab) of its final `last_i` positions."""
        V = self.cfg["vocab_size"]
        xs = [self.w["embed"][s].float() for s in seqs]
        cuts = [0]
        for x in xs:
            cuts.append(cuts[-1] + x.shape[0])
        for li, layer in enumerate(self.w["layers"]):
            p = {k: (self._weight(w, w.dim() - 2) if w.dim() >= 2
                     else w.float()) for k, w in layer.items()}
            xs = [self._attend(p, x, li) for x in xs]
            y = self._experts(p, torch.cat(xs))
            xs = [y[a:b] for a, b in zip(cuts, cuts[1:])]
            del p, y
        head = self._weight(self.w["lm_head"][:, :V])
        norm = self.w["final_norm"].float()
        return [self._linear(self._norm(x[-n:], norm), head)
                for x, n in zip(xs, last)]


#: the class the harness runs (`check.load_reference`)
Reference = Mellum2
