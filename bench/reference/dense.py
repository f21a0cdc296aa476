"""Plain reference of a dense pre-norm GQA transformer (Mistral, Phi-3), in
float32 PyTorch, for the benchmark's check.

It follows the published description of both models: RMSNorm before
attention and before the MLP, rotary embeddings in the half-split
("rotate_half") form with the configuration's theta, grouped-query causal
softmax attention (within ``sliding_window`` keys, counting the query
itself, where the configuration sets one), SwiGLU (silu(x W_gate) * x W_up)
W_down, a final RMSNorm and an untied head over the configuration's
vocabulary.  Phi-3's fused qkv and gate/up projections are the same
products as the separate ones here.  It imports nothing of the program and
runs with TF32 off, one layer at a time over every sequence, attention in
blocks of queries, so it fits beside the weights.

``precision="fp8"`` is the check's control: every linear layer's input
(per token) and weight (per output column) rounded to float8 e4m3 with a
per-row scale before an f32 product, as an fp8 GEMM would compute it.
"""
from __future__ import annotations

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


class Dense:
    """The reference over per-layer weights given as a dict of (in, out)
    matrices (``wq wk wv wo w_gate w_up w_down``) and norm vectors
    (``ln1 ln2``), with ``embed`` (V', d), ``final_norm`` (d,) and
    ``lm_head`` (d, V'); V' >= vocab (columns past the vocabulary are
    ignored).  The tensors may be of any dtype and device: each is widened
    to float32 when its layer runs."""

    def __init__(self, cfg: Dict, weights: Dict, precision: str = "f32"):
        assert precision in ("f32", "fp8"), precision
        self.cfg, self.w, self.precision = cfg, weights, precision
        _no_tf32()

    def _weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.precision == "fp8" else w

    def _linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w for a weight that `_weight` prepared."""
        return (_fp8(x, -1) if self.precision == "fp8" else x) @ w

    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                               + self.cfg["norm_eps"]) * w

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (S, n, hd) at positions 0..S-1."""
        S, hd = x.shape[0], x.shape[-1]
        half = hd // 2
        inv = 1.0 / (self.cfg["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd))
        ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """q (S, H, hd), k/v (S, KV, hd) -> (S, H*hd), causal."""
        S, H, hd = q.shape
        rep = H // k.shape[1]
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)    # (H, S, hd)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        win = self.cfg["sliding_window"]
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

    def _layer(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        H, KV, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
        S = x.shape[0]
        h = self._norm(x, p["ln1"])
        q = self._rope(self._linear(h, p["wq"]).view(S, H, hd))
        k = self._rope(self._linear(h, p["wk"]).view(S, KV, hd))
        v = self._linear(h, p["wv"]).view(S, KV, hd)
        x = x + self._linear(self._attention(q, k, v), p["wo"])
        h = self._norm(x, p["ln2"])
        g = torch.nn.functional.silu(self._linear(h, p["w_gate"]))
        return x + self._linear(g * self._linear(h, p["w_up"]), p["w_down"])

    @torch.no_grad()
    def logits(self, seqs: Sequence[torch.Tensor],
               last: Sequence[int]) -> List[torch.Tensor]:
        """For each token sequence (1-D, on the weights' device), the f32
        logits (last_i, vocab) of its final `last_i` positions."""
        V = self.cfg["vocab_size"]
        xs = [self.w["embed"][s].float() for s in seqs]
        for layer in self.w["layers"]:
            p = {k: (self._weight(w) if w.dim() == 2 else w.float())
                 for k, w in layer.items()}
            xs = [self._layer(p, x) for x in xs]
            del p
        head = self._weight(self.w["lm_head"][:, :V])
        norm = self.w["final_norm"].float()
        return [self._linear(self._norm(x[-n:], norm), head)
                for x, n in zip(xs, last)]
