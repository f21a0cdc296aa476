"""AdamW over the port's params tree (plain functions, no torch.optim), with
the reference's Adafactor-style factoring for huge leaves: a second moment
stored as row and column means and a bf16 first moment
(``repro/training/optimizer.py``).

Where factoring is decided.  The reference judges a leaf by its STACKED
size, (L, ...) under "layers" and "encoder"; the port holds one tensor per
layer, so a per-layer leaf is judged by len(stack) x numel (mistral_7b's
per-layer ``w_gate`` is 58.7M elements, stacked 1.88B, so factored).  The
factored arithmetic is the reference's on each layer's slice: ``vr`` and
``vc`` and their mean over the last two axes, any leading axes batched.  A
1-D per-layer leaf whose stack would be factored raises: the reference
would then factor across layers.

Parameters and moments are updated in place under ``torch.no_grad()``, as
the port's caches are; the step count and every scalar stay on the device.

`adamw_update_sharded` is the same step on one rank's shards of a
partitioned train step (`launch/partition.train`), as XLA partitions the
reference's under its fsdp rules: each leaf's sum of squares psummed over
the axes the leaf is cut over (a replicated leaf counts once), the
factored moments' means over a dim cut over some axes the local mean
pmeaned over them.  Factoring follows the moments it is given: they were
made by `adamw_init` on the whole leaves and cut by
`launch/shardings.opt_specs`, so it was decided on the global stacked
shape, never on a shard.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.models.model import tree_like
from repro_torch.sp.common import as_axes

FACTOR_THRESHOLD = 100_000_000     # elements, of the reference's stacked leaf

#: subtrees whose lists hold one tree per layer (the reference's stacked axis)
STACKED = ("layers", "encoder")


class AdamWState(NamedTuple):
    step: torch.Tensor       # scalar int32
    moments: Any             # the params tree, leaves {m, v} or {m, vr, vc}


def _factored(p: torch.Tensor, n_stack: int) -> bool:
    """The reference's rule on the leaf as it stacks it: n_stack layers of
    p (n_stack 0: not stacked)."""
    numel = p.numel() * max(n_stack, 1)
    ndim = p.dim() + (1 if n_stack else 0)
    if not (numel > FACTOR_THRESHOLD and ndim >= 2):
        return False
    if p.dim() < 2:
        raise ValueError(
            f"a 1-D per-layer leaf of {p.numel()} elements stacks to "
            f"{numel} > FACTOR_THRESHOLD: the reference would factor it across "
            "layers")
    return True


def _zip(params, *trees):
    """[(leaf, n_stack, *leaves of the other trees at its place)], in order."""
    out = []
    _zip_into(out, params, list(trees), 0, "")
    return out


def _zip_into(out, p, others, n_stack, key):
    """`_zip`'s walk, at module level: a nested recursive function would
    close over itself and `out`, a cycle that keeps every gradient alive
    until the garbage collector runs."""
    if isinstance(p, dict):
        for k in p:
            _zip_into(out, p[k], [o[k] for o in others], n_stack, k)
    elif isinstance(p, list):
        n = len(p) if key in STACKED else n_stack
        for i, v in enumerate(p):
            _zip_into(out, v, [o[i] for o in others], n, key)
    else:
        out.append((p, n_stack, *others))


def adamw_init(params) -> AdamWState:
    def leaf(p, n_stack):
        if _factored(p, n_stack):
            return {"m": torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device),
                    "vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"m": torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}
    leaves = _zip(params)
    moments = tree_like(params, [leaf(p, n_stack) for p, n_stack in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0][0].device),
                      moments=moments)


def _schedule(step: torch.Tensor, gnorm: torch.Tensor, b1: float, b2: float,
              grad_clip: float):
    """(the clip scale, the new step, the f32 bias corrections)."""
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = step + 1
    stepf = step.float()
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=stepf.device) ** stepf
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=stepf.device) ** stepf
    return scale, step, bc1, bc2


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: float = 1.0) -> Tuple[Any, AdamWState, Dict]:
    """One AdamW step: the global-norm clip, f32 bias corrections, then
    every parameter and moment updated in place.  Returns (params, the new
    state, {"grad_norm"})."""
    leaves = _zip(params, grads, state.moments)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for _, _, g, _ in leaves))
    scale, step, bc1, bc2 = _schedule(state.step, gnorm, b1, b2, grad_clip)
    for p, _, g, mom in leaves:
        g = g.float() * scale
        if "v" in mom:
            m2 = b1 * mom["m"] + (1 - b1) * g
            v2 = b2 * mom["v"] + (1 - b2) * g * g
            vhat = v2 / bc2
            mhat = m2 / bc1
            mom["m"].copy_(m2)
            mom["v"].copy_(v2)
        else:   # factored second moment (Adafactor-style), bf16 first moment
            m2f = b1 * mom["m"].float() + (1 - b1) * g
            g2 = g * g + 1e-30
            vr = b2 * mom["vr"] + (1 - b2) * g2.mean(dim=-1)
            vc = b2 * mom["vc"] + (1 - b2) * g2.mean(dim=-2)
            denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            vhat = (vr[..., :, None] * vc[..., None, :] / denom[..., None]) / bc2
            mhat = m2f / bc1
            mom["m"].copy_(m2f)
            mom["vr"].copy_(vr)
            mom["vc"].copy_(vc)
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step=step, moments=state.moments), {"grad_norm": gnorm}


def leaf_targets(params, moments) -> List[Tuple[torch.Tensor, ...]]:
    """Per leaf (in `_zip` order), the tensors its update writes: the
    parameter and its moments."""
    return [(p, *mom.values()) for p, _, mom in _zip(params, moments)]


@torch.no_grad()
def adamw_update_sharded(rk, params, grads, state: AdamWState, specs, *,
                         own: Callable[[torch.Tensor], bool], shared: List[bool],
                         lr: float = 3e-4,
                         b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                         weight_decay: float = 0.1,
                         grad_clip: float = 1.0) -> Tuple[Any, AdamWState, Dict]:
    """`adamw_update` on rank `rk`'s shards (`partition.Rank`), the leaves
    cut by `specs` (the params' spec tree; their moments by
    `shardings.opt_specs`) and `grads` already summed over each leaf's
    replicated axes.  Every rank computes each update; a tensor is written
    only where `own(tensor)`, and where ranks share a leaf's storage
    (`shared[i]`) only after every rank has read it."""
    leaves = _zip(params, grads, state.moments, specs)
    names = rk.mesh.axis_names

    def cut(spec, dim):
        """The mesh axes of `dim` under `spec`, in the mesh's order."""
        axes = as_axes(spec[dim]) if dim < len(spec) else ()
        return tuple(a for a in names if a in axes)

    def pmean(x, axes):
        return rk.psum(x, axes) / rk.size(axes)
    squares: Dict[Tuple[str, ...], list] = {}
    for _, _, g, _, spec in leaves:
        axes = tuple(a for a in names if any(a in as_axes(e) for e in spec))
        squares.setdefault(axes, []).append(torch.sum(torch.square(g.float())))
    gnorm = torch.sqrt(sum(rk.psum(torch.stack(sq), axes).sum()
                           for axes, sq in squares.items()))
    scale, step, bc1, bc2 = _schedule(state.step, gnorm, b1, b2, grad_clip)
    for i, (p, _, g, mom, spec) in enumerate(leaves):
        g = g.float() * scale
        if "v" in mom:
            new = {"m": b1 * mom["m"] + (1 - b1) * g,
                   "v": b2 * mom["v"] + (1 - b2) * g * g}
            vhat = new["v"] / bc2
            mhat = new["m"] / bc1
        else:
            rows, cols = cut(spec, p.dim() - 1), cut(spec, p.dim() - 2)
            m2f = b1 * mom["m"].float() + (1 - b1) * g
            g2 = g * g + 1e-30
            vr = b2 * mom["vr"] + (1 - b2) * pmean(g2.mean(dim=-1), rows)
            vc = b2 * mom["vc"] + (1 - b2) * pmean(g2.mean(dim=-2), cols)
            denom = torch.clamp(pmean(vr.mean(dim=-1, keepdim=True), cols), min=1e-30)
            vhat = (vr[..., :, None] * vc[..., None, :] / denom[..., None]) / bc2
            mhat = m2f / bc1
            new = {"m": m2f, "vr": vr, "vc": vc}
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        new_p = p.float() - lr * delta
        if shared[i]:
            rk.barrier()
        for t, v in ((p, new_p), *((mom[k], new[k]) for k in mom)):
            if own(t):
                t.copy_(v)
    return params, AdamWState(step=step, moments=state.moments), {"grad_norm": gnorm}
