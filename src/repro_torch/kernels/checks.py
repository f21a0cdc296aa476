"""Agreement checks of the hand kernels against their plain versions, shared
by `chip_smoke.py` and the tests: the relative-norm measure, B3's inputs
and edge grid, and B3's check with the faults it must be able to see.

A bf16 B3 output is held to SSD_REL_TOL in ||got - want|| / ||want|| per
(batch, head), on y and on the final state, against the plain version in
f32.  The limit was set from a CPU emulation of the kernels' bf16 operands
(`split_ssd(operands=torch.bfloat16)`), which reads ~1.7e-3 on y (its own
bf16 rounding) and far less on the state; each planted fault below must
read above it, or the check could not see that fault.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.ssd_kernel import chunk_len, ssd_scan, torch_ssd_scan

TOL = 2e-2           # bf16: atol = rtol, one rounding of the output
SSD_REL_TOL = 5e-3   # bf16 B3, y and the state, per (batch, head)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ||got - want|| / ||want|| over the slices of the first two
    dims, `want` in f32; slices where `want` is all zero are left out."""
    diff = (got.float() - want).flatten(2).norm(dim=-1)
    ref = want.flatten(2).norm(dim=-1)
    keep = ref > 0
    return (diff[keep] / ref[keep]).max().item() if bool(keep.any()) else 0.0


def ssd_rel(y, h, wy, wh) -> Tuple[float, float]:
    """(y, state) readings of `rel_err` per (batch, head): y is
    (b, s, nh, hd), the state (b, nh, hd, ns)."""
    return rel_err(y.transpose(1, 2), wy.transpose(1, 2)), rel_err(h, wh)


def ssd_inputs(b: int, s: int, nh: int, hd: int, ns: int, *, init: bool,
               generator: torch.Generator, device, slow: bool = False,
               dtype: torch.dtype = torch.bfloat16, dt_shift: float = 3.0):
    """(xbc, x, dt, A, B, C, D, h0): x, B and C strided views of one conv
    output, as the model passes them; dt = softplus(N(0, 1) - dt_shift) and
    A = -(1 .. nh), so a 128-token chunk keeps 1e-4 of the state or less.
    `slow`: A = -linspace(0.005, 0.5, nh) and dt_shift 5, so a chunk keeps
    0.2-0.99 of it and the state entering the sequence and every chunk's
    carry reach its end."""
    kw = dict(generator=generator, device=device)
    xbc = torch.randn((b, s, nh * hd + 2 * ns), dtype=dtype, **kw)
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    B, C = xbc[..., nh * hd:nh * hd + ns], xbc[..., nh * hd + ns:]
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), **kw) - (5.0 if slow else dt_shift))
    A = (-torch.linspace(0.005, 0.5, nh, device=device) if slow
         else -torch.arange(1, nh + 1, dtype=torch.float32, device=device))
    D = torch.ones((nh,), dtype=torch.float32, device=device)
    h0 = torch.randn((b, nh, hd, ns), **kw) * 0.1 if init else None
    return xbc, x, dt, A, B, C, D, h0


def ssd_edge_cases(ns: int, b: int) -> List[Tuple[int, bool, bool]]:
    """(s, init, slow) at the edges of the tensor-core kernels' 64-token
    tiles and of their chunk L (128 at ns 64, 256 at ns 128), and one
    slow-decay sequence of 17 chunks and a ragged tail with an entering
    state: more than two of the state passing's 8-chunk load groups."""
    L = chunk_len(1 << 20, ns)
    fast = [(s, (i + b) % 2 == 0, False)
            for i, s in enumerate((1, 63, 64, 65, L - 1, L, L + 1, 2 * L + 63))]
    return fast + [(17 * L + 37, True, True)]


def _cut_carry(x, dt, A, B, C, D, init_state, L):
    """The plain version with the state entering chunk c (of L tokens) only
    chunk c-1's own state, h_in[c] = S[c-1], for c >= 1: chunk c's rows and,
    for the last chunk, the final state come from a scan of chunks c-1 and
    c from a zero state."""
    s = x.shape[1]

    def scan(a, e, h0):
        return torch_ssd_scan(x[:, a:e], dt[:, a:e], A, B[:, a:e], C[:, a:e],
                              D, chunk=L, init_state=h0, return_state=True)
    y, h = scan(0, min(s, L), init_state)
    ys = [y]
    for a in range(0, s - L, L):
        y, h = scan(a, min(s, a + 2 * L), None)
        ys.append(y[:, L:])
    return torch.cat(ys, 1), h


def ssd_faults(x, dt, A, B, C, D, *, init_state: Optional[torch.Tensor],
               carry: bool) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The plain version in f32 with a fault planted, (y, state) each:
    `tile_y` and `tile_state` a 64-token u-tile dropped (its B rows zeroed;
    the last whole tile, the last tile); with `carry`, `carry` the state
    passing cut to the previous chunk (at the kernels' chunk L) and `init`
    the entering state dropped."""
    s = x.shape[1]
    x, B, C = x.float(), B.float(), C.float()
    kw = dict(chunk=64, init_state=init_state, return_state=True)
    out = {}
    for name, t0 in (("tile_y", max(0, s - 64) // 64 * 64),
                     ("tile_state", (s - 1) // 64 * 64)):
        Bd = B.clone()
        Bd[:, t0:t0 + 64] = 0
        out[name] = torch_ssd_scan(x, dt, A, Bd, C, D, **kw)
    if carry:
        L = chunk_len(s, B.shape[-1])
        if s <= 2 * L or init_state is None:
            raise ValueError("the carry faults need more than two chunks "
                             "and an entering state")
        out["carry"] = _cut_carry(x, dt, A, B, C, D, init_state, L)
        out["init"] = torch_ssd_scan(x, dt, A, B, C, D, **dict(kw, init_state=None))
    return out


def ssd_judge(name: str, y, h, wy, wh, faults) -> dict:
    """y, h (bf16 y, f32 state) within SSD_REL_TOL of wy, wh (the plain
    version in f32) per (batch, head), and every fault reading above it:
    `tile_y` on y, `tile_state` on the state, `carry` and `init` on both.
    Returns the readings; raises AssertionError."""
    rel = ssd_rel(y, h, wy, wh)
    if not max(rel) < SSD_REL_TOL:
        raise AssertionError(f"{name}: ||got - want|| / ||want|| (y, state) "
                             f"{rel} in a (batch, head) (limit {SSD_REL_TOL})")
    out = dict(rel_err_y=rel[0], rel_err_state=rel[1], rel_tol=SSD_REL_TOL)
    for fault, (fy, fh) in faults.items():
        got = ssd_rel(fy.to(y.dtype), fh, wy, wh)
        got = {"tile_y": got[:1], "tile_state": got[1:]}.get(fault, got)
        if not min(got) > SSD_REL_TOL:
            raise AssertionError(f"{name}: the fault {fault} reads {got}, "
                                 f"inside the limit {SSD_REL_TOL}")
        out[f"fault_{fault}"] = got if len(got) > 1 else got[0]
    return out


def ssd_check(name: str, x, dt, A, B, C, D, *, chunk: int,
              init_state: Optional[torch.Tensor], carry: bool = False) -> dict:
    """B3 bf16 on the card against the plain version: two identical calls
    bit-equal and counted once each, y and the final state within TOL of
    the plain version and held by `ssd_judge` against it and the planted
    faults of `ssd_faults`.  Returns the readings; raises AssertionError."""
    kw = dict(chunk=chunk, init_state=init_state, return_state=True)
    before = ssd_scan.launches
    y, h = ssd_scan(x, dt, A, B, C, D, **kw)
    y2, h2 = ssd_scan(x, dt, A, B, C, D, **kw)
    if ssd_scan.launches != before + 2:
        raise AssertionError(f"{name}: a call did not count one launch")
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        raise AssertionError(f"{name}: two identical calls differ")
    wy, wh = torch_ssd_scan(x.float(), dt, A, B.float(), C.float(), D, **kw)
    err = max((y.float() - wy.to(y.dtype).float()).abs().max().item(),
              (h - wh).abs().max().item())
    if not (torch.allclose(y.float(), wy.to(y.dtype).float(), atol=TOL, rtol=TOL)
            and torch.allclose(h, wh, atol=TOL, rtol=TOL)):
        raise AssertionError(f"{name}: kernel disagrees with its plain version, "
                             f"max |err| {err} (tol {TOL})")
    faults = ssd_faults(x, dt, A, B, C, D, init_state=init_state, carry=carry)
    return dict(max_abs_err=err, tol=TOL, bit_equal_repeat=True,
                **ssd_judge(name, y, h, wy, wh, faults))
