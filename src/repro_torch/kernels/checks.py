"""Agreement checks of the hand kernels against their plain versions, shared
by `chip_smoke.py` and the tests: the relative-norm measure, B1's and B2's
checks with the edge cases of the encoder-decoder path, B3's inputs and
edge grid, and B3's check with the faults it must be able to see.

B1 in bf16 is held to 2e-2 elementwise and to B1_REL_TOL per (batch, head)
against its plain version in f32 (the bf16 roundings of P and the output
read ~2e-3, a dropped 128-key tile 2e-2 or more); in f32 to 2e-5 both ways.

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

from repro_torch.kernels.flash_attention import flash_attention, torch_attention
from repro_torch.kernels.flash_decode import flash_decode, torch_decode
from repro_torch.kernels.ssd_kernel import chunk_len, ssd_scan, torch_ssd_scan

TOL = 2e-2           # bf16: atol = rtol, one rounding of the output
B1_REL_TOL = 5e-3    # bf16 B1, per (batch, head)
SSD_REL_TOL = 5e-3   # bf16 B3, y and the state, per (batch, head)
F32_TOL = 2e-5       # f32 kernels: sums in another order

#: B1 at the edges the encoder-decoder path adds, head dim 64 and 16 MHA
#: heads as seamless_m4t_large_v2: (name, b, sq, sk, causal, q_offset,
#: kv_len).  The decoder's BOS prefill runs one query row in a 128-row tile,
#: causal (against a long cache at an offset, and at offset 0 where it sees
#: key 0 alone) and across to the encoder's 1024 frames; the encoder runs
#: 1024 rows unmasked.  kv_len 0 gives an empty row (0, LSE -inf).
CROSS_ATTENTION_EDGES = [
    ("fa_sq1_causal_at1023_of_1024", 4, 1, 1024, True, 1023, (1024, 700, 1, 0)),
    ("fa_sq1_causal_at0_of_1024", 4, 1, 1024, True, 0, (1024, 700, 1, 0)),
    ("fa_sq1_cross_1024", 4, 1, 1024, False, 0, (1024, 1000, 129, 1)),
    ("fa_noncausal_1024", 2, 1024, 1024, False, 0, (1024, 777)),
]


#: B1 and B2 at the shapes whose outputs the reference's own Pallas kernels
#: give (interpret mode, on a CPU: tests/test_torch_kernels.py run as a
#: script writes them to tests/data/attention_reference.npz, f32 values,
#: "<name>.<dtype>" for float32 and bfloat16): name -> (kernel, b, h, kvh,
#: sq, sk, d, causal, window, q_offset, lengths), lengths B1's kv_len or
#: B2's cache_len per row (None: every key).  Causal with GQA; unmasked at
#: D 64 (the encoder); one query row across the frames with a ragged
#: kv_len (the cross attention); a window at a q_offset; B2 ragged, and
#: over a full cross cache.
REFERENCE_CASES = {
    "b1_causal_gqa": ("attention", 1, 4, 2, 160, 160, 64, True, 0, 0, None),
    "b1_encoder": ("attention", 1, 2, 2, 192, 192, 64, False, 0, 0, None),
    "b1_cross_row": ("attention", 4, 4, 4, 1, 300, 64, False, 0, 0, (300, 257, 129, 1)),
    "b1_window_offset": ("attention", 1, 4, 1, 64, 200, 64, True, 40, 136, None),
    "b2_ragged": ("decode", 4, 8, 2, 1, 300, 128, False, 0, 0, (300, 211, 64, 1)),
    "b2_cross_full": ("decode", 4, 4, 4, 1, 256, 64, False, 0, 0, (256, 256, 256, 256)),
}


def reference_inputs(name: str, dtype: str):
    """(q, k, v, lengths or None) of REFERENCE_CASES[name], numpy f32 from a
    seed (bfloat16: rounded to bf16 values, exact in f32); q (b, h, sq, d)
    for B1, (b, h, d) for B2."""
    import numpy as np
    kernel, b, h, kvh, sq, sk, d, *_, lengths = REFERENCE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    q = rng.standard_normal((b, h, sq, d) if kernel == "attention" else (b, h, d))
    k, v = (rng.standard_normal((b, kvh, sk, d)) for _ in range(2))
    out = [torch.from_numpy(t.astype(np.float32)) for t in (q, k, v)]
    if dtype == "bfloat16":
        out = [t.bfloat16().float() for t in out]
    return (*(t.numpy() for t in out),
            None if lengths is None else np.array(lengths, dtype=np.int32))


def reference_call(name: str, q, k, v, lengths, fn_attention, fn_decode):
    """REFERENCE_CASES[name] run by `fn_attention(q, k, v, causal=,
    sliding_window=, q_offset=, kv_len=)` or `fn_decode(q, k, v, cache_len,
    sliding_window=)`."""
    kernel, *_, causal, window, q_offset, _ = REFERENCE_CASES[name]
    if kernel == "attention":
        return fn_attention(q, k, v, causal=causal, sliding_window=window,
                            q_offset=q_offset, kv_len=lengths)
    return fn_decode(q, k, v, lengths, sliding_window=window)


def reference_agrees(got: torch.Tensor, want: torch.Tensor, dtype: str) -> float:
    """A B1 or B2 output against the reference's: f32 F32_TOL elementwise
    (the reading: max |err|), bf16 B1_REL_TOL in relative norm per (batch,
    head) (the reading: that norm).  Raises AssertionError."""
    if dtype == "float32":
        err = (got.float() - want).abs().max().item()
        if not torch.allclose(got.float(), want, atol=F32_TOL, rtol=F32_TOL):
            raise AssertionError(f"max |err| {err} against the reference (tol {F32_TOL})")
        return err
    rel = rel_err(got, want)
    if not rel < B1_REL_TOL:
        raise AssertionError(f"||got - want|| / ||want|| {rel} against the reference "
                             f"(limit {B1_REL_TOL})")
    return rel


def attention_inputs(b: int, h: int, kvh: int, d: int, sq: int, sk: int, *,
                     generator: torch.Generator, device,
                     dtype: torch.dtype = torch.bfloat16):
    """q (b, h, sq, d), k and v (b, kvh, sk, d), each a transposed view of a
    (b, s, heads, d) projection, as `attention_block` passes them."""
    def rn(s, n):
        return torch.randn((b, s, n, d), generator=generator, device=device
                           ).to(dtype).transpose(1, 2)
    return rn(sq, h), rn(sk, kvh), rn(sk, kvh)


def attention_check(name: str, q, k, v, *, fault_keys: Tuple[int, ...] = (),
                    **kw) -> dict:
    """B1 on the card against `torch_attention` in f32 on the same inputs:
    elementwise (TOL in bf16, F32_TOL in f32), in relative norm per (batch,
    head) (B1_REL_TOL, F32_TOL), rows with no visible key 0 with LSE -inf
    where the plain version has them, and two identical calls bit-equal.
    `fault_keys`: for each n, the plain version with n keys of every
    sequence dropped from its end (the last key, a key tile) must read
    above the relative limit.  Returns the readings; raises
    AssertionError."""
    bf16 = q.dtype == torch.bfloat16
    tol, rel_tol = (TOL, B1_REL_TOL) if bf16 else (F32_TOL, F32_TOL)
    kw = dict(kw, return_lse=True)
    got, lse = flash_attention(q, k, v, **kw)
    want, want_lse = torch_attention(q.float(), k.float(), v.float(), **kw)
    empty = torch.isneginf(want_lse)
    if not (torch.equal(torch.isneginf(lse), empty) and bool((got[empty] == 0).all())):
        raise AssertionError(f"{name}: empty rows are not 0 with LSE -inf")
    err = max((got.float() - want.to(q.dtype).float()).abs().max().item(),
              (lse[~empty] - want_lse[~empty]).abs().max().item() if bool((~empty).any())
              else 0.0)
    if not (torch.allclose(got.float(), want.to(q.dtype).float(), atol=tol, rtol=tol)
            and torch.allclose(lse[~empty], want_lse[~empty], atol=tol, rtol=tol)):
        raise AssertionError(f"{name}: kernel disagrees with its plain version, "
                             f"max |err| {err} (tol {tol})")
    rel = rel_err(got, want)
    if not rel < rel_tol:
        raise AssertionError(f"{name}: ||got - want|| / ||want|| {rel} in a "
                             f"(batch, head) (limit {rel_tol})")
    again, again_lse = flash_attention(q, k, v, **kw)
    if not (torch.equal(again, got) and torch.equal(again_lse, lse)):
        raise AssertionError(f"{name}: two identical calls differ")
    out = dict(case=name, empty_rows=int(empty.sum()), max_abs_err=err, tol=tol,
               rel_err=rel, rel_tol=rel_tol, bit_equal_repeat=True)
    kv_len = kw.get("kv_len")
    if kv_len is None:
        kv_len = torch.full((q.shape[0],), k.shape[2], device=q.device)
    for n in fault_keys:
        fault, _ = torch_attention(q.float(), k.float(), v.float(), **dict(
            kw, kv_len=(kv_len - n).clamp_min(0)))
        reading = out[f"fault_drop{n}_rel_err"] = rel_err(fault.to(q.dtype), want)
        if not reading > rel_tol:
            raise AssertionError(f"{name}: {n} dropped keys read {reading}, "
                                 f"inside the limit {rel_tol}")
    return out


def decode_check(name: str, q, k, v, cache_len, *, sliding_window: int = 0,
                 fault_keys: Tuple[int, ...] = ()) -> dict:
    """B2 on the card against `torch_decode` (TOL in bf16, F32_TOL in f32),
    0 where cache_len is 0, two identical calls bit-equal.  `fault_keys`:
    for each n, the plain version with n keys of every sequence dropped
    from its end (the last key, a split) must fail the same elementwise
    check.  Returns the readings; raises AssertionError."""
    tol = TOL if q.dtype == torch.bfloat16 else F32_TOL
    got = flash_decode(q, k, v, cache_len, sliding_window=sliding_window)
    empty = cache_len == 0
    if not bool((got[empty] == 0).all()):
        raise AssertionError(f"{name}: cache_len 0 did not give 0")
    # where cache_len is 0 the reference's windowed XLA path (and so
    # torch_decode) averages the cache instead of giving 0
    want = torch_decode(q, k, v, cache_len, sliding_window=sliding_window)
    got_f, want_f = got[~empty].float(), want[~empty].float()
    err = (got_f - want_f).abs().max().item()
    if not torch.allclose(got_f, want_f, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain version, "
                             f"max |err| {err} (tol {tol})")
    if not torch.equal(flash_decode(q, k, v, cache_len, sliding_window=sliding_window),
                       got):
        raise AssertionError(f"{name}: two identical calls differ")
    out = dict(case=name, cache_len=cache_len.tolist(), max_abs_err=err, tol=tol,
               bit_equal_repeat=True)
    for n in fault_keys:
        fault = torch_decode(q, k, v, (cache_len - n).clamp_min(0),
                             sliding_window=sliding_window)[~empty].float()
        reading = out[f"fault_drop{n}_max_abs_err"] = \
            (fault - want_f).abs().max().item()
        if torch.allclose(fault, want_f, atol=tol, rtol=tol):
            raise AssertionError(f"{name}: {n} dropped keys pass the check "
                                 f"(max |err| {reading})")
    return out


def cross_edge_checks(*, generator: torch.Generator, device,
                      dtype: torch.dtype = torch.bfloat16) -> List[dict]:
    """B1 on `CROSS_ATTENTION_EDGES` and B2 over a full cross cache
    (cache_len = S = 1024 for every sequence), at D 64 with 16 MHA heads.
    Returns the readings; raises AssertionError."""
    out = []
    h, d = 16, 64
    for name, b, sq, sk, causal, qo, kvl in CROSS_ATTENTION_EDGES:
        q, k, v = attention_inputs(b, h, h, d, sq, sk, generator=generator,
                                   device=device, dtype=dtype)
        kv_len = torch.tensor(kvl, dtype=torch.int32, device=device)
        out.append(attention_check(name, q, k, v, causal=causal, q_offset=qo,
                                   kv_len=kv_len))
    b, s = 4, 1024
    q = torch.randn((b, h, d), generator=generator, device=device).to(dtype)
    k, v = (torch.randn((b, h, s, d), generator=generator, device=device).to(dtype)
            for _ in range(2))
    out.append(decode_check("fd_cross_full_1024", q, k, v,
                            torch.full((b,), s, dtype=torch.int32, device=device)))
    return out


#: B1 and B2 in f32 at the shapes the evaluation path's engine cells give
#: them (`experiments.runner.engine_stack`: the reduced f32 mistral_7b, 4
#: query / 2 KV heads of 64, a 128-token context): B1 causal at batch 1
#: over the prompt buckets (4-96 tokens) and prefix-cache suffixes at
#: q_offset 16 and 32, B2 at 8 slots over a 128-key cache.  Also a full
#: context, a length off the 64-key tile and a ragged kv_len.  Each case
#: has two faults that must read above its limit: the last key dropped,
#: and 64 keys dropped (one key tile of B1's f32 kernel, one of B2's two
#: splits at S 128 on an H100's 132 SMs).
ENGINE_F32_HEADS = (4, 2, 64)          # query heads, KV heads, head dim
ENGINE_F32_FAULT_KEYS = (1, 64)
#: (name, b, sq, sk, q_offset, kv_len)
ENGINE_F32_ATTENTION = [
    ("fa_f32_engine_4", 1, 4, 4, 0, None),
    ("fa_f32_engine_24", 1, 24, 24, 0, None),
    ("fa_f32_engine_96", 1, 96, 96, 0, None),
    ("fa_f32_engine_128", 1, 128, 128, 0, None),
    ("fa_f32_engine_suffix_8_at_16", 1, 8, 24, 16, None),
    ("fa_f32_engine_suffix_16_at_32", 1, 16, 48, 32, None),
    ("fa_f32_engine_ragged_100", 2, 100, 100, 0, (100, 63)),
]
#: (name, cache_len of the 8 slots)
ENGINE_F32_DECODE = [
    ("fd_f32_engine_split_edges", (1, 5, 63, 64, 65, 99, 127, 128)),
    ("fd_f32_engine_ragged", (1, 7, 13, 19, 33, 50, 66, 98)),
]


def engine_f32_checks(*, generator: torch.Generator, device) -> List[dict]:
    """B1 on `ENGINE_F32_ATTENTION` and B2 on `ENGINE_F32_DECODE`, in f32
    with `attention_check` / `decode_check`, each with its dropped-keys
    faults.  Returns the readings; raises AssertionError."""
    h, kvh, d = ENGINE_F32_HEADS
    out = []
    for name, b, sq, sk, qo, kvl in ENGINE_F32_ATTENTION:
        q, k, v = attention_inputs(b, h, kvh, d, sq, sk, generator=generator,
                                   device=device, dtype=torch.float32)
        kv_len = (torch.tensor(kvl, dtype=torch.int32, device=device)
                  if kvl else None)
        out.append(attention_check(name, q, k, v, causal=True, q_offset=qo,
                                   kv_len=kv_len,
                                   fault_keys=ENGINE_F32_FAULT_KEYS))
    s = 128
    for name, lens in ENGINE_F32_DECODE:
        b = len(lens)
        q = torch.randn((b, h, d), generator=generator, device=device)
        k, v = (torch.randn((b, kvh, s, d), generator=generator, device=device)
                for _ in range(2))
        out.append(decode_check(name, q, k, v,
                                torch.tensor(lens, dtype=torch.int32, device=device),
                                fault_keys=ENGINE_F32_FAULT_KEYS))
    return out


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
