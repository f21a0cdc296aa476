"""Mamba2 SSD chunk scan: the hand CUDA kernels (replacing the Pallas kernel
B3) and their plain PyTorch versions.

`ssd_scan` launches a kernel for CUDA tensors and runs the plain version
`torch_ssd_scan` only for tensors on the CPU.  It picks the kernel by dtype
alone: bf16 goes to the tensor-core kernels of ``csrc/ssd_scan_tc.cu``
(C·Bᵀ once per (batch, chunk), the chunk states, the state passing and the
output as four passes over every chunk in parallel), float32 to the
CUDA-core kernel of ``csrc/ssd_scan.cu`` (one block per row split of a
head, the chunks in series), which holds the f32 path to 2e-5.
`torch_ssd_scan` is the twin of the reference's ``ops._ssd_chunked_xla``:
the chunked (parallel) form of the recurrence, with the sequence padded to
a multiple of `chunk` by ``dt = 0`` tokens and a Python loop where the
reference scans the chunks.  `split_ssd` is the tensor-core kernels'
arithmetic in plain PyTorch, pass by pass, for the CPU tests.

Shapes as ``ref.ssd_reference``: x (b, s, nh, hd), dt (b, s, nh), A and D
(nh,), B and C (b, s, ns); the state is (b, nh, hd, ns) float32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
_STATES = (16, 32, 64, 128)
_TC_HEAD_DIMS = (16, 32, 64, 128)   # bf16 (tensor-core) kernels
_ROWS = (64, 32, 16)          # f32 kernel: state rows per block, largest first
_TILE = 64                    # tokens per tile of the tensor-core kernels
_MAX_CHUNK = 256


def chunk_len(s: int, ns: int) -> int:
    """The tensor-core kernels' own chunk L, whatever chunk the caller names.
    The f32 chunk states cost 16 bytes per state element per chunk in
    scratch traffic (written, read, rewritten in place, read): 16·hd·ns / L
    bytes per token and head, against 4·hd for reading x and writing y.  A
    longer L cuts that, but each row of the output kernel reads L / 2 + 32
    C·Bᵀ values on average from L2.  L = 2 ns, at least a 64-token tile, at
    most 256, and no longer than the sequence rounded up to a tile: 256 at
    state 128; at state 64 (zamba2), 128 took 6 % less time than 256 on an
    H100 (PERF.md)."""
    L = min(_MAX_CHUNK, max(_TILE, 2 * ns))
    return max(_TILE, min(L, -(-s // _TILE) * _TILE))


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ssd_forward():
    fn = _build.load("ssd_scan").ssd_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def _ssd_tc_forward():
    fn = _build.load("ssd_scan_tc").ssd_tc_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    return fn


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + tuple(t.shape[2:]))], 1)


def torch_ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                   chunk: int = 256, init_state: Optional[torch.Tensor] = None,
                   return_state: bool = False):
    """Chunked SSD in f32: O(s·chunk) attention-like work within chunks and
    an O(s/chunk) state recurrence across them.  Returns y in x's dtype
    [, the final f32 state]."""
    b, s, nh, hd = x.shape
    ns = B.shape[-1]
    pad = (-s) % chunk
    sp = s + pad
    nc = sp // chunk
    xf = _pad_seq(x.float(), pad).reshape(b, nc, chunk, nh, hd)
    dtf = _pad_seq(dt.float(), pad).reshape(b, nc, chunk, nh)
    Bf = _pad_seq(B.float(), pad).reshape(b, nc, chunk, ns)
    Cf = _pad_seq(C.float(), pad).reshape(b, nc, chunk, ns)
    Af = A.float()

    seg = torch.cumsum(dtf * Af, dim=2)                    # (b,nc,L,nh) log-decay
    seg_total = seg[:, :, -1]                              # (b,nc,nh)

    # intra-chunk: Y[t] = sum_{u<=t} C_t·B_u x_u dt_u exp(seg_t - seg_u);
    # exp only where t >= u, so a masked entry is an exact 0
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]    # (b,nc,t,u,nh)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.where(tri, rel, 0.0)), 0.0)
    cb = torch.einsum("bcts,bcus->bctu", Cf, Bf)
    scores = cb[..., None] * decay * dtf[:, :, None]
    y_intra = torch.einsum("bctun,bcunh->bctnh", scores, xf)

    # chunk-final states: S_c = sum_u exp(seg_total - seg_u) dt_u x_u ⊗ B_u
    w = torch.exp(seg_total[:, :, None] - seg) * dtf       # (b,nc,L,nh)
    states = torch.einsum("bcunh,bcus->bcnhs", xf * w[..., None], Bf)

    # inter-chunk recurrence over nc: the state entering each chunk
    h = (torch.zeros((b, nh, hd, ns), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * torch.exp(seg_total[:, c])[..., None, None] + states[:, c]
    h_in = torch.stack(h_in, 1)                            # (b,nc,nh,hd,ns)

    # inter-chunk contribution: Y_inter[t] = exp(seg_t) C_t · h_in
    y_inter = torch.einsum("bcts,bcnhs->bctnh", Cf, h_in) * torch.exp(seg)[..., None]
    y = (y_intra + y_inter).reshape(b, sp, nh, hd)[:, :s]
    y = (y + D.float()[None, None, :, None] * x.float()).to(x.dtype)
    return (y, h) if return_state else y


def split_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *, L: int,
              init_state: Optional[torch.Tensor] = None,
              return_state: bool = False,
              operands: Optional[torch.dtype] = None):
    """The tensor-core kernels' passes in plain PyTorch (f32) at their chunk
    `L`: C·Bᵀ once per (batch, chunk); seg, seg_T and the chunk states
    S_c = Σ_u (w_u x_u)ᵀ B_u; the state passing, S[c] overwritten in place
    by the state entering chunk c; then y = (C·Bᵀ ∘ decay ∘ dt)·x +
    exp(seg)·(C·h_inᵀ) + D·x.  `operands=torch.bfloat16` emulates what the
    kernels feed the tensor cores: x, B and C as they are, w_u x_u, the
    masked scores and h_in as pairs hi + lo of bf16 values.  Returns y in
    x's dtype [, the final f32 state]."""
    b, s, nh, hd = x.shape
    ns = B.shape[-1]
    nc = -(-s // L)
    pad = nc * L - s

    def pair(t):
        if operands is None:
            return t
        hi = t.to(operands).float()
        return hi + (t - hi).to(operands).float()
    xf = _pad_seq(x.float(), pad).reshape(b, nc, L, nh, hd)
    dtf = _pad_seq(dt.float(), pad).reshape(b, nc, L, nh)
    Bf = _pad_seq(B.float(), pad).reshape(b, nc, L, ns)
    Cf = _pad_seq(C.float(), pad).reshape(b, nc, L, ns)

    # pass 1: C·Bᵀ of each (batch, chunk), shared by every head
    cb = torch.einsum("bctn,bcun->bctu", Cf, Bf)
    # pass 2: seg, seg_T and each chunk's own state
    seg = torch.cumsum(dtf * A.float(), dim=2)             # (b,nc,L,nh)
    seg_t = seg[:, :, -1]                                  # (b,nc,nh)
    w = torch.exp(seg_t[:, :, None] - seg) * dtf
    st = torch.einsum("bcuhp,bcun->bchpn", pair(xf * w[..., None]), Bf)
    # pass 3: state passing; st[:, c] becomes the state entering chunk c
    h = (torch.zeros((b, nh, hd, ns), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    for c in range(nc):
        s_c = st[:, c].clone()
        st[:, c] = h
        h = torch.exp(seg_t[:, c])[..., None, None] * h + s_c
    # pass 4: output; exp only where t >= u, so a masked score is an exact 0
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]    # (b,nc,t,u,nh)
    decay = torch.where(tri, torch.exp(torch.where(tri, rel, 0.0)), 0.0)
    scores = pair(cb[..., None] * decay * dtf[:, :, None])
    y = (torch.exp(seg)[..., None]
         * torch.einsum("bctn,bchpn->bcthp", Cf, pair(st))
         + torch.einsum("bctuh,bcuhp->bcthp", scores, xf))
    y = y.reshape(b, nc * L, nh, hd)[:, :s] + D.float()[:, None] * x.float()
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def _check_vec(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """x, B, C: read with 16-byte loads of 8 elements along the last dim."""
    if t.dtype != dtype:
        raise TypeError(f"ssd_scan: {name} is {t.dtype}, x is {dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"ssd_scan: {name} needs a contiguous last dim and "
                         "strides that are multiples of 8 elements (16-byte "
                         "vector loads)")


def _rows_per_block(b: int, nh: int, hd: int, index: int) -> int:
    """f32 kernel: the largest row split that still puts two blocks on
    every SM."""
    sms = _n_sms(index)
    for p in _ROWS:
        if hd % p == 0 and b * nh * (hd // p) >= 2 * sms:
            return p
    return _ROWS[-1]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256, init_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """y (b, s, nh, hd) in x's dtype [, the final f32 state (b, nh, hd, ns)].
    CUDA tensors go to a hand kernel (bf16: tensor cores; float32: CUDA
    cores), CPU tensors to `torch_ssd_scan`.

    The kernels tile the sequence in their own chunk whatever `chunk` says
    (the chunk is a tiling of one and the same sum: 64 tokens in f32,
    `chunk_len` in bf16); x, B and C may be strided views, read at their
    own strides.  A call counts one launch, whatever kernels it runs.
    Under autograd it raises (the kernels have no backward: use
    `torch_ssd_scan`)."""
    _build.refuse_autograd("ssd_scan", x, dt, A, B, C, D, init_state)
    if x.device.type == "cpu":
        return torch_ssd_scan(x, dt, A, B, C, D, chunk=chunk,
                              init_state=init_state, return_state=return_state)
    b, s, nh, hd = x.shape
    ns = B.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: unsupported dtype {x.dtype}")
    if chunk <= 0 or hd % 16 or ns not in _STATES \
            or tuple(dt.shape) != (b, s, nh) or tuple(B.shape) != (b, s, ns) \
            or tuple(C.shape) != (b, s, ns) or tuple(A.shape) != (nh,) \
            or tuple(D.shape) != (nh,):
        raise ValueError(f"ssd_scan: unsupported shapes x {tuple(x.shape)} "
                         f"dt {tuple(dt.shape)} B {tuple(B.shape)} "
                         f"C {tuple(C.shape)} A {tuple(A.shape)} "
                         f"D {tuple(D.shape)} (hd a multiple of 16, ns in "
                         f"{_STATES})")
    f32 = [("dt", dt), ("A", A), ("D", D)]
    if init_state is not None:
        if tuple(init_state.shape) != (b, nh, hd, ns):
            raise ValueError("ssd_scan: init_state must be (b, nh, hd, ns), "
                             f"got {tuple(init_state.shape)}")
        f32.append(("init_state", init_state))
    for name, t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be float32, got {t.dtype}")
        if name != "dt" and not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    vec = (("x", x), ("B", B), ("C", C))
    for name, t in vec:
        _check_vec(name, t, x.dtype)
    for name, t in vec + tuple(f32):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}: all operands on one CUDA device")
    for name, t in vec:
        if t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} needs a 16-byte aligned base")
    if x.dtype == torch.bfloat16 and hd not in _TC_HEAD_DIMS:
        raise ValueError(f"ssd_scan: bf16 takes hd in {_TC_HEAD_DIMS}, got {hd}")
    dev = x.device
    y = x.new_empty((b, s, nh, hd))
    h_t = x.new_empty((b, nh, hd, ns), dtype=torch.float32)
    h0 = init_state.data_ptr() if init_state is not None else None
    strides = (*x.stride()[:3], *dt.stride(), B.stride(0), B.stride(1),
               C.stride(0), C.stride(1))
    if x.dtype == torch.bfloat16:
        # one scratch: C·Bᵀ (b, nc, L, L), the chunk states (b, nc, nh, hd,
        # ns) and seg_T (b, nc, nh)
        L = chunk_len(s, ns)
        nc = -(-s // L)
        scratch = x.new_empty(b * nc * (L * L + nh * hd * ns + nh),
                              dtype=torch.float32)
        err = _ssd_tc_forward()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), h0, y.data_ptr(), h_t.data_ptr(), scratch.data_ptr(),
            b, s, nh, hd, ns, L, *strides, _build.raw_stream(dev))
    else:
        err = _ssd_forward()(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), h0, y.data_ptr(), h_t.data_ptr(), b, s, nh, hd, ns,
            _rows_per_block(b, nh, hd, dev.index or 0), *strides,
            _build.raw_stream(dev))
    _build.check(err, "ssd_scan")
    _build.count_launch(ssd_scan)
    return (y, h_t) if return_state else y


#: calls that launched the kernels (the four tensor-core passes count as
#: one) since the count was last set to 0
ssd_scan.launches = 0
