"""Mamba2 SSD chunk scan: the hand CUDA kernel (``csrc/ssd_scan.cu``,
replacing the Pallas kernel B3) and its plain PyTorch version.

`ssd_scan` launches the kernel for CUDA tensors and runs the plain version
`torch_ssd_scan` only for tensors on the CPU.  `torch_ssd_scan` is the twin
of the reference's ``ops._ssd_chunked_xla``: the chunked (parallel) form of
the recurrence, with the sequence padded to a multiple of `chunk` by
``dt = 0`` tokens and a Python loop where the reference scans the chunks.

Shapes as ``ref.ssd_reference``: x (b, s, nh, hd), dt (b, s, nh), A and D
(nh,), B and C (b, s, ns); the state is (b, nh, hd, ns) float32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STATES = (16, 32, 64, 128)
_ROWS = (64, 32, 16)          # state rows per block, largest first


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


def _check_vec(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """x, B, C: read with 16-byte loads of 8 elements along the last dim."""
    if t.dtype != dtype:
        raise TypeError(f"ssd_scan: {name} is {t.dtype}, x is {dtype}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"ssd_scan: {name} needs a contiguous last dim and "
                         "strides that are multiples of 8 elements (16-byte "
                         "vector loads)")


def _rows_per_block(b: int, nh: int, hd: int, device) -> int:
    """The largest row split that still puts two blocks on every SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for p in _ROWS:
        if hd % p == 0 and b * nh * (hd // p) >= 2 * sms:
            return p
    return _ROWS[-1]


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 256, init_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """y (b, s, nh, hd) in x's dtype [, the final f32 state (b, nh, hd, ns)].
    CUDA tensors go to the hand kernel, CPU tensors to `torch_ssd_scan`.

    The kernel tiles the sequence in its own chunk of 64 tokens whatever
    `chunk` says (the chunk is a tiling of one and the same sum); x, B and C
    may be strided views, read at their own strides."""
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
    y = torch.empty((b, s, nh, hd), dtype=x.dtype, device=x.device)
    h_t = torch.empty((b, nh, hd, ns), dtype=torch.float32, device=x.device)
    lib = _build.load("ssd_scan")
    fn = lib.ssd_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(), D.data_ptr(),
             init_state.data_ptr() if init_state is not None else None,
             y.data_ptr(), h_t.data_ptr(), b, s, nh, hd, ns,
             _rows_per_block(b, nh, hd, x.device),
             *x.stride()[:3], *dt.stride(), B.stride(0), B.stride(1),
             C.stride(0), C.stride(1), _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return (y, h_t) if return_state else y


#: launches of the CUDA kernel since the count was last set to 0
ssd_scan.launches = 0
