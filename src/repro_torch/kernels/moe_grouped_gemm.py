"""The routed experts' grouped GEMM: the hand CUDA kernel B4
(``csrc/moe_grouped_gemm.cu``) and its plain PyTorch version.

``c[r] = a[r] @ b[e]`` for the rows ``offsets[e] <= r < offsets[e + 1]``
of each expert e: `a` holds an MoE layer's (token, k) assignments sorted by
expert, `offsets` (E + 1,) the experts' row bounds on the same device.
`moe_grouped_gemm` launches B4 for CUDA tensors, with a grid fixed by the
row count alone (`tiles`), so nothing is read back and a CUDA graph
captures the launch; it runs `torch_grouped_gemm` for CPU tensors.  Rows at
or past ``offsets[E]`` hold no assignment: B4 leaves them unwritten, the
plain version zero.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows of a tile (``BM`` in the source)
TILE_ROWS = 64
MAX_EXPERTS = 512


def tiles(rows: int, n_exp: int) -> int:
    """The grid's row tiles for `rows` rows over `n_exp` experts: enough
    whatever the routing, since each expert's last tile is the only partial
    one."""
    return -(-rows // TILE_ROWS) + n_exp


def torch_grouped_gemm(a: torch.Tensor, b: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """The plain version: one product per expert with rows, its bounds read
    on the host; rows past the last bound are zero."""
    c = a.new_zeros((a.shape[0], b.shape[2]))
    bounds = offsets.tolist()
    for e in range(b.shape[0]):
        r0, r1 = bounds[e], bounds[e + 1]
        if r1 > r0:
            c[r0:r1] = torch.matmul(a[r0:r1], b[e].to(a.dtype))
    return c


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("moe_grouped_gemm").moe_grouped_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return fn


def moe_grouped_gemm(a: torch.Tensor, b: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """a (rows, K), b (E, K, N) in a's dtype, offsets (E + 1,) int32 ->
    c (rows, N) in a's dtype.  CUDA tensors go to B4 (bf16 on the tensor
    cores, f32 on the CUDA cores), CPU tensors to `torch_grouped_gemm`;
    under autograd it raises (B4 has no backward)."""
    _build.refuse_autograd("moe_grouped_gemm", a, b)
    if a.device.type == "cpu":
        return torch_grouped_gemm(a, b, offsets)
    rows, K = a.shape
    E, Kb, N = b.shape
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"moe_grouped_gemm: unsupported dtypes a {a.dtype} "
                        f"b {b.dtype}")
    if Kb != K or tuple(offsets.shape) != (E + 1,) or E > MAX_EXPERTS:
        raise ValueError(f"moe_grouped_gemm: unsupported shapes a {tuple(a.shape)}"
                         f" b {tuple(b.shape)} offsets {tuple(offsets.shape)}")
    if offsets.dtype != torch.int32 or not offsets.is_contiguous():
        raise TypeError("moe_grouped_gemm: offsets must be contiguous int32")
    for name, t in (("a", a), ("b", b), ("offsets", offsets)):
        if t.device != a.device:
            raise ValueError(f"moe_grouped_gemm: {name} is on {t.device}, "
                             f"a on {a.device}")
    if a.stride(1) != 1 or b.stride(2) != 1:
        raise ValueError("moe_grouped_gemm: a and b need a contiguous last dim")
    if a.dtype == torch.bfloat16 and (
            K % 8 or N % 8 or a.stride(0) % 8 or b.stride(0) % 8
            or b.stride(1) % 8 or a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("moe_grouped_gemm: bf16 needs K and N and the row "
                         "strides in multiples of 8 and 16-byte aligned bases "
                         "(16-byte cp.async chunks)")
    c = a.new_empty((rows, N))
    if rows == 0:
        return c
    err = _launcher()(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      offsets.data_ptr(), K, N, E, a.stride(0), b.stride(0),
                      b.stride(1), c.stride(0), tiles(rows, E),
                      _DTYPES[a.dtype], _build.raw_stream(a.device))
    _build.check(err, "moe_grouped_gemm")
    _build.count_launch(moe_grouped_gemm)
    return c


#: launches of the CUDA kernel since the count was last set to 0
moe_grouped_gemm.launches = 0
