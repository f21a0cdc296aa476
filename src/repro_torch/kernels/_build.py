"""Build and load the hand-written CUDA kernels in ``csrc/``.

Route: ``nvcc`` compiles each ``csrc/<name>.cu`` into its own shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes).  Builds happen at first CUDA use, never at
import: importing this module needs neither ``nvcc`` nor a GPU.  All sources
are compiled together, one ``nvcc`` process each, started at once.

Libraries land in ``build/`` next to the package (listed in ``.gitignore``),
named by a hash of their source and flags, so an edited kernel is never served
from a stale library.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("flash_attention", "flash_decode", "ssd_scan", "ssd_scan_tc",
           "moe_grouped_gemm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_libs: Dict[str, ctypes.CDLL] = {}
#: serialises first loads and launch counts: the ranks of a mesh launch
#: kernels from threads of their own (`sp.common.lockstep`)
_lock = threading.Lock()
#: compiler output of the last build of each source (ptxas register/smem use)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(looked on PATH and in /usr/local/cuda/bin)")
    return exe


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source not yet built, all in parallel; returns the
    wall seconds spent.  Raises RuntimeError naming the failed source."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs: List = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)          # atomic: concurrent builders never see a partial file
    dt = time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return dt


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def count_launch(wrapper, n: int = 1) -> None:
    """Add `n` to ``wrapper.launches``, whichever thread launched (a graph's
    replay adds the launches it holds; its capture takes them off again)."""
    with _lock:
        wrapper.launches += n


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, for a launcher's
    ``stream`` argument (the raw query: no ``torch.cuda.Stream`` object is
    built on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index or 0)


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when autograd would record through a hand kernel: the kernels
    write fresh outputs and record no backward (the reference's Pallas
    kernels have none either), so a gradient through them would be cut
    silently.  Checked before the device dispatch, so the CPU path refuses
    what the card would."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the hand CUDA kernels have no backward pass (nor do "
            "the reference's Pallas kernels); differentiate through the "
            "plain PyTorch version with impl=\"torch\"")


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
