"""Build and load the port's hand-written CUDA kernels.

Every ``.cu`` source under ``pointcloudhookup_tpu_torch/csrc/`` compiles
with its own ``nvcc`` process, all started together, and one more ``nvcc``
links the objects into a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).
The library lands in ``<repo>/build/torch_kernels/<digest>/`` where the
digest covers the sources and the flags, so an edited kernel is rebuilt
and an unchanged one is loaded as is.  The build runs at the first kernel
launch of a process, never at import: the CPU test suite imports every
module and has no ``nvcc``.

Flags: ``sm_90a`` (Hopper), ``-O3`` and ``--fmad=false`` -- the JAX
reference rounds every product and sum separately, and a contracted
multiply-add could flip a borderline ``d2 <= eps2`` decision.  Never
``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-Xcompiler", "-fPIC",
)
_LIB_NAME = "libpch_kernels.so"

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float

# C entry points: name -> (restype, argtypes)
_SIGNATURES = {
    "pch_error_string": (ctypes.c_char_p, [_I32]),
    "pch_max_channels": (_I32, []),
    "pch_compact_rows_scratch": (_I64, [_I64]),
    "pch_compact_rows": (_I32, [_P, _I64, _P, _P, _I32, _P, _I64, _P, _P]),
    "pch_segscan_max_cols": (_I32, []),
    "pch_segscan_scratch": (_I64, [_I64, _I32]),
    "pch_segscan": (_I32, [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P, _P]),
    "pch_neighbor_scratch": (_I64, [_I64]),
    "pch_neighbor_reduce": (
        _I32, [_P, _P, _P, _P, _I64, _P, _I32, _I32, _P, _P, _P, _P]
    ),
    "pch_cluster_cells_scratch": (_I64, [_I64]),
    "pch_cluster_cells": (
        _I32, [_P, _P, _P, _P, _I64, _P, _F32, _P, _P, _P, _P]
    ),
    "pch_obb_accumulate_xyz": (
        _I32, [_P, _P, _P, _P, _I64, _P, _P, _I32, _I32, _P, _P]
    ),
    "pch_obb_accumulate": (
        _I32, [_P, _P, _P, _I64, _P, _F32, _P, _P, _I32, _I32, _P, _P]
    ),
    "pch_compact_indices_scratch": (_I64, [_I64]),
    "pch_compact_indices": (_I32, [_P, _I64, _I32, _P, _P, _P]),
    "pch_dupwin": (_I32, [_P, _P, _I64, _I32, _P, _P]),
    "pch_winsort_scratch": (_I64, [_I64, _I32]),
    "pch_winsort": (_I32, [_P, _P, _P, _I64, _I32, _P, _P]),
    "pch_block_sort": (_I32, [_P, _P, _P, _I64, _I32, _P]),
    "pch_merge_rounds": (_I32, [_P, _P, _P, _P, _I64, _I32, _P]),
    "pch_nearest_sweep": (
        _I32, [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _I32,
               _P, _P, _P, _P, _P]
    ),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_ROOT, digest(), _LIB_NAME)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels cannot be built on this machine"
        )
    return found


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    return res


def build(verbose: bool = False) -> str:
    """Compile the library if this digest has none yet: one ``nvcc -c``
    per source, all at once, then one link.  Returns its path.  verbose
    adds ``-Xptxas -v`` and prints the compiler's report."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    objs, cmds = [], []
    for src in (p for p in sources() if p.endswith(".cu")):
        obj = os.path.join(os.path.dirname(out), f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, *extra, "-c", "-o", obj, src])
    tmp = f"{out}.{tag}"
    try:
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            results = list(pool.map(_run, cmds))
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    if verbose:
        for res in results:
            print(res.stdout + res.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(path)
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().pch_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream(device) -> int:
    """The current CUDA stream of ``device`` as a raw pointer (PyTorch's own
    fast query, without building a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def f32_scalar(value, device) -> torch.Tensor:
    """value (a number, or a one-element tensor on the CPU or on ``device``)
    as float32[1] on ``device``, with no host round trip: a tensor already
    on the card is converted there, a number is filled in by a kernel."""
    if isinstance(value, torch.Tensor):
        if value.numel() != 1:
            raise ValueError("expected a scalar")
        if value.device == device:
            return value.to(torch.float32).reshape(1)
        if value.device.type != "cpu":
            raise ValueError(f"scalar on {value.device}, inputs on {device}")
        value = float(value)
    return torch.full((1,), float(value), dtype=torch.float32, device=device)


def require_cuda(name: str, *tensors) -> None:
    """Every tensor must be a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
