"""Windowed first-occurrence flags for the fused front-end's cell sort.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/dupwin.py::
first_occurrence_flags``.  The CUDA kernel is ``csrc/dupwin.cu``; the plain
PyTorch version below is the JAX package's own path off the TPU (the rolled
compare chain of ``ops/frontend_fused.py::_dup_window_flags``), and is what
CPU tensors take and what the kernel is held against on the card.  Unlike
the TPU kernel there is no rule that N be a multiple of 32768 and no
``depth < 128`` cap.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace


def first_occurrence_flags(k1, w, depth: int):
    """bool[N]: True where no row j in [i - depth, i) has k1[j] == k1[i]
    and w[j] == w[i].  Exact first-occurrence flags wherever every run of
    equal k1 is at most depth + 1 rows long.  k1 int64[N] (u32 keys),
    w int32[N], depth >= 1."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if k1.device.type == "cpu":
        return first_occurrence_flags_plain(k1, w, depth)
    build.require_cuda("first_occurrence_flags", k1, w)
    n = k1.shape[0]
    if k1.dtype != torch.int64 or k1.dim() != 1:
        raise ValueError("k1 must be a 1-D int64 tensor")
    if w.dtype != torch.int32 or w.shape != (n,):
        raise ValueError(f"w must be int32[{n}]")
    if depth >= 2**31:
        raise ValueError("depth must be below 2**31")
    lib = build.library()
    out = torch.empty(n, dtype=torch.bool, device=k1.device)
    rc = lib.pch_dupwin(
        k1.data_ptr(), w.data_ptr(), n, depth, out.data_ptr(), build.stream(k1.device)
    )
    build.check(rc, "first_occurrence_flags")
    if n > 0:
        trace.count("kernel.first_occurrence_flags")
    return out


def first_occurrence_flags_plain(k1, w, depth: int):
    """Plain PyTorch version: same contract."""
    n = k1.shape[0]
    pos = torch.arange(n, device=k1.device)
    dup = torch.zeros(n, dtype=torch.bool, device=k1.device)
    for d in range(1, depth + 1):
        dup |= (torch.roll(k1, d) == k1) & (torch.roll(w, d) == w) & (pos >= d)
    return ~dup
