"""Positions of the first m set entries of a bool[N] array.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/compactidx.py::
compact_indices``.  The CUDA kernel is ``csrc/compactidx.cu``; the plain
PyTorch version below is what CPU tensors take and what the kernel is held
against on the card.  The kernel reads the flags once, in one launch (and a
memset); m = 0 launches nothing.  Unlike the TPU kernel there is no rule
that N be a multiple of 32768.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build

launches = 0  # kernel launches in this process (read and reset by chip_smoke.py)


def compact_indices(flag, m: int):
    """int32[m]: ascending positions of the first m True entries of
    flag bool[N]; slots past the number of True entries hold N - 1."""
    if flag.device.type == "cpu":
        return compact_indices_plain(flag, m)
    global launches
    build.require_cuda("compact_indices", flag)
    n = flag.shape[0]
    if flag.dtype != torch.bool or flag.dim() != 1 or not 0 < n < 2**31:
        raise ValueError("flag must be a 1-D bool tensor of 1 to 2**31 - 1 rows")
    lib = build.library()
    out = torch.empty(m, dtype=torch.int32, device=flag.device)
    scratch = torch.empty(
        lib.pch_compact_indices_scratch(n), dtype=torch.int32, device=flag.device
    )
    rc = lib.pch_compact_indices(
        flag.data_ptr(), n, m, out.data_ptr(), scratch.data_ptr(),
        build.stream(flag.device),
    )
    build.check(rc, "compact_indices")
    if m > 0:
        launches += 1
    return out


def compact_indices_plain(flag, m: int):
    """Plain PyTorch version: same contract."""
    n = flag.shape[0]
    idx = torch.nonzero(flag).squeeze(1)[:m].to(torch.int32)
    out = torch.full((m,), n - 1, dtype=torch.int32, device=flag.device)
    out[: idx.shape[0]] = idx
    return out
