"""Window sort of the within-cell code for the fused front-end's
hierarchical sort.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/winsort.py::
window_sort_w``.  The CUDA kernel is ``csrc/winsort.cu``; the plain PyTorch
version below is the JAX package's own path off the TPU
(``ops/frontend_fused.py``'s ``sort_mode="hier"`` branch: pad, sort the
[-1, W] rows, sort again at offset W/2), and is what CPU tensors take and
what the kernel is held against on the card.  Unlike the TPU kernel (W 256,
N a multiple of 32768) the window is any even size from 2 up, as in the
reference's path off the TPU, and N is free.  Up to 4,096 rows a window one
launch runs both passes; a larger window sorts through a scratch buffer the
wrapper allocates (``csrc/winsort.cu``).
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace


PAD_K1 = 0xFFFFFFFF
PAD_W = 0x7FFF


def _check_window(window: int) -> None:
    # the reference's second pass reshapes [half:-half] into rows of W,
    # which needs an even W
    if window < 2 or window % 2:
        raise ValueError(f"window must be even and at least 2, got {window}")


def window_sort_w(k1, w, window: int = 256):
    """int32[N]: w re-ordered by (k1, w) within W-row windows at offsets 0
    and W/2 (the second pass sees the first's output), as if the arrays
    were padded to a multiple of W with (0xFFFFFFFF, 0x7FFF).  k1 int64[N]
    holds u32 keys and must be non-decreasing (it is invariant under the
    window sorts); w int32[N] holds 16-bit codes."""
    _check_window(window)
    if k1.device.type == "cpu":
        return window_sort_w_plain(k1, w, window)
    build.require_cuda("window_sort_w", k1, w)
    n = k1.shape[0]
    if k1.dtype != torch.int64 or k1.dim() != 1:
        raise ValueError("k1 must be a 1-D int64 tensor")
    if w.dtype != torch.int32 or w.shape != (n,):
        raise ValueError(f"w must be int32[{n}]")
    lib = build.library()
    out = torch.empty_like(w)
    scratch = torch.empty(lib.pch_winsort_scratch(n, window), dtype=torch.uint8,
                          device=k1.device)
    rc = lib.pch_winsort(
        k1.data_ptr(), w.data_ptr(), out.data_ptr(), n, window, scratch.data_ptr(),
        build.stream(k1.device),
    )
    build.check(rc, "window_sort_w")
    if n > 0:  # one launch for both passes, more above 4,096 rows a window
        trace.count("kernel.window_sort_w")
    return out


def packed_windows(k1, w, window: int):
    """The padded packed keys (k1 << 16) | w, int64[ceil(N / W) * W]."""
    n = k1.shape[0]
    key = ((k1 & 0xFFFFFFFF) << 16) | (w.to(torch.int64) & 0xFFFF)
    pad = (-n) % window
    if pad:
        key = torch.cat([key, torch.full((pad,), (PAD_K1 << 16) | PAD_W,
                                         dtype=torch.int64, device=key.device)])
    return key


def window_sort_w_plain(k1, w, window: int = 256):
    """Plain PyTorch version: same contract."""
    _check_window(window)
    n = k1.shape[0]
    key = packed_windows(k1, w, window)
    key = key.view(-1, window).sort(dim=1).values.view(-1)
    if key.shape[0] > window:
        half = window // 2
        mid = key[half:-half].view(-1, window).sort(dim=1).values.view(-1)
        key = torch.cat([key[:half], mid, key[-half:]])
    return (key[:n] & 0xFFFF).to(torch.int32)
