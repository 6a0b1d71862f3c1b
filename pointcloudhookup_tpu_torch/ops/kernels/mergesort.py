"""Two-level merge sort of (hi, lo) int32 pairs for the fused front-end's
``sort_mode="merge"``.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/mergesort.py::
merge_sort_2key`` (and a copy of its ``merge_sort_eligible``).  Each pair
packs into one int64 key, hi * 2**32 + (lo + 2**31), whose order is the
pair's lexicographic order for every int32 pair.  On a CUDA tensor two
kernels of ``csrc/mergesort.cu`` run: the block sort (reads the pairs,
packs them and sorts each block of ``block`` rows) and the log2(N / block)
merge-path rounds (the last one unpacks into the int32 outputs).  The plain
PyTorch version is one ``torch.sort`` of the packed keys: the output is the
same (a pair is the whole record), and it is what CPU tensors take and what
the kernels are held against on the card.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace


MAX_BLOCK = 8192  # the block sort's tile: one CUDA block sorts 8,192 keys


def merge_sort_eligible(n: int, block: int = 8192) -> bool:
    """True when merge_sort_2key supports length n (a power of two, at
    least two blocks)."""
    return n >= 2 * block and (n & (n - 1)) == 0


def pack(hi, lo):
    """int64 keys ordered as the (hi, lo) pairs are, lexicographically."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def unpack(key):
    return (key >> 32).to(torch.int32), ((key & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def merge_sort_2key(hi, lo, *, block: int = 8192):
    """(hi, lo) int32[N] sorted lexicographically; N must satisfy
    merge_sort_eligible(N, block), and block is a power of two in
    [32, 8192]."""
    n = hi.shape[0]
    if not merge_sort_eligible(n, block):
        raise ValueError(f"merge_sort_2key needs a power-of-two N >= 2 * block "
                         f"(N={n}, block={block})")
    if block & (block - 1) or not 32 <= block <= MAX_BLOCK:
        raise ValueError(f"block must be a power of two in [32, {MAX_BLOCK}], got {block}")
    if hi.device.type == "cpu":
        return merge_sort_2key_plain(hi, lo)
    build.require_cuda("merge_sort_2key", hi, lo)
    if hi.dtype != torch.int32 or lo.dtype != torch.int32 or lo.shape != (n,):
        raise ValueError(f"hi and lo must be int32[{n}]")
    # the block sort reads 16 bytes at a time: a view off that alignment is copied
    hi, lo = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (hi, lo))
    keys = torch.empty((2, n), dtype=torch.int64, device=hi.device)  # keys, scratch
    out = torch.empty((2, n), dtype=torch.int32, device=hi.device)
    lib = build.library()
    stream = build.stream(hi.device)
    kp, op = keys.data_ptr(), out.data_ptr()
    build.check(lib.pch_block_sort(hi.data_ptr(), lo.data_ptr(), kp, n, block, stream),
                "merge_sort_2key")
    build.check(lib.pch_merge_rounds(kp, kp + 8 * n, op, op + 4 * n, n, block, stream),
                "merge_sort_2key")
    trace.count("kernel.merge_sort_2key")
    return out[0], out[1]


def merge_sort_2key_plain(hi, lo):
    """Plain PyTorch version: one sort of the packed keys."""
    return unpack(torch.sort(pack(hi, lo)).values)
