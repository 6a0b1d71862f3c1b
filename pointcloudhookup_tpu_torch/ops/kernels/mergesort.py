"""Two-level merge sort of (hi, lo) int32 pairs for the fused front-end's
``sort_mode="merge"``.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/mergesort.py::
merge_sort_2key`` (and a copy of its ``merge_sort_eligible``).  Each pair
packs into one int64 key, hi * 2**32 + (lo + 2**31), whose order is the
pair's lexicographic order for every int32 pair.  On a CUDA tensor the
blocked first phase is ``torch.sort`` of the [N / block, block] view (the
reference's ``lax.sort`` outside any kernel), and the log2(N / block)
merge-path rounds are the kernel of ``csrc/mergesort.cu``.  The plain
PyTorch version is one ``torch.sort`` of the packed keys: the output is the
same (a pair is the whole record), and it is what CPU tensors take and what
the kernel is held against on the card.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build

launches = 0  # merge_rounds calls that ran the kernel (read and reset by chip_smoke.py)

MAX_BLOCK = 8192  # the kernel's output tile: 2 * block int64 keys in shared memory


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
    [32, 8192] (the kernel's tile)."""
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
    keys = pack(hi, lo).view(-1, block).sort(dim=1).values.reshape(-1)
    return unpack(merge_rounds(keys, torch.empty_like(keys), block))


def merge_rounds(keys, scratch, block: int):
    """The kernel alone: keys int64[N] sorted in blocks of ``block`` rows
    -> the sorted keys, in keys or in scratch (both are overwritten)."""
    global launches
    build.require_cuda("merge_rounds", keys, scratch)
    n = keys.shape[0]
    rc = build.library().pch_merge_rounds(
        keys.data_ptr(), scratch.data_ptr(), n, block, build.stream(keys.device)
    )
    build.check(rc, "merge_sort_2key")
    launches += 1  # one call: log2(n / block) kernel launches, one per round
    rounds = (n // block).bit_length() - 1
    return scratch if rounds % 2 else keys


def merge_sort_2key_plain(hi, lo):
    """Plain PyTorch version: one sort of the packed keys."""
    return unpack(torch.sort(pack(hi, lo)).values)
