"""ICP's nearest-neighbour sweep: the frame rows moved by (R, t), then each
moved row's nearest valid destination row.

No TPU kernel counterpart: the JAX module's ``_nearest`` is plain jnp.  The
CUDA kernel is ``csrc/nearest.cu`` (a memset, the sweep, a finishing pass);
the plain PyTorch version is ``ops/registration.py``'s ``_moved`` and
``_nearest`` unchanged, what CPU tensors take and what the kernel is held
to, bit for bit, on the card.  The kernel builds no [B, rows, M] tensor.

How the kernel spreads the work follows B, N and M alone (``plan``): a
thread holds 2, 3 or 4 frame rows, a warp 32 times that, a block up to
eight warps over one tower's frame tiles and slices of its destination
rows, and enough blocks split each tower's destination rows to keep
``_WARPS_PER_SM`` warps on each SM.
"""

from __future__ import annotations

import functools

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace

_ROWS = (2, 3, 4)  # frame rows a thread holds: the kernel's instantiations
_BLOCK_WARPS = 8
_WARPS_PER_SM = 32  # resident warps aimed at on each SM
_MIN_SLICE_ROWS = 64  # the fewest destination rows a warp walks in its block's range
_MAX_SPLIT = 65535  # the grid's y extent

launches = 0  # calls that launched the kernel


def plan(b: int, n: int, m: int, sms: int) -> tuple[int, int, int, int]:
    """(rows a thread, frame tiles a block, destination slices a block,
    destination ranges a tower) for B towers of N frame rows and M
    destination rows on a card of ``sms`` SMs.  Rows: the fewest padded
    frame rows, then the most a thread; a block holds up to eight warps, its
    tower's tiles first; the ranges add blocks until the card holds
    ``_WARPS_PER_SM`` warps an SM, while each warp keeps at least
    ``_MIN_SLICE_ROWS`` destination rows of its range."""
    rows = min(_ROWS, key=lambda r: (-(-n // (32 * r)) * 32 * r, -r))
    tiles = -(-n // (32 * rows))
    wt = min(tiles, _BLOCK_WARPS)
    wm = _BLOCK_WARPS // wt
    warps = b * -(-tiles // wt) * wt * wm
    split = min(-(-sms * _WARPS_PER_SM // warps), -(-m // (wm * _MIN_SLICE_ROWS)), _MAX_SPLIT)
    return rows, wt, wm, max(split, 1)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def nearest_moved(src, src_mask, dst, dst_mask, r, t):
    """(idx int64[B, N], d2 float32[B, N], matched float32[B, N, 3]): for
    each frame row src[b, i] moved by r[b] and t[b], the index of its
    nearest valid row of dst[b], the squared distance to it (+inf where
    src_mask is False) and that row, as ``_nearest`` and ``_gather_rows``
    give them on the moved rows.

    src float32[B, N, 3] / src_mask bool[B, N], dst float32[B, M, 3] /
    dst_mask bool[B, M], r float32[B, 3, 3], t float32[B, 3].  Each launch
    adds one to ``launches`` and to the counter ``icp.nearest_kernel``; a
    call with no frame rows launches nothing."""
    if src.device.type == "cpu":
        return nearest_moved_plain(src, src_mask, dst, dst_mask, r, t)
    build.require_cuda("nearest_moved", src, src_mask, dst, dst_mask, r, t)
    b, n = src.shape[:2]
    m = dst.shape[1]
    if src.dtype != torch.float32 or src.shape != (b, n, 3):
        raise ValueError("src must be float32[B, N, 3]")
    if src_mask.dtype != torch.bool or src_mask.shape != (b, n):
        raise ValueError("src_mask must be bool[B, N]")
    if dst.dtype != torch.float32 or dst.shape != (b, m, 3):
        raise ValueError("dst must be float32[B, M, 3]")
    if dst_mask.dtype != torch.bool or dst_mask.shape != (b, m):
        raise ValueError("dst_mask must be bool[B, M]")
    if r.dtype != torch.float32 or r.shape != (b, 3, 3):
        raise ValueError("r must be float32[B, 3, 3]")
    if t.dtype != torch.float32 or t.shape != (b, 3):
        raise ValueError("t must be float32[B, 3]")
    dev = src.device
    idx = torch.empty((b, n), dtype=torch.int64, device=dev)
    d2 = torch.empty((b, n), dtype=torch.float32, device=dev)
    matched = torch.empty((b, n, 3), dtype=torch.float32, device=dev)
    if b * n == 0:
        return idx, d2, matched
    if m == 0:
        raise ValueError("dst has no rows")
    rows, wt, wm, split = plan(b, n, m, _sms(dev.index))
    keys = torch.empty((b, n), dtype=torch.int64, device=dev)
    lib = build.library()
    rc = lib.pch_nearest_sweep(
        src.data_ptr(), src_mask.data_ptr(), dst.data_ptr(), dst_mask.data_ptr(),
        r.data_ptr(), t.data_ptr(), b, n, m, rows, wt, wm, split, keys.data_ptr(),
        idx.data_ptr(), d2.data_ptr(), matched.data_ptr(), build.stream(dev),
    )
    build.check(rc, "nearest_moved")
    global launches
    launches += 1
    trace.count("icp.nearest_kernel")
    return idx, d2, matched


def nearest_moved_plain(src, src_mask, dst, dst_mask, r, t):
    """Plain PyTorch version: same contract."""
    from pointcloudhookup_tpu_torch.ops import registration

    idx, d2 = registration._nearest(registration._moved(src, r, t), src_mask, dst, dst_mask)
    return idx, d2, registration._gather_rows(dst, idx)
