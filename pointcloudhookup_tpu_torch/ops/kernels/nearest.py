"""ICP's nearest-neighbour sweep: the frame rows moved by (R, t), then each
moved row's nearest valid destination row.

No TPU kernel counterpart: the JAX module's ``_nearest`` is plain jnp.  The
CUDA kernel is ``csrc/nearest.cu`` (a memset, the sweep, a finishing pass);
the plain PyTorch version is ``_moved``, ``_nearest`` and ``_gather_rows``
below, what CPU tensors take and what the kernel is held to, bit for bit,
on the card.  The kernel builds no [B, rows, M] tensor.

The search departs from the JAX module's |a|^2 + |b|^2 - 2 a.b: it takes
d^2 = |a - b|^2 directly (differences, a square and two fused
multiply-adds), then the argmin.  At a tower's reach (|b|^2 up to ~500
m^2) the expanded form rounds d^2 by ~3e-5 m^2, more than the gap between
the two nearest member rows of many frame rows; the swaps that follow sent
6 of 100 towers' refinements off the float64 ICP, one by 0.43 m, on an
H100 (50-tower sections of ~12,400-row towers).  The direct form rounds
d^2 by a few ulp of d^2 itself: about 0.3 % of towers part, by 2-106 mm
(90 sections), moved by the float32 rounding of the moved rows alone.
``tests/test_torch_registration.py::test_nearest_matches_jax`` holds the
index to the JAX module's and d^2 to the exact value.  The moved rows are
rounded as XLA:CPU rounds the JAX module's (``_dot3``: fused
multiply-adds).

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
from pointcloudhookup_tpu_torch.ops.morton import fma_f32
from pointcloudhookup_tpu_torch.utils import trace

_ROWS = (2, 3, 4)  # frame rows a thread holds: the kernel's instantiations
_BLOCK_WARPS = 8
_WARPS_PER_SM = 32  # resident warps aimed at on each SM
_MIN_SLICE_ROWS = 64  # the fewest destination rows a warp walks in its block's range
_MAX_SPLIT = 65535  # the grid's y extent
# the largest [B, rows, M] d^2 tile the plain version builds: 2**25
# elements, 128 MiB in float32, which bounds its memory on the CPU, where it
# runs (at most three such tensors are alive at once)
NEAREST_TILE_ELEMS = 1 << 25


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
    adds one to the counter ``icp.nearest_kernel``; a call with no frame
    rows launches nothing."""
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
    trace.count("icp.nearest_kernel")
    return idx, d2, matched


def nearest_moved_plain(src, src_mask, dst, dst_mask, r, t):
    """Plain PyTorch version: same contract."""
    idx, d2 = _nearest(_moved(src, r, t), src_mask, dst, dst_mask)
    return idx, d2, _gather_rows(dst, idx)


def _dot3(a, b):
    """Three-term float32 dot a0 b0 + a1 b1 + a2 b2 of broadcastable
    tensors, rounded as XLA:CPU computes the JAX module's squared norms and
    its Eigen dot: fma(a2, b2, fma(a1, b1, a0 b0))."""
    return fma_f32(a[2], b[2], fma_f32(a[1], b[1], a[0] * b[0]))


def _cols(x):
    return [x[..., j] for j in range(3)]


def _moved(src, r, t):
    """src @ R^T (Eigen's fused dot), then + t: src float32[B, N, 3], r
    float32[B, 3, 3], t float32[B, 3]."""
    s = [c[..., None] for c in _cols(src)]  # [B, N, 1] each
    return _dot3(s, [r[:, None, :, j] for j in range(3)]) + t[:, None, :]


def _nearest(src, src_mask, dst, dst_mask):
    """For each source row, the index and squared distance of its nearest
    valid destination row.

    src float32[B, N, 3] / src_mask bool[B, N], dst float32[B, M, 3] /
    dst_mask bool[B, M].  d^2 = |a - b|^2, summed over the axes with fused
    multiply-adds; masked destinations are +inf, and masked sources report
    +inf (their index is still the argmin over the valid destinations).
    Rows go in the fewest tiles that keep a [B, rows, M] tile within
    NEAREST_TILE_ELEMS, split evenly: a tile's bytes then follow M smoothly,
    where the most rows a tile holds jumps by a whole row of [B, M] as M
    crosses a multiple (the peak memory of ICP batches whose largest cloud
    differs by a few rows moved 1.4 %)."""
    b, n, _ = src.shape
    m = dst.shape[1]
    most = max(1, NEAREST_TILE_ELEMS // max(b * m, 1))
    tiles = max(1, -(-n // most))
    tile_rows = max(1, -(-n // tiles))
    dmask = dst_mask[:, None, :]
    d = [c[:, None, :] for c in _cols(dst)]  # [B, 1, M] each
    idx = torch.empty((b, n), dtype=torch.int64, device=src.device)
    best = torch.empty((b, n), dtype=src.dtype, device=src.device)
    for r0 in range(0, n, tile_rows):
        s = [c[..., None] for c in _cols(src[:, r0:r0 + tile_rows])]  # [B, rows, 1]
        e = s[0] - d[0]
        d2 = e * e
        for j in (1, 2):
            e = s[j] - d[j]
            d2 = fma_f32(e, e, d2)
        d2 = torch.where(dmask, d2, torch.inf)
        i = torch.argmin(d2, dim=-1)
        idx[:, r0:r0 + tile_rows] = i
        best[:, r0:r0 + tile_rows] = torch.gather(d2, -1, i[..., None])[..., 0]
    return idx, torch.where(src_mask, best, torch.inf)


def _gather_rows(x, idx):
    """x[b, idx[b, n]] for x [B, M, 3], idx [B, N]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
