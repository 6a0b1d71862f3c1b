"""Masked percentiles.

Counterpart of ``pointcloudhookup_tpu/ops/percentile.py``: the sort-based
``masked_percentile`` (the fast path's strided-sample base), the sort-free
``masked_percentile_bisect`` with its helpers (the exact path), and the
histogram percentile (``histogram_counts``, ``percentile_from_histogram``,
``histogram_percentile``) whose counts the sharded step sums over ranks.
The order-preserving uint32 view of float32 is held in int64.  Every
scalar stays a float32 tensor, so each result rounds exactly as the
reference's does under ``jit``.

``group`` (the JAX functions' ``axis_name``) is a
``parallel.sharded.Group`` of ranks: the counts are summed and the
minimum taken over every rank's masked elements, so the percentile is the
one of their union, the same on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloudhookup_tpu_torch.ops.morton import fma_f32

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000
_BIG = 3.0e38


def masked_percentile(x, mask, q):
    """Exact percentile of x[mask] with numpy's 'linear' interpolation:
    masked entries sort to the end as +inf.  x float32[N], mask bool[N],
    q in [0, 100]; at least one valid element.  Returns a 0-d float32
    tensor.

    The lerp ``a * (1 - frac) + b * frac`` rounds ``b * frac`` and the
    sum once, as XLA:CPU compiles the JAX function under ``jit`` (a fused
    multiply-add; through float64, exact unless the float64 sum itself
    rounds onto a float32 midpoint)."""
    f32 = torch.float32
    n = mask.sum(dtype=torch.int32)
    xs = torch.sort(torch.where(mask, x, torch.inf)).values
    h = (n - 1).to(f32) * (torch.tensor(q, dtype=f32) / 100.0)
    lo = torch.clamp(torch.floor(h).to(torch.int32), min=0)
    lo = torch.minimum(lo, n - 1)
    hi = torch.minimum(torch.clamp(lo + 1, min=0), n - 1)
    frac = h - lo.to(f32)
    return fma_f32(xs[hi], frac, xs[lo] * (1.0 - frac))


def _f32_ordered_bits(x):
    """Order-preserving unsigned 32-bit view of float32 (as int64):
    u(a) < u(b) iff a < b, with -0.0 before +0.0."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & _U32
    return torch.where((b >> 31) == 1, b ^ _U32, b ^ _SIGN)


def _f32_from_ordered_bits(u):
    """Inverse of _f32_ordered_bits."""
    b = torch.where((u >> 31) == 1, u ^ _SIGN, (~u) & _U32)
    b = torch.where(b >= _SIGN, b - (1 << 32), b)  # two's complement int32
    return b.to(torch.int32).view(torch.float32)


def _order_statistic_bits(ubits, mask, rank, group=None):
    """Bit pattern of the (rank+1)-th smallest masked element: the largest
    a with count(ubits < a) <= rank, built greedily from the MSB in 32
    masked count passes (no sort, no host sync).  With ``group`` each
    count is summed over the ranks (32 all-reduces)."""
    ans = torch.zeros((), dtype=torch.int64, device=ubits.device)
    rank = rank.to(torch.int64)
    for b in range(32):
        trial = ans | (1 << (31 - b))
        cnt = (mask & (ubits < trial)).sum()
        if group is not None:
            cnt = group.all_reduce(cnt, "sum")
        ans = torch.where(cnt <= rank, trial, ans)
    return ans


def masked_percentile_bisect(x, mask, q, group=None):
    """Exact percentile of x[mask] with numpy's 'linear' interpolation,
    without a sort: the two order statistics come from radix bisection.
    x float32[N], mask bool[N], q in [0, 100]; at least one valid
    element (over the group's ranks).  Returns a 0-d float32 tensor.
    ``group``: the percentile of the union of the ranks' masked elements
    (35 all-reduces: n, the 32 bisection counts, cnt_le, and nxt's
    minimum)."""
    f32 = torch.float32
    n = mask.sum(dtype=torch.int32)
    if group is not None:
        n = group.all_reduce(n, "sum")
    h = (n - 1).to(f32) * (torch.tensor(q, dtype=f32) / 100.0)
    lo = torch.clamp(torch.floor(h).to(torch.int32), min=0)
    lo = torch.minimum(lo, n - 1)
    hi = torch.minimum(torch.clamp(lo + 1, min=0), n - 1)
    frac = h - lo.to(f32)

    u = _f32_ordered_bits(x)
    v_lo = _order_statistic_bits(u, mask, lo, group)
    # (hi+1)-th smallest: v_lo itself if it still covers rank hi, else the
    # smallest masked value strictly above it
    above = mask & (u > v_lo)
    cnt_le = (mask & (u <= v_lo)).sum()
    nxt = torch.where(above, u, torch.full_like(u, _U32)).min()
    if group is not None:
        cnt_le = group.all_reduce(cnt_le, "sum")
        nxt = group.all_reduce(nxt, "min")
    v_hi = torch.where(cnt_le >= hi.to(torch.int64) + 1, v_lo, nxt)
    x_lo = _f32_from_ordered_bits(v_lo)
    x_hi = _f32_from_ordered_bits(v_hi)
    return x_lo * (1.0 - frac) + x_hi * frac


def _f32_full(value, device):
    """A 0-d float32 tensor on ``device``, filled by a kernel (no copy from
    the host)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _reciprocal(num_bins: int, device):
    """float32 1 / num_bins: XLA:CPU multiplies by it where the reference
    divides by the constant num_bins (exact for a power of two)."""
    return _f32_full(np.float32(1.0) / np.float32(num_bins), device)


def histogram_counts(x, mask, lo, hi, num_bins: int):
    """int32[num_bins] histogram of x[mask] over [lo, hi] (0-d float32
    tensors); values are clipped into range and the top edge owns
    everything at hi.  The per-rank part of the sharded percentile: the
    ranks' counts are summed.  Sort, then one binary search an edge; the
    edges ``lo + (hi - lo) * j / num_bins`` round as XLA:CPU compiles
    them, ``fma((hi - lo) * j, 1 / num_bins, lo)``."""
    f32 = torch.float32
    xs = torch.sort(torch.where(mask, torch.clamp(x, lo, hi), torch.inf)).values
    n = mask.sum(dtype=torch.int32)
    ar = torch.arange(1, num_bins + 1, dtype=f32, device=x.device)
    edges = fma_f32((hi - lo) * ar, _reciprocal(num_bins, x.device), lo.expand(num_bins))
    cdf = torch.searchsorted(xs, edges, right=True).to(torch.int32)
    cdf = torch.minimum(cdf, n)  # padding (+inf) never counts
    cdf[-1:] = n
    return torch.diff(cdf, prepend=torch.zeros(1, dtype=torch.int32, device=x.device))


def percentile_from_histogram(counts, lo, hi, q):
    """Approximate percentile from histogram counts over [lo, hi]: the
    selected bin's left edge plus the rank fraction inside it.  Rounded as
    XLA:CPU compiles the reference under ``jit`` with a constant q: the
    rank fraction's numerator ``(total - 1) * (q / 100) - prev`` and the
    result ``lo + (bin + frac) * width`` are fused multiply-adds, width is
    ``(hi - lo) * (1 / num_bins)``."""
    f32 = torch.float32
    dev = counts.device
    num_bins = counts.shape[0]
    total1 = (counts.sum() - 1).to(f32)
    q100 = _f32_full(np.float32(q) / np.float32(100.0), dev)
    target = total1 * q100
    cum = torch.cumsum(counts, 0)
    bin_idx = torch.searchsorted(cum.to(f32), target.reshape(1), right=True)[0]
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)
    prev_cum = torch.where(bin_idx > 0, cum[torch.clamp(bin_idx - 1, min=0)], 0)
    in_bin = torch.clamp(counts[bin_idx], min=1)
    frac = fma_f32(total1, q100, -prev_cum.to(f32)) / in_bin.to(f32)
    width = (hi - lo) * _reciprocal(num_bins, dev)
    return fma_f32(bin_idx.to(f32) + torch.clamp(frac, 0.0, 1.0), width, lo)


def histogram_percentile(x, mask, q, num_bins: int = 4096):
    """Approximate percentile of x[mask] on one device (histogram
    method); at least one valid element."""
    lo = torch.where(mask, x, _BIG).min()
    hi = torch.where(mask, x, -_BIG).max()
    counts = histogram_counts(x, mask, lo, hi, num_bins)
    return percentile_from_histogram(counts, lo, hi, q)
