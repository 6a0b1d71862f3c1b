"""Exact masked percentiles.

Counterpart of ``pointcloudhookup_tpu/ops/percentile.py``: the sort-based
``masked_percentile`` (the fast path's strided-sample base) and the
sort-free ``masked_percentile_bisect`` with its helpers (the exact path).
The order-preserving uint32 view of float32 is held in int64.  Every
scalar stays a float32 tensor, so the final lerp rounds exactly as the
reference's does.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.morton import fma_f32

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


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


def _order_statistic_bits(ubits, mask, rank):
    """Bit pattern of the (rank+1)-th smallest masked element: the largest
    a with count(ubits < a) <= rank, built greedily from the MSB in 32
    masked count passes (no sort, no host sync)."""
    ans = torch.zeros((), dtype=torch.int64, device=ubits.device)
    rank = rank.to(torch.int64)
    for b in range(32):
        trial = ans | (1 << (31 - b))
        cnt = (mask & (ubits < trial)).sum()
        ans = torch.where(cnt <= rank, trial, ans)
    return ans


def masked_percentile_bisect(x, mask, q):
    """Exact percentile of x[mask] with numpy's 'linear' interpolation,
    without a sort: the two order statistics come from radix bisection.
    x float32[N], mask bool[N], q in [0, 100]; at least one valid
    element.  Returns a 0-d float32 tensor."""
    f32 = torch.float32
    n = mask.sum(dtype=torch.int32)
    h = (n - 1).to(f32) * (torch.tensor(q, dtype=f32) / 100.0)
    lo = torch.clamp(torch.floor(h).to(torch.int32), min=0)
    lo = torch.minimum(lo, n - 1)
    hi = torch.minimum(torch.clamp(lo + 1, min=0), n - 1)
    frac = h - lo.to(f32)

    u = _f32_ordered_bits(x)
    v_lo = _order_statistic_bits(u, mask, lo)
    # (hi+1)-th smallest: v_lo itself if it still covers rank hi, else the
    # smallest masked value strictly above it
    above = mask & (u > v_lo)
    cnt_le = (mask & (u <= v_lo)).sum()
    nxt = torch.where(above, u, torch.full_like(u, _U32)).min()
    v_hi = torch.where(cnt_le >= hi.to(torch.int64) + 1, v_lo, nxt)
    x_lo = _f32_from_ordered_bits(v_lo)
    x_hi = _f32_from_ordered_bits(v_hi)
    return x_lo * (1.0 - frac) + x_hi * frac
