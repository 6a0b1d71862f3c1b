"""Batched rigid registration: weighted Kabsch and point-to-point ICP.

Counterpart of ``pointcloudhookup_tpu/ops/registration.py``.  The JAX
module writes one pair and vmaps it; here every function takes a batch
[B, N, 3] from the start (a single pair is a batch of one).  Clouds are
padded to fixed N and M with validity masks, and padding enters the
solve as the JAX module's does: a padded source row keeps weight 1e-9 in
Kabsch and the index of the real destination row nearest its position.

The products are written out elementwise in float32 (no matmul), so no
TF32 path can touch them; Kabsch's moved rows are rounded as XLA:CPU rounds
the JAX module's (``_dot3``: fused multiply-adds, float32 on the card).
The nearest-neighbour search departs from the JAX module's |a|^2 + |b|^2 -
2 a.b: it takes d^2 = |a - b|^2 directly (differences, a square and two
fused multiply-adds), then the argmin.  At a tower's reach (|b|^2 up to
~500 m^2) the expanded form rounds d^2 by ~3e-5 m^2, more than the gap
between the two nearest member rows of many frame rows; the swaps that
follow sent 6 of 100 towers' refinements off the float64 ICP, one by
0.43 m, on an H100 (50-tower sections of ~12,400-row towers).  The direct
form rounds d^2 by a few ulp of d^2 itself: about 0.3 % of towers part,
by 2-106 mm (90 sections), moved by the float32 rounding of the moved rows
alone.  ``tests/test_torch_registration.py::test_nearest_matches_jax``
holds the index to the JAX module's and d^2 to the exact value.
A sweep (the frame rows moved by R and t, then each one's nearest valid
destination row) is ``ops/kernels/nearest.py::nearest_moved``: on the card
the hand-written kernel ``csrc/nearest.cu``, which builds no [B, rows, M]
tensor and gives ``_moved`` and ``_nearest``'s index and d^2 bit for bit;
on the CPU those two functions.  ``_nearest`` runs in tiles of source
rows, so no [B, rows, M] tensor holds more than ``NEAREST_TILE_ELEMS``
elements; each row's d^2 and argmin are those of the untiled form.  The
3x3 solve is ``torch.linalg.svd`` on the tensors' device.

Spans and counters (``utils/trace.py``): ``register_tower_pairs`` opens
``icp.pack`` round its padding, and ``solve_pairs`` ``icp.upload``,
``icp.solve`` and ``icp.fetch``; ``batched_icp`` counts ``icp.sweeps``, one
a nearest-neighbour sweep, and the kernel's wrapper ``icp.nearest_kernel``,
one a launch.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloudhookup_tpu_torch.ops.kernels import nearest
from pointcloudhookup_tpu_torch.ops.morton import fma_f32
from pointcloudhookup_tpu_torch.state import to_numpy
from pointcloudhookup_tpu_torch.utils import trace

# the largest [B, rows, M] d^2 tile _nearest builds: 2**25 elements, 128 MiB
# in float32; at most three such tensors are alive at once
NEAREST_TILE_ELEMS = 1 << 25


def _dot3(a, b):
    """Three-term float32 dot a0 b0 + a1 b1 + a2 b2 of broadcastable
    tensors, rounded as XLA:CPU computes the JAX module's squared norms and
    its Eigen dot: fma(a2, b2, fma(a1, b1, a0 b0))."""
    return fma_f32(a[2], b[2], fma_f32(a[1], b[1], a[0] * b[0]))


def _cols(x):
    return [x[..., j] for j in range(3)]


def kabsch(src, dst, weights):
    """Weighted rigid alignment src -> dst, batched.

    src, dst: float32[B, N, 3] corresponding points; weights: float32[B, N].
    Returns (R float32[B, 3, 3], t float32[B, 3]) minimising
    sum w |R src + t - dst|^2, with the reflection fixed by det(V U^T)."""
    w = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-12)
    mu_s = (src * w[..., None]).sum(dim=-2)
    mu_d = (dst * w[..., None]).sum(dim=-2)
    s = src - mu_s[..., None, :]
    d = dst - mu_d[..., None, :]
    h = ((s * w[..., None])[..., :, None] * d[..., None, :]).sum(dim=-3)  # [B, 3, 3]
    u, _, vt = torch.linalg.svd(h)
    v, ut = vt.mT, u.mT
    det = torch.linalg.det(v @ ut)
    flip = torch.ones(det.shape + (3,), dtype=src.dtype, device=src.device)
    flip[..., 2] = torch.sign(det)
    r = (v * flip[..., None, :]) @ ut
    t = mu_d - (r * mu_s[..., None, :]).sum(dim=-1)
    return r, t


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


def batched_icp(src, src_mask, dst, dst_mask, iters: int = 20,
                max_corr_dist: float = float("inf")):
    """Point-to-point ICP aligning each src onto its dst.

    src float32[B, N, 3] / mask, dst float32[B, M, 3] / mask.  ``iters``
    sweeps of nearest neighbours then weighted Kabsch from the identity;
    correspondences beyond max_corr_dist get weight 0 (every row keeps
    1e-9).  Returns dict(R [B, 3, 3], t [B, 3], rmse [B], inlier_frac [B])
    of tensors on src's device.  Config 4's kernel: a corridor's tower
    batch in one call."""
    b = src.shape[0]
    lim2 = torch.tensor(max_corr_dist, dtype=torch.float32, device=src.device) ** 2
    r = torch.eye(3, dtype=src.dtype, device=src.device).expand(b, 3, 3).contiguous()
    t = torch.zeros((b, 3), dtype=src.dtype, device=src.device)
    for _ in range(iters):
        _, d2, matched = nearest.nearest_moved(src, src_mask, dst, dst_mask, r, t)
        trace.count("icp.sweeps")
        w = (src_mask & (d2 <= lim2)).to(torch.float32)
        r, t = kabsch(src, matched, w + 1e-9)
    _, d2, _ = nearest.nearest_moved(src, src_mask, dst, dst_mask, r, t)
    trace.count("icp.sweeps")
    n_valid = torch.clamp(src_mask.to(torch.float32).sum(dim=-1), min=1.0)
    inl = (src_mask & (d2 <= lim2)).to(torch.float32)
    # d^2 >= 0, so an exact fit's rmse is 0, where the JAX formula's
    # rounding can sum below 0 and take the root of a negative number (NaN)
    sq = torch.where(src_mask, d2, 0.0).sum(dim=-1)
    rmse = torch.sqrt(sq / n_valid)
    return dict(R=r, t=t, rmse=rmse, inlier_frac=inl.sum(dim=-1) / n_valid)


def icp(src, src_mask, dst, dst_mask, iters: int = 20,
        max_corr_dist: float = float("inf")):
    """ICP of one pair: src float32[N, 3] / mask onto dst float32[M, 3] /
    mask.  Returns dict(R [3, 3], t [3], rmse, inlier_frac)."""
    out = batched_icp(src[None], src_mask[None], dst[None], dst_mask[None],
                      iters=iters, max_corr_dist=max_corr_dist)
    return {k: v[0] for k, v in out.items()}


def pad_pairs(pc_clouds, gim_clouds):
    """Numpy clouds of varying sizes as one padded batch: (src f32[B, N, 3],
    src_mask bool[B, N], dst f32[B, M, 3], dst_mask bool[B, M]) with N, M
    the largest cloud, at least 8, as the JAX function pads."""
    n = max(max(len(c) for c in pc_clouds), 8)
    m = max(max(len(c) for c in gim_clouds), 8)
    b = len(pc_clouds)
    src = np.zeros((b, n, 3), np.float32)
    sm = np.zeros((b, n), bool)
    dst = np.zeros((b, m, 3), np.float32)
    dm = np.zeros((b, m), bool)
    for i, (s, d) in enumerate(zip(pc_clouds, gim_clouds)):
        src[i, : len(s)] = s
        sm[i, : len(s)] = True
        dst[i, : len(d)] = d
        dm[i, : len(d)] = True
    return src, sm, dst, dm


def solve_pairs(batch, iters: int = 20, max_corr_dist: float = 5.0, device="cuda"):
    """One batched_icp call on ``device`` over pad_pairs' batch.  Returns a
    list of dicts with numpy R and t and float rmse and inlier_frac."""
    with trace.span("icp.upload"):
        trace.count("upload_bytes", sum(a.nbytes for a in batch))
        tensors = [torch.from_numpy(a).to(device) for a in batch]
    with trace.span("icp.solve"):
        out = batched_icp(*tensors, iters=iters, max_corr_dist=max_corr_dist)
    with trace.span("icp.fetch"):
        out = to_numpy(out)
    return [
        dict(R=out["R"][i], t=out["t"][i], rmse=float(out["rmse"][i]),
             inlier_frac=float(out["inlier_frac"][i]))
        for i in range(len(batch[0]))
    ]


def register_tower_pairs(pc_clouds, gim_clouds, iters: int = 20,
                         max_corr_dist: float = 5.0, device="cuda"):
    """Numpy clouds of varying sizes, src[i] aligned onto dst[i]: padded to
    one batch (pad_pairs), one batched_icp call on ``device`` (solve_pairs),
    then a list of dicts with numpy R and t and float rmse and
    inlier_frac."""
    if not pc_clouds:
        return []
    with trace.span("icp.pack"):
        batch = pad_pairs(pc_clouds, gim_clouds)
    return solve_pairs(batch, iters=iters, max_corr_dist=max_corr_dist, device=device)
