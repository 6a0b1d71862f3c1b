"""Batched rigid registration: weighted Kabsch and point-to-point ICP.

Counterpart of ``pointcloudhookup_tpu/ops/registration.py``.  The JAX
module writes one pair and vmaps it; here every function takes a batch
[B, N, 3] from the start (a single pair is a batch of one).  Clouds are
padded to fixed N and M with validity masks, and padding enters the
solve as the JAX module's does: a padded source row keeps weight 1e-9 in
Kabsch and the index of the real destination row nearest its position.

Kabsch's products are written out elementwise in float32 (no matmul), so
no TF32 path can touch them.  A sweep (the frame rows moved by R and t,
then each one's nearest valid destination row) is
``ops/kernels/nearest.py::nearest_moved``: the hand-written kernel
``csrc/nearest.cu`` on the card, its plain version on the CPU.  The 3x3
solve is ``torch.linalg.svd`` on the tensors' device.

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
from pointcloudhookup_tpu_torch.state import to_numpy
from pointcloudhookup_tpu_torch.utils import trace


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
