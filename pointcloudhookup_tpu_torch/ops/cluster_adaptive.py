"""Knob-free adaptive clustering (the HDBSCAN analogue).

Counterpart of ``pointcloudhookup_tpu/ops/cluster_adaptive.py``: eps is
derived from the data (a quantile of the k-th-NN distances of a strided
subsample), ``grid_dbscan`` clusters at that eps, and clusters smaller
than min_cluster_size points are demoted to noise.

The eps estimate is bit-equal to the JAX function's on XLA:CPU, which
rounds d2 = dx*dx + dy*dy + dz*dz and the quantile's linear interpolation
with fused multiply-adds (``ops/morton.py::fma_f32``); one ulp of eps can
move a cell edge.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloudhookup_tpu_torch.ops.cluster_grid import grid_dbscan
from pointcloudhookup_tpu_torch.ops.kernels.build import f32_scalar
from pointcloudhookup_tpu_torch.ops.morton import fma_f32

_S = 4096  # subsample size for the core-distance probe
_EPS_QUANTILE = 60.0  # percentile of the k-th-NN distances taken as eps
_EPS_FLOOR = 0.5  # eps is clamped to [_EPS_FLOOR, _EPS_CEIL]
_EPS_CEIL = 64.0


def _nanpercentile(x, q: float):
    """jnp.nanpercentile(x, q) of a 1-D float32 tensor ('linear'), with the
    JAX function's arithmetic: NaNs sort last, position q/100 * (count - 1),
    weights from floor/ceil, low * (1 - w) + high * w with the second
    product fused into the sum.  Returns a 0-d float32 tensor (NaN when x
    holds no number)."""
    a = torch.sort(x).values  # NaNs last
    cnt = (~torch.isnan(a)).sum().to(torch.float32)
    pos = float(np.float32(q) / np.float32(100.0)) * (cnt - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    last = torch.clamp(cnt - 1.0, min=0.0)

    def at(i):  # a[i] for a 0-d index tensor, with no host read
        return a.index_select(0, torch.minimum(torch.clamp(i, min=0.0), last).long()
                              .reshape(1)).reshape(())

    return fma_f32(at(high), hw, at(low) * lw)


def estimate_eps(xyz, mask, *, k: int = 4, sample: int = _S,
                 quantile: float = _EPS_QUANTILE):
    """Core-distance quantile from a strided subsample: the k-th smallest
    distance of each sampled point to the others (d2 from differences),
    then their quantile.  Returns a float32 0-d tensor."""
    n = xyz.shape[0]
    s = min(sample, n)
    stride = max(n // s, 1)
    pts = xyz[::stride][:s]
    mk = mask[::stride][:s]
    pts = torch.where(mk[:, None], pts, 3.0e38)
    dx, dy, dz = (pts[:, None, a] - pts[None, :, a] for a in range(3))
    d2 = fma_f32(dz, dz, fma_f32(dy, dy, dx * dx))
    eye = torch.eye(s, dtype=torch.bool, device=xyz.device)
    d2 = torch.where(eye | ~mk[None, :], torch.inf, d2)
    kk = min(max(k, 1), s - 1)
    dk2 = torch.topk(d2, kk, dim=1, largest=False).values[:, kk - 1]
    dk = torch.sqrt(torch.where(mk, dk2, torch.nan))
    return _nanpercentile(dk, quantile)


def adaptive_cluster(xyz, mask, min_points: int, *, min_cluster_size: int | None = None,
                     max_cells: int = 65536, min_cell_points: int = 1,
                     eps_fallback: float | None = None):
    """Data-derived eps + min-cluster-size filtering.  Returns (labels
    int32[N] compact ids / -1 noise, core bool[N], eps float32 0-d tensor).

    The subsample's NN rank is min_points rescaled by the sampling ratio
    (at most 128).  eps is the estimate clamped to [0.5, 64]; a non-finite
    or ceiling-saturated estimate falls back to eps_fallback when one is
    given."""
    n = xyz.shape[0]
    if min_cluster_size is None:
        min_cluster_size = min_points
    ratio = min(_S / max(n, 1), 1.0)
    k = max(1, min(int(round(min_points * ratio)), 128))
    eps_raw = estimate_eps(xyz, mask, k=k)
    eps = torch.clamp(eps_raw, _EPS_FLOOR, _EPS_CEIL)
    if eps_fallback is not None:
        bad = ~torch.isfinite(eps_raw) | (eps_raw >= _EPS_CEIL)
        eps = torch.where(bad, f32_scalar(eps_fallback, eps.device).reshape(()), eps)
    labels, core, _ = grid_dbscan(xyz, mask, eps, min_points, max_cells=max_cells,
                                  min_cell_points=min_cell_points)
    labels = _filter_small_clusters(labels, min_cluster_size, max_labels=max_cells)
    return labels, core & (labels >= 0), eps


def _filter_small_clusters(labels, min_cluster_size: int, max_labels: int = 4096):
    """Demote clusters with fewer than min_cluster_size members to noise
    (labels in [0, max_labels) or -1)."""
    lab = torch.where(labels >= 0, labels, max_labels).long()
    # index_add_, not bincount: bincount reads the maximum on the host
    sizes = torch.zeros(max_labels + 1, dtype=torch.int32, device=labels.device).index_add_(
        0, lab, torch.ones_like(labels))[:max_labels]
    keep_label = sizes >= min_cluster_size
    ok = (labels >= 0) & keep_label[torch.clamp(labels, 0, max_labels - 1).long()]
    return torch.where(ok, labels, -1)
