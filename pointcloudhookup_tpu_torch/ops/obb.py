"""Per-cluster oriented-bounding-box statistics.

Counterpart of ``pointcloudhookup_tpu/ops/obb.py``: the stable compaction
helper, the sort-free accumulator path of the fused front-end
(``cluster_obb_accumulators``, ``cluster_obb_stats_accum``) and the
finisher that turns the OBB accumulators (``ops/kernels/obb_accum.py``)
into per-cluster stats.  Towers are
gravity-aligned, so the box is the minimum-AREA rectangle of the XY
footprint over a flat grid of A angles, extruded over the z extent.
"""

from __future__ import annotations

import math

import torch

from pointcloudhookup_tpu_torch.ops.kernels.obb_accum import obb_accumulate

_BIG = 3.0e38


def _compact_valid_rows(valid, payloads, cap: int, fill):
    """Stable compaction: the first ``cap`` valid rows move to the front of
    fixed-size [cap] tensors.  The source row of output slot j is the
    first row whose running valid-count reaches j+1 (cumsum + binary
    search + gathers).  Returns (compacted payload tuple, n_valid,
    overflow_count float32); slots past n_valid carry ``fill`` in payload
    0 and garbage elsewhere."""
    n = valid.shape[0]
    csum = torch.cumsum(valid.to(torch.int64), 0)
    n_valid = csum[-1].to(torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int64, device=valid.device)
    src = torch.clamp(torch.searchsorted(csum, want, side="left"), 0, n - 1)
    slot_ok = torch.arange(cap, device=valid.device) < n_valid
    first = torch.where(slot_ok, payloads[0][src], fill)
    rest = tuple(p[src] for p in payloads[1:])
    overflow = torch.clamp(n_valid - cap, min=0).to(torch.float32)
    return (first, *rest), n_valid, overflow


def cluster_obb_accumulators(hi, lo, labels, mask, mn, *, voxel_size: float = 0.1,
                             max_clusters: int = 128, num_angles: int = 256):
    """RAW per-cluster OBB accumulators over Morton-coded rows (hi/lo
    int32[N], labels int32[N], mask bool[N], grid origin mn float32[3]):
    dict(cnt[K], sx, sy, sz, zlo, zhi, ulo[K,A], uhi, vlo, vhi).  Rows
    outside mask or with a label outside [0, K) are skipped.  CUDA tensors
    run the obb_accumulate kernel."""
    k = max_clusters
    lab = torch.where((labels >= 0) & (labels < k) & mask, labels, -1)
    return obb_accumulate(
        hi, lo, lab, mn, voxel_size=voxel_size, max_clusters=k,
        num_angles=num_angles,
    )


def cluster_obb_stats_accum(hi, lo, labels, mask, mn, *, voxel_size: float = 0.1,
                            max_clusters: int = 128, num_angles: int = 256):
    """Sort-free OBB stats of the fused front-end's Morton rows: one
    accumulation pass and the finisher.  Exact (no member cap);
    'overflow' is always 0."""
    acc = cluster_obb_accumulators(
        hi, lo, labels, mask, mn, voxel_size=voxel_size,
        max_clusters=max_clusters, num_angles=num_angles,
    )
    return _obb_from_accum(acc, max_clusters, num_angles)


def obb_stats_from_accumulators(acc, max_clusters: int, num_angles: int):
    """Per-cluster stats dict from the raw OBB accumulators."""
    return _obb_from_accum(acc, max_clusters, num_angles)


def _obb_from_accum(acc, k, num_angles):
    dev = acc["cnt"].device
    f32 = torch.float32
    ar = torch.arange(k, device=dev)
    counts = acc["cnt"]
    alive = counts > 0.0
    denom = torch.clamp(counts, min=1.0)
    centroid = torch.stack(
        [acc["sx"] / denom, acc["sy"] / denom, acc["sz"] / denom], dim=1
    )
    centroid = torch.where(alive[:, None], centroid, 0.0)

    eu = acc["uhi"] - acc["ulo"]  # [K, A]
    ev = acc["vhi"] - acc["vlo"]
    best = torch.argmin(eu * ev, dim=1)  # first minimum, like jnp.argmin
    eu_b = eu[ar, best]
    ev_b = ev[ar, best]
    cu = (acc["uhi"] + acc["ulo"])[ar, best] * 0.5
    cv = (acc["vhi"] + acc["vlo"])[ar, best] * 0.5
    step = torch.tensor(math.pi / 2.0 / num_angles, dtype=f32, device=dev)
    theta = best.to(f32) * step
    u_vec = torch.stack([torch.cos(theta), torch.sin(theta)], dim=1)
    v_vec = torch.stack([-torch.sin(theta), torch.cos(theta)], dim=1)
    center_xy = cu[:, None] * u_vec + cv[:, None] * v_vec

    # angle 0 projects onto (x, y): axis-aligned bounds are column 0
    return _finalize_obb_stats(
        counts, alive, centroid, center_xy, theta, u_vec, v_vec, eu_b, ev_b,
        acc["ulo"][:, 0], acc["uhi"][:, 0], acc["vlo"][:, 0], acc["vhi"][:, 0],
        acc["zlo"], acc["zhi"], k,
        overflow=torch.zeros((), dtype=f32, device=dev),
    )


def _finalize_obb_stats(
    counts, alive, centroid, center_xy, theta, u_vec, v_vec, eu_b, ev_b,
    x_lo, x_hi, y_lo, y_hi, z_lo, z_hi, k, overflow,
):
    """Canonical long-axis swap, the reference's north-angle convention
    ((90 - atan2) mod 360) and the stats dict."""
    ez = z_hi - z_lo
    center = torch.cat([center_xy, ((z_hi + z_lo) * 0.5)[:, None]], dim=1)
    swap = ev_b > eu_b
    ex = torch.where(swap, ev_b, eu_b)
    ey = torch.where(swap, eu_b, ev_b)
    axis = torch.where(swap[:, None], v_vec, u_vec)
    ang_deg = torch.rad2deg(torch.atan2(axis[:, 1], axis[:, 0]))
    north = torch.remainder(90.0 - ang_deg, 360.0)

    zero3 = torch.zeros((k, 3), dtype=torch.float32, device=counts.device)
    aabb_min = torch.stack([x_lo, y_lo, z_lo], dim=1)
    aabb_max = torch.stack([x_hi, y_hi, z_hi], dim=1)
    return dict(
        count=counts,
        alive=alive,
        centroid=centroid,
        center=torch.where(alive[:, None], center, zero3),
        extent=torch.where(
            alive[:, None], torch.stack([ex, ey, ez], dim=1), zero3
        ),
        angle=torch.where(alive, theta + swap * (math.pi / 2.0), 0.0),
        north_angle=torch.where(alive, north, 0.0),
        aabb_min=torch.where(alive[:, None], aabb_min, _BIG),
        aabb_max=torch.where(alive[:, None], aabb_max, -_BIG),
        overflow=overflow,
    )
