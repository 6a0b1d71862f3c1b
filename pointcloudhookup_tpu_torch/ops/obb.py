"""Per-cluster oriented-bounding-box statistics.

Counterpart of ``pointcloudhookup_tpu/ops/obb.py``: the stable compaction
helper, the sort-free accumulator path of the fused front-end
(``cluster_obb_accumulators``, ``cluster_obb_stats_accum``) and of the
sharded modular step (``cluster_obb_accumulators_xyz``) with the
finisher that turns the OBB accumulators (``ops/kernels/obb_accum.py``)
into per-cluster stats, and the sort-based path (``cluster_obb_stats``,
``cluster_obb_stats_codes``): members sorted by label, densified into a
[K, P] tensor and searched over a coarse and a refined angle grid.
Towers are gravity-aligned, so the box is the minimum-AREA rectangle of
the XY footprint, extruded over the z extent.  The label sorts are stable
(the reference's leave the order of a cluster's members unspecified, which
only moves the centroid sums within f32 summation order).
"""

from __future__ import annotations

import math

import torch

from pointcloudhookup_tpu_torch.ops.kernels.obb_accum import obb_accumulate, obb_accumulate_xyz
from pointcloudhookup_tpu_torch.ops.morton import fma_f32, morton_decode

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


def cluster_obb_accumulators_xyz(xyz, labels, mask, *, max_clusters: int = 128,
                                 num_angles: int = 256):
    """cluster_obb_accumulators over raw float32[N,3] coordinates (the
    sharded modular step: no Morton codes); same return contract.  CUDA
    tensors run the obb_accumulate_xyz kernel at any N (the JAX function
    takes its reference where N is not a multiple of its block)."""
    k = max_clusters
    lab = torch.where((labels >= 0) & (labels < k) & mask, labels, -1)
    x, y, z = (xyz[:, a].contiguous() for a in range(3))
    return obb_accumulate_xyz(x, y, z, lab, max_clusters=k, num_angles=num_angles)


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
    center_xy = fma_f32(cu[:, None], u_vec, cv[:, None] * v_vec)

    # angle 0 projects onto (x, y): axis-aligned bounds are column 0
    return _finalize_obb_stats(
        counts, alive, centroid, center_xy, theta, u_vec, v_vec, eu_b, ev_b,
        acc["ulo"][:, 0], acc["uhi"][:, 0], acc["vlo"][:, 0], acc["vhi"][:, 0],
        acc["zlo"], acc["zhi"], k,
        overflow=torch.zeros((), dtype=f32, device=dev),
        theta_factors=(best.to(f32), step),
    )


def north_angle_deg(theta):
    """The reference's north angle (90 - degrees(theta)) mod 360, rounded as
    XLA:CPU compiles it: one fused multiply-add by the f32 constant 180/pi,
    then the remainder."""
    rad2deg = torch.tensor(180.0 / math.pi, dtype=torch.float32, device=theta.device)
    ninety = torch.tensor(90.0, dtype=torch.float32, device=theta.device)
    return torch.remainder(fma_f32(-theta, rad2deg, ninety), 360.0)


def _finalize_obb_stats(
    counts, alive, centroid, center_xy, theta, u_vec, v_vec, eu_b, ev_b,
    x_lo, x_hi, y_lo, y_hi, z_lo, z_hi, k, overflow, theta_factors=None,
):
    """Canonical long-axis swap, the reference's north-angle convention
    ((90 - atan2) mod 360) and the stats dict.  ``theta_factors`` = (a, b)
    where theta = a * b: XLA:CPU fuses that product into the angle's add."""
    ez = z_hi - z_lo
    center = torch.cat([center_xy, ((z_hi + z_lo) * 0.5)[:, None]], dim=1)
    swap = ev_b > eu_b
    ex = torch.where(swap, ev_b, eu_b)
    ey = torch.where(swap, eu_b, ev_b)
    axis = torch.where(swap[:, None], v_vec, u_vec)
    north = north_angle_deg(torch.atan2(axis[:, 1], axis[:, 0]))
    quarter = swap * (math.pi / 2.0)
    angle = theta + quarter if theta_factors is None else fma_f32(*theta_factors, quarter)

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
        angle=torch.where(alive, angle, 0.0),
        north_angle=torch.where(alive, north, 0.0),
        aabb_min=torch.where(alive[:, None], aabb_min, _BIG),
        aabb_max=torch.where(alive[:, None], aabb_max, -_BIG),
        overflow=overflow,
    )


def cluster_obb_stats(xyz, labels, mask, *, max_clusters: int = 128,
                      num_angles: int = 256, angle_tile: int = 32,
                      per_cluster_cap: int = 16384):
    """Per-cluster gravity-aligned OBB stats of float32[N,3] points with
    labels int32[N] in [0, K) or -1 and mask bool[N]: members sorted by
    label (coordinates riding along), densified into [K, P] with
    P = min(per_cluster_cap, N), and the coarse + refined angle search.
    'overflow' counts members beyond P."""
    n = xyz.shape[0]
    k = max_clusters
    valid = (labels >= 0) & (labels < k) & mask
    lab = torch.where(valid, labels, k).to(torch.int32)
    lab_s, perm = torch.sort(lab, stable=True)
    gx, gy, gz, member, counts, alive, overflow = _densify_runs(
        lab_s, tuple(xyz[perm, a] for a in range(3)), k, min(per_cluster_cap, n)
    )
    return _obb_from_members(gx, gy, gz, member, counts, alive, overflow, k,
                             num_angles=num_angles, angle_tile=angle_tile)


def cluster_obb_stats_codes(hi, lo, labels, mask, mn, *, voxel_size: float = 0.1,
                            max_clusters: int = 128, num_angles: int = 256,
                            angle_tile: int = 32, per_cluster_cap: int = 16384,
                            points_cap: int | None = None):
    """cluster_obb_stats over Morton-coded voxel rows (hi/lo int32[N], grid
    origin mn float32[3], a multiple of vs): sorts (label, hi, lo) and
    decodes the geometric voxel centres on the [K, P] member tensor only,
    ``ix * vs + voxel_centre_offset(mn)`` rounded once (XLA:CPU contracts
    it into a fused multiply-add).  points_cap first compacts the labelled
    rows to that capacity; rows beyond it are counted in 'overflow'."""
    n = hi.shape[0]
    k = max_clusters
    valid = (labels >= 0) & (labels < k) & mask
    lab = torch.where(valid, labels, k).to(torch.int32)
    cap_over = torch.zeros((), dtype=torch.float32, device=hi.device)
    if points_cap is not None and points_cap < n:
        (lab, hi, lo), _, cap_over = _compact_valid_rows(
            valid, (lab, hi, lo), points_cap, fill=k
        )
        n = points_cap
    lab_s, perm = torch.sort(lab, stable=True)
    gh, gl, member, counts, alive, overflow = _densify_runs(
        lab_s, (hi[perm], lo[perm]), k, min(per_cluster_cap, n)
    )
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=hi.device)
    offset = voxel_centre_offset(mn, voxel_size)
    gx, gy, gz = (fma_f32(i.to(torch.float32), vs, offset[a])
                  for a, i in enumerate(morton_decode(gh, gl)))
    return _obb_from_members(gx, gy, gz, member, counts, alive, overflow + cap_over, k,
                             num_angles=num_angles, angle_tile=angle_tile)


def voxel_centre_offset(mn, voxel_size: float = 0.1):
    """float32[3] mn + vs/2 as XLA:CPU compiles the reference's whole fused
    step, where mn = floor(.) * vs and the half-voxel add round ONCE (a
    fused multiply-add): the origin's voxel index k = mn / vs (exact after
    rounding: mn is k * vs within one float32 ulp) times vs plus vs/2,
    through float64."""
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=mn.device)
    k = torch.round(mn.double() / vs.double())
    return (k * vs.double() + (vs * 0.5).double()).to(torch.float32)


def _densify_runs(lab_s, payloads, k: int, p: int):
    """Label-sorted rows -> per-cluster [K, P] member tensors: cluster c is
    the run [left_c, right_c) and is read from the P rows at
    min(left_c, N - P).  Returns (*payloads[K, P], member bool[K, P],
    counts float32[K], alive bool[K], overflow float32)."""
    n = lab_s.shape[0]
    dev = lab_s.device
    ar = torch.arange(k, dtype=lab_s.dtype, device=dev)
    lefts = torch.searchsorted(lab_s, ar, side="left")
    rights = torch.searchsorted(lab_s, ar, side="right")
    counts_i = rights - lefts
    overflow = torch.clamp(counts_i - p, min=0).to(torch.float32).sum()
    starts = torch.clamp(lefts, max=n - p)
    pos = starts[:, None] + torch.arange(p, device=dev)[None, :]
    member = (pos >= lefts[:, None]) & (pos < rights[:, None])
    return (*(v[pos] for v in payloads), member, counts_i.to(torch.float32),
            counts_i > 0, overflow)


def _cos_f32(x):
    """float32 cos rounded from float64, on either device.  XLA:CPU calls
    libm's ``cosf`` / ``sinf`` for these [K, A] angles; those differ from
    this rounding in ~1 % of arguments, torch's float32 cos in ~5 %."""
    return torch.cos(x.double()).to(torch.float32)


def _sin_f32(x):
    return torch.sin(x.double()).to(torch.float32)


def _obb_from_members(gx, gy, gz, member, counts, alive, overflow, k: int, *,
                      num_angles: int, angle_tile: int):
    """Stats from dense [K, P] members: centroids, then the min-area XY
    rectangle by a coarse pass over min(2 * angle_tile, A, 32) angles in
    [0, pi/2) and a 17-sample refinement within one coarse step around
    each cluster's winner."""
    if num_angles % angle_tile:
        raise ValueError("num_angles must be a multiple of angle_tile")
    dev = gx.device
    f32 = torch.float32
    ar = torch.arange(k, device=dev)
    mw = member.to(f32)
    denom = torch.clamp(mw.sum(dim=1), min=1.0)
    centroid = torch.stack([(g * mw).sum(dim=1) / denom for g in (gx, gy, gz)], dim=1)
    centroid = torch.where(alive[:, None], centroid, 0.0)

    coarse = min(angle_tile * 2, num_angles, 32)
    refine = 17  # odd: the centre sample is the coarse winner itself
    step = math.pi / 2.0 / coarse
    mk = member[:, :, None]

    def rect_stats(angles):  # [K, A] per cluster -> extents and sums
        cos_a = _cos_f32(angles)[:, None, :]
        sin_a = _sin_f32(angles)[:, None, :]
        x, y = gx[:, :, None], gy[:, :, None]
        pu = fma_f32(x, cos_a, y * sin_a)  # [K, P, A]
        pv = fma_f32(y, cos_a, -(x * sin_a))
        pu_hi = torch.where(mk, pu, -_BIG).amax(dim=1)
        pu_lo = torch.where(mk, pu, _BIG).amin(dim=1)
        pv_hi = torch.where(mk, pv, -_BIG).amax(dim=1)
        pv_lo = torch.where(mk, pv, _BIG).amin(dim=1)
        return pu_hi - pu_lo, pv_hi - pv_lo, pu_hi + pu_lo, pv_hi + pv_lo

    step_t = torch.tensor(step, dtype=f32, device=dev)
    a1 = torch.arange(coarse, dtype=f32, device=dev) * step_t
    eu1, ev1, _, _ = rect_stats(a1[None, :].expand(k, coarse))
    best1 = torch.argmin(eu1 * ev1, dim=1).to(f32)
    half = refine // 2
    deltas = (torch.arange(refine, dtype=f32, device=dev) - half) * torch.tensor(
        step / half, dtype=f32, device=dev)
    # XLA:CPU rounds best1 * step once for the 17 angles it projects on,
    # but fuses it into the add where it gathers the winning angle
    a2 = (best1 * step_t)[:, None] + deltas[None, :]  # [K, refine]
    eu, ev, su, sv = rect_stats(a2)
    best = torch.argmin(eu * ev, dim=1)
    eu_b = eu[ar, best]
    ev_b = ev[ar, best]
    cu = su[ar, best] * 0.5
    cv = sv[ar, best] * 0.5
    theta = fma_f32(best1, step_t, deltas[best])
    cos_t, sin_t = _cos_f32(theta), _sin_f32(theta)
    u_vec = torch.stack([cos_t, sin_t], dim=1)
    v_vec = torch.stack([-sin_t, cos_t], dim=1)
    center_xy = fma_f32(cu[:, None], u_vec, cv[:, None] * v_vec)

    # axis-aligned bounds over the member tensor (z is the height extent)
    def lo_hi(g):
        return (torch.where(member, g, _BIG).amin(dim=1),
                torch.where(member, g, -_BIG).amax(dim=1))

    (x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi) = lo_hi(gx), lo_hi(gy), lo_hi(gz)
    return _finalize_obb_stats(
        counts, alive, centroid, center_xy, theta, u_vec, v_vec, eu_b, ev_b,
        x_lo, x_hi, y_lo, y_hi, z_lo, z_hi, k, overflow,
    )
