"""ICP-refined tower positions for ``correct(icp=True)``.

Counterpart of ``pointcloudhookup_tpu/models/refine.py``.  A box centre is
a max/min midpoint, so one attached artifact (a conductor stub, clinging
vegetation) shifts it by half the artifact's reach.  Each matched tower is
refined by aligning an idealised pylon frame, built from the tower's box
(or the GIM model's height), onto the tower's own member points with
batched point-to-point ICP, in three stages of shrinking correspondence
radius; the refined centre is the box centre plus the composed
translations (float64 on the host).

Spans (``utils/trace.py``): ``icp.refine`` round the call, ``icp.stage``
round each of the three stages, and inside each stage ``icp.pack`` (the
frames and tower-local clouds in the first, the re-based targets and the
padded batch), then ``solve_pairs``' ``icp.upload``, ``icp.solve`` and
``icp.fetch``.  The counter ``icp.towers`` counts the pairs refined.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pointcloudhookup_tpu_torch.models.towers import Tower
from pointcloudhookup_tpu_torch.utils import trace


def tower_frame_template(
    height: float,
    width: float,
    yaw: float = 0.0,
    levels: int = 14,
    per_edge: int = 5,
    taper: float = 0.7,
) -> np.ndarray:
    """Idealised tapered lattice frame with its box centre at the origin:
    at each of ``levels`` heights, a square ring of 4 * per_edge points
    whose half-width tapers linearly to (1 - taper) at the top.  Host numpy,
    deterministic.  Returns float32[levels * 4 * per_edge, 3]."""
    zs = np.linspace(0.0, 1.0, levels)
    pts = []
    for z in zs:
        half = width / 2.0 * (1.0 - taper * z)
        s = np.linspace(-half, half, per_edge)
        ring = np.concatenate(
            [
                np.column_stack([s, np.full(per_edge, -half)]),
                np.column_stack([s, np.full(per_edge, half)]),
                np.column_stack([np.full(per_edge, -half), s]),
                np.column_stack([np.full(per_edge, half), s]),
            ]
        )
        pts.append(
            np.column_stack([ring, np.full(len(ring), z * height - height / 2.0)])
        )
    out = np.concatenate(pts).astype(np.float32)
    if yaw:
        c, s = np.cos(yaw), np.sin(yaw)
        out[:, :2] = out[:, :2] @ np.array([[c, s], [-s, c]], np.float32)
    return out


def refine_tower_centers(
    towers: Sequence[Tower],
    clouds: Sequence[Optional[np.ndarray]],
    pair_indices: Sequence[int],
    iters: int = 30,
    max_corr_dist: float = 2.0,
    template_params: Optional[dict] = None,
    device="cuda",
) -> dict[int, dict]:
    """Batched ICP refinement of the matched towers' positions on
    ``device``.

    towers: all extracted towers; clouds: each tower's member points in
    world coordinates (None, or fewer than 16 points, skips the tower);
    pair_indices: the point-cloud indices of the matched pairs.
    template_params: optional {pc_index: (height, width)} overriding the
    frame geometry (either may be None to keep the box's value).  Returns
    {pc_index: dict(center f64[3], rmse, inlier_frac, shift f64[3])}."""
    from pointcloudhookup_tpu_torch.ops.registration import pad_pairs, solve_pairs

    with trace.span("icp.refine"):
        idx, frames = [], []
        for pi in pair_indices:
            if pi >= len(clouds) or clouds[pi] is None or len(clouds[pi]) < 16:
                continue
            t = towers[pi]
            # width: the smaller horizontal extent, which a one-sided artifact
            # rarely inflates
            height, width = t.height, float(t.extent[1])
            if template_params and pi in template_params:
                th, tw = template_params[pi]
                height = float(th) if th else height
                width = float(tw) if tw else width
            idx.append(pi)
            frames.append((height, width, t.angle))
        if not idx:
            return {}
        trace.count("icp.towers", len(idx))
        # coarse to fine: unbounded (bulk alignment), then 4x, then the radius
        # itself; each stage re-bases the target by the translation so far
        stage_iters = max(iters // 3, 5)
        stages = [(np.inf, stage_iters), (4.0 * max_corr_dist, stage_iters),
                  (max_corr_dist, stage_iters)]
        shifts = [np.zeros(3) for _ in idx]
        src = dst = last = None
        for radius, it in stages:
            with trace.span("icp.stage"):
                with trace.span("icp.pack"):
                    if src is None:
                        src = [tower_frame_template(h, w, yaw=a) for h, w, a in frames]
                        dst = [(np.asarray(clouds[pi], np.float64) - towers[pi].center)
                               .astype(np.float32) for pi in idx]
                    moved = [(d - s).astype(np.float32) for d, s in zip(dst, shifts)]
                    batch = pad_pairs(src, moved)
                last = solve_pairs(batch, iters=it, max_corr_dist=radius, device=device)
            for i, r in enumerate(last):
                shifts[i] = shifts[i] + np.asarray(r["t"], np.float64)
    return {
        pi: dict(center=towers[pi].center + shifts[i], rmse=r["rmse"],
                 inlier_frac=r["inlier_frac"], shift=shifts[i])
        for i, (pi, r) in enumerate(zip(idx, last))
    }
