"""Forward steps of the port, for callers and smoke tests.

Counterpart of ``entry``, ``_example_batch``, ``_boundary_corridor`` and
``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``:
``entry(device)`` returns ``(fn, (xyz, mask))`` where ``fn(xyz, mask)`` is
the modular extraction step (``models/towers.py::extract_step``) with
default ``ExtractParams()`` and the arguments are a 60,000-point synthetic
corridor padded to 65,536 rows on ``device``; ``dryrun_multichip(n)`` runs
the sharded fast step on n ranks and on one, and raises unless they
accept the same towers.
"""

from __future__ import annotations

import numpy as np
import torch

from pointcloudhookup_tpu_torch.config import (
    ClusterParams,
    ExtractParams,
    GroundParams,
    TowerFilterParams,
)
from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu_torch.models.towers import extract_step


def _example_batch(capacity, n_points, seed=0, spread=400.0):
    """Centred float32 corridor rows padded to capacity, and their mask."""
    rng = np.random.default_rng(seed)
    pts, _ = synthetic_corridor(
        rng,
        n_ground=int(n_points * 0.75),
        n_veg=int(n_points * 0.1),
        pts_per_tower=int(n_points * 0.05),
        extent=spread,
    )
    pts = pts[:n_points] if len(pts) > n_points else pts
    xyz = np.zeros((capacity, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    mask = np.zeros(capacity, bool)
    mask[: len(pts)] = True
    return xyz, mask


def entry(device="cuda"):
    """The modular extraction step and its example batch on ``device``."""
    params = ExtractParams()

    def fn(xyz, mask):
        return extract_step(xyz, mask, params)

    xyz, mask = _example_batch(capacity=65536, n_points=60000)
    return fn, (torch.from_numpy(xyz).to(device), torch.from_numpy(mask).to(device))


def _boundary_corridor(total: int, n_towers: int = 10, seed: int = 3):
    """A corridor of ``total`` rows sorted by x, so that contiguous shards
    are slabs along x and towers near the slab edges are cut by them.
    Returns (xyz float32[total, 3], mask, planted centres)."""
    rng = np.random.default_rng(seed)
    # towers near the x-quantiles of the uniform ground (extent 800: slab
    # edges every 200 m for 8 shards)
    xs = np.linspace(-690.0, 690.0, n_towers)
    ys = 25.0 * np.sin(xs / 180.0)
    n_ground = int(total * 0.72)
    n_veg = int(total * 0.08)
    ppt = (total - n_ground - n_veg) // n_towers
    pts, centers = synthetic_corridor(
        rng, n_ground=n_ground, n_veg=n_veg, towers=tuple(zip(xs, ys)),
        pts_per_tower=ppt, extent=800.0,
    )
    pts[:, 1] *= 0.25  # narrow the corridor (bounds the dense-cell count)
    centers[:, 1] *= 0.25
    pts = pts[:total]
    pts = pts[np.argsort(pts[:, 0], kind="stable")]
    xyz = np.zeros((total, 3), np.float32)
    xyz[: len(pts)] = pts.astype(np.float32)
    mask = np.zeros(total, bool)
    mask[: len(pts)] = True
    return xyz, mask, centers


def _dryrun_rank(device, xyz_r, mask_r, xyz, mask, params):
    """dryrun_multichip's rank: the fast step on its shard over all ranks,
    then (rank 0) on the whole corridor over a group of one.  Returns the
    accepted centres of each run (None for the other ranks' second)."""
    from pointcloudhookup_tpu_torch.parallel.sharded import make_sharded_extract, tile_mesh

    def centres(group, x, m):
        step = make_sharded_extract(group, params, mode="fast")
        _, merged = step(torch.from_numpy(x).to(device), torch.from_numpy(m).to(device))
        return merged["center"][merged["accepted"]].cpu().numpy()

    multi = centres(tile_mesh(), xyz_r, mask_r)
    one = tile_mesh(1)
    return multi, (centres(one, xyz, mask) if one is not None else None)


def dryrun_multichip(n: int, backend: str = "nccl", device=None):
    """Run the sharded fast step over n ranks (``parallel.launch.run_ranks``
    with this backend and device; NCCL with rank r on cuda:r by default)
    and over one rank on the same 16k-row corridor, whose towers straddle
    the slab edges, and raise unless both accept the same towers with
    centres within 1 cm and find every planted tower within 3 m (xy).
    Returns the n-rank run's accepted centres float32[T, 3]."""
    from pointcloudhookup_tpu_torch.parallel.launch import run_ranks

    total = max(16384, 2048 * n)
    n_towers = 6
    xyz, mask, planted = _boundary_corridor(total, n_towers)
    params = ExtractParams(
        ground=GroundParams(min_points_after=64),
        # min_width relaxed: a boundary-split tower's fragment (about half
        # the 12 m lattice) is judged by the merge, not the width filter
        cluster=ClusterParams(eps=5.0, min_points=16, method="grid"),
        filters=TowerFilterParams(min_width=5.0),
        max_clusters=32,
        obb_angles=16,
    )
    rows = total // n
    args = [(xyz[r * rows:(r + 1) * rows], mask[r * rows:(r + 1) * rows], xyz, mask, params)
            for r in range(n)]
    c_multi, c_single = run_ranks(_dryrun_rank, args, backend=backend, devices=device)[0]
    if len(c_multi) != len(c_single):
        raise AssertionError(
            f"dryrun_multichip: {n} ranks accepted {len(c_multi)} towers, one rank "
            f"accepted {len(c_single)}"
        )
    if len(c_multi) != n_towers:
        raise AssertionError(f"dryrun_multichip: accepted {len(c_multi)} towers, "
                             f"planted {n_towers}")
    used, worst = set(), 0.0
    for c in c_multi:
        d = np.linalg.norm(c_single - c[None, :], axis=1)
        j = int(np.argmin(d))
        if j in used:
            raise AssertionError(f"dryrun_multichip: two {n}-rank towers map to one "
                                 f"one-rank tower (index {j})")
        used.add(j)
        worst = max(worst, float(d[j]))
        if d[j] > 0.01:
            raise AssertionError(f"dryrun_multichip: merged centre {d[j] * 100:.1f} cm "
                                 "from the one-rank extraction")
    for tc in planted:
        d = np.linalg.norm(c_multi[:, :2] - tc[None, :2], axis=1)
        if d.min() > 3.0:
            raise AssertionError(f"dryrun_multichip: planted tower at ({tc[0]:.0f}, "
                                 f"{tc[1]:.0f}) missed by {d.min():.2f} m")
    print(f"dryrun_multichip: {n} ranks ({backend}), {total} points, {len(c_multi)} towers "
          f"accepted, max centre delta {worst:.4f} m")
    return c_multi
