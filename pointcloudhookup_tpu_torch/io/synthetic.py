"""Synthetic workload generator.

Copy of ``synthetic_corridor`` from ``pointcloudhookup_tpu/io/synthetic.py``
(the GIM tree builder waits for the GIM port): corridor-like point clouds
of ground, vegetation, lattice towers and catenary lines.  The same
generator state gives the same points in both packages.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def synthetic_corridor(
    rng: np.random.Generator,
    n_ground: int = 20_000,
    n_veg: int = 4_000,
    towers: Sequence[tuple[float, float]] = ((0.0, 0.0), (120.0, 40.0), (-150.0, -60.0)),
    tower_height: float = 35.0,
    tower_width: float = 12.0,
    pts_per_tower: int = 1_500,
    extent: float = 400.0,
    n_line: int = 0,
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
):
    """Synthetic power-line corridor.

    Returns (points f64[N,3], tower_centers f64[K,3]).  Ground is a
    gently rolling surface, towers are tapered lattice columns, optional
    catenary conductor points hang between consecutive towers.
    """
    ground_xy = rng.uniform(-extent, extent, size=(n_ground, 2))
    ground_z = 0.5 * np.sin(ground_xy[:, 0] / 90.0) + rng.normal(0, 0.15, n_ground)
    parts = [np.column_stack([ground_xy, ground_z])]

    if n_veg:
        veg_xy = rng.uniform(-extent, extent, size=(n_veg, 2))
        veg_z = rng.uniform(0.5, 6.0, n_veg)
        parts.append(np.column_stack([veg_xy, veg_z]))

    centers = []
    tower_list = np.asarray(towers, np.float64)
    for cx, cy in tower_list:
        t = rng.uniform(0, 1, pts_per_tower)
        half = tower_width / 2 * (1.0 - 0.7 * t)  # tapered lattice
        x = cx + rng.uniform(-1, 1, pts_per_tower) * half
        y = cy + rng.uniform(-1, 1, pts_per_tower) * half
        z = t * tower_height
        parts.append(np.column_stack([x, y, z]))
        centers.append([cx, cy, tower_height / 2])

    if n_line and len(tower_list) > 1:
        for a, b in zip(tower_list[:-1], tower_list[1:]):
            s = rng.uniform(0, 1, n_line)
            xy = a[None, :] + s[:, None] * (b - a)[None, :]
            sag = 4.0 * s * (1 - s) * 6.0
            z = tower_height - 2.0 - sag + rng.normal(0, 0.05, n_line)
            parts.append(np.column_stack([xy, z]))

    pts = np.vstack(parts)
    pts += np.asarray(origin, np.float64)
    return pts, np.array(centers) + np.asarray(origin, np.float64)
