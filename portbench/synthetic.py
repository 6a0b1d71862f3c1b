"""Seeded corridor tiles: the benchmark's own frozen copy of the generators.

``synthetic_corridor`` is a copy of
``pointcloudhookup_tpu_torch/io/synthetic.py:19-65`` (itself a copy of the
JAX package's generator), and ``corridor_tile`` of ``chip_smoke.py:209-226``
(``bench.py:31-53``'s tile in world coordinates).  They are frozen here so
that a later change to the program cannot move the yardstick's inputs.

Every tile of a run is drawn from ``numpy.random.default_rng([seed, t])``:
the same seed gives the same bytes, and every seed the same sizes.
"""

from __future__ import annotations

import numpy as np


def synthetic_corridor(rng, n_ground, n_veg, towers, tower_height=35.0,
                       tower_width=12.0, pts_per_tower=1_500, extent=400.0):
    """Ground (a gently rolling surface), vegetation and tapered lattice
    towers.  Returns (points f64[N, 3], tower centres f64[K, 3])."""
    ground_xy = rng.uniform(-extent, extent, size=(n_ground, 2))
    ground_z = 0.5 * np.sin(ground_xy[:, 0] / 90.0) + rng.normal(0, 0.15, n_ground)
    parts = [np.column_stack([ground_xy, ground_z])]
    if n_veg:
        veg_xy = rng.uniform(-extent, extent, size=(n_veg, 2))
        veg_z = rng.uniform(0.5, 6.0, n_veg)
        parts.append(np.column_stack([veg_xy, veg_z]))
    centers = []
    for cx, cy in np.asarray(towers, np.float64):
        t = rng.uniform(0, 1, pts_per_tower)
        half = tower_width / 2 * (1.0 - 0.7 * t)
        x = cx + rng.uniform(-1, 1, pts_per_tower) * half
        y = cy + rng.uniform(-1, 1, pts_per_tower) * half
        parts.append(np.column_stack([x, y, t * tower_height]))
        centers.append([cx, cy, tower_height / 2])
    return np.vstack(parts), np.array(centers)


def corridor_tile(n: int, rng, tile: dict):
    """bench.py's tile of n points: ``ground_share`` ground,
    ``veg_share`` vegetation and the rest on ``towers`` towers along a
    sine of amplitude ``sway_m`` and period ``period_m`` over
    [-span_m, span_m], inside a square of half-width ``extent_m``.
    Returns (points f64[n, 3], centres f64[towers, 3])."""
    k = tile["towers"]
    xs = np.linspace(-tile["span_m"], tile["span_m"], k)
    ys = tile["sway_m"] * np.sin(xs / tile["period_m"])
    pts, centers = synthetic_corridor(
        rng,
        n_ground=int(n * tile["ground_share"]),
        n_veg=int(n * tile["veg_share"]),
        towers=tuple(zip(xs, ys)),
        pts_per_tower=max((n - int(n * (tile["ground_share"] + tile["veg_share"]))) // k, 1),
        extent=tile["extent_m"],
    )
    return pts[:n], centers


def make_tiles(config: dict, seed: int, count: int):
    """The run's ``count`` distinct tiles in world coordinates, as
    (points f64[n, 3], centres f64[K, 3]) pairs.

    ``tile["centred"]`` takes each tile to its mean in float32 first, as
    config 5's tiles are (``benchmarks/config5_streaming.py:44-60``);
    tile t then moves by ``tile["shift_m"]`` * t along x and by
    ``tile["origin"]``."""
    tile = config["tile"]
    out = []
    for t in range(count):
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, t])
        pts, centers = corridor_tile(tile["points"], rng, tile)
        if tile.get("centred"):
            mean = pts.mean(axis=0)
            pts = (pts - mean).astype(np.float32).astype(np.float64)
            centers = centers - mean
        shift = np.asarray(tile.get("origin", (0.0, 0.0, 0.0)), np.float64)
        shift = shift + np.array([tile.get("shift_m", 0.0) * t, 0.0, 0.0])
        out.append((pts + shift, centers + shift))
    return out
