"""Display geometry: enlarged tower wireframes as 12-edge linesets.

Copy of ``pointcloudhookup_tpu/viz/boxes.py`` (host numpy): the
"kuangxuan" asymmetric box expansion and its presets, symmetric boxes with
height-adaptive scale factors, 12-edge linesets as point PAIRS (two rows an
edge), their JSON export, and the random display subsample.  The port's
towers may carry tensors: ``tower_display_geometries`` reads each field to
the host once.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

# the preset catalog
BBOX_PRESETS = {
    "kuangxuan_original": dict(
        method="kuangxuan",
        params=dict(
            x_left_factor=1.0, x_right_factor=1.67,
            y_down_factor=0.5, y_up_factor=1.0,
            z_down_factor=1.0, z_up_factor=2.0,
        ),
    ),
    "kuangxuan_conservative": dict(
        method="kuangxuan",
        params=dict(
            x_left_factor=0.8, x_right_factor=1.2,
            y_down_factor=0.4, y_up_factor=0.8,
            z_down_factor=0.5, z_up_factor=1.5,
        ),
    ),
    "kuangxuan_aggressive": dict(
        method="kuangxuan",
        params=dict(
            x_left_factor=1.5, x_right_factor=2.0,
            y_down_factor=0.8, y_up_factor=1.5,
            z_down_factor=1.5, z_up_factor=3.0,
        ),
    ),
    "symmetric_moderate": dict(method="symmetric", params=dict(x_scale=2.0, y_scale=2.0, z_scale=1.5)),
    "symmetric_large": dict(method="symmetric", params=dict(x_scale=3.0, y_scale=3.0, z_scale=2.0)),
}


def get_bbox_preset(name: str):
    preset = BBOX_PRESETS.get(name, BBOX_PRESETS["kuangxuan_original"])
    return preset["method"], preset["params"]


def expand_box_kuangxuan(
    center,
    width: float,
    height: float,
    x_left_factor: float = 1.0,
    x_right_factor: float = 1.67,
    y_down_factor: float = 0.5,
    y_up_factor: float = 1.0,
    z_down_factor: float = 1.0,
    z_up_factor: float = 2.0,
):
    """Asymmetric axis-aligned expansion around a tower center; factors
    multiply the tower WIDTH in x/y and HEIGHT in z."""
    cx, cy, cz = (float(v) for v in center)
    mins = np.array([
        cx - width * x_left_factor,
        cy - width * y_down_factor,
        cz - height * z_down_factor,
    ])
    maxs = np.array([
        cx + width * x_right_factor,
        cy + width * y_up_factor,
        cz + height * z_up_factor,
    ])
    return mins, maxs


def adaptive_scale_for_height(height: float) -> list[float]:
    """Height-class adaptive symmetric scale factors."""
    if height < 20.0:
        return [3.2, 3.2, 5.0]
    if height < 40.0:
        return [3.0, 3.0, 4.8]
    return [2.8, 2.8, 4.5]


_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),  # bottom
    (4, 5), (5, 6), (6, 7), (7, 4),  # top
    (0, 4), (1, 5), (2, 6), (3, 7),  # sides
]


def _corners_aabb(mins, maxs) -> np.ndarray:
    x0, y0, z0 = mins
    x1, y1, z1 = maxs
    return np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ]
    )


def _corners_obb(center, yaw: float, extents) -> np.ndarray:
    ex, ey, ez = np.asarray(extents, float) / 2.0
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    local = np.array(
        [
            [-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
            [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez],
        ]
    )
    out = local.copy()
    out[:, :2] = local[:, :2] @ rot.T
    return out + np.asarray(center, float)


def box_lineset(corners_or_min, maxs=None) -> np.ndarray:
    """12-edge wireframe as point PAIRS f64[24,3] (two rows per edge)."""
    corners = (
        _corners_aabb(corners_or_min, maxs) if maxs is not None else np.asarray(corners_or_min)
    )
    pts = []
    for a, b in _EDGES:
        pts.append(corners[a])
        pts.append(corners[b])
    return np.array(pts)


def _host(v):
    """A tower field as a host value: a tensor is read to numpy once."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return v


def tower_display_geometries(
    towers: Sequence,
    method: str = "kuangxuan",
    preset: Optional[str] = "kuangxuan_original",
    params: Optional[dict] = None,
    scale_factors: Optional[Sequence[float]] = None,
    adaptive_scaling: bool = True,
    color=(1.0, 0.0, 0.0),
) -> list[tuple[np.ndarray, tuple]]:
    """Enlarged wireframe boxes for a tower list (models.Tower or dicts
    with center/extent/width/height/angle, numpy or tensors).  Returns
    [(f64[24,3], rgb)].

    method="kuangxuan": asymmetric AABB expansion (preset or params).
    method="symmetric": yaw-aligned OBB scaled by scale_factors or the
    height-adaptive factors.
    """
    if preset and params is None and method == "kuangxuan":
        method, params = get_bbox_preset(preset)
    out = []
    for t in towers:
        raw = t.get if isinstance(t, dict) else lambda k, d=None: getattr(t, k, d)

        def get(k, d=None):
            return _host(raw(k, d))

        center = np.asarray(get("center"), float)
        extent = np.asarray(get("extent"), float)
        width = float(get("width", max(extent[0], extent[1])))
        height = float(get("height", extent[2]))
        if method == "kuangxuan":
            mins, maxs = expand_box_kuangxuan(center, width, height, **(params or {}))
            out.append((box_lineset(mins, maxs), tuple(color)))
        else:
            scale = (
                adaptive_scale_for_height(height)
                if adaptive_scaling and scale_factors is None
                else list(scale_factors or [2.8, 2.8, 4.5])
            )
            yaw = float(get("angle", 0.0))
            corners = _corners_obb(center, yaw, extent * np.asarray(scale))
            out.append((box_lineset(corners), tuple(color)))
    return out


def export_geometries_json(geoms, path: str) -> None:
    """Serialize [(points, color)] linesets for external viewers."""
    payload = [
        dict(points=np.asarray(p).tolist(), color=list(c)) for p, c in geoms
    ]
    with open(path, "w") as f:
        json.dump(payload, f)


def subsample_for_display(points: np.ndarray, cap: int = 500_000, seed: int = 0):
    """Random display subsample of at most cap points."""
    points = np.asarray(points)
    if len(points) <= cap:
        return points
    return points[subsample_indices(len(points), cap, seed)]


def subsample_indices(n: int, cap: int, seed: int = 0):
    """The index set subsample_for_display would pick: use it to keep
    per-point attributes (colors etc.) aligned with the subsample.  numpy's
    generator, as the JAX package draws it, so both show the same subset."""
    if n <= cap:
        return np.arange(n)
    rng = np.random.default_rng(seed)
    return rng.choice(n, cap, replace=False)
