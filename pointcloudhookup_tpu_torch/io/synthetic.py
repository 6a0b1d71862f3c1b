"""Synthetic workload generators.

Copy of ``pointcloudhookup_tpu/io/synthetic.py``: corridor-like point
clouds of ground, vegetation, lattice towers and catenary lines
(``synthetic_corridor``), and GIM model trees (``build_gim_tree``,
``build_synthetic_gim``).  The same generator state gives the same points,
and the same towers the same bytes, in both packages.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from pointcloudhookup_tpu_torch.io.gim import write_gim


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


DEFAULT_FAM_PROPS = {
    "杆塔编号": "P{i}",
    "呼高": "24",
    "杆塔高": "42.0",
    "Kv值": "220",
    "转角": "0.0",
}


def build_gim_tree(
    folder: str,
    towers: Sequence[dict],
    subsystems: int = 1,
) -> None:
    """Write a synthetic GIM model tree (Cbm/project.cbm + per-tower
    .cbm/.fam files) shaped like the reference's parse expectations
    (the reference's ui/parsetower.py:28-114).

    Each tower dict: {"id": str, "lat": float, "lng": float, "h": float,
    "r": float, "props": dict | None}.
    """
    cbm = os.path.join(folder, "Cbm")
    os.makedirs(cbm, exist_ok=True)
    groups = [[] for _ in range(subsystems)]
    for i, t in enumerate(towers):
        groups[i % subsystems].append((i, t))

    sub_names = []
    for s, group in enumerate(groups):
        sub_name = f"F{s + 1}.cbm"
        sub_names.append(sub_name)
        lines = [f"ENTITYNAME=线路{s + 1}", f"GROUPS.NUM={len(group)}"]
        for i, _t in group:
            lines.append(f"GROUP=T{i}.cbm")
        with open(os.path.join(cbm, sub_name), "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
        for i, t in group:
            props = t.get("props") or {
                **{k: v for k, v in DEFAULT_FAM_PROPS.items() if k != "杆塔编号"},
                "杆塔编号": str(t.get("id", f"P{i}")),
            }
            fam_name = f"T{i}.fam"
            with open(os.path.join(cbm, f"T{i}.cbm"), "w", encoding="utf-8") as f:
                f.write(
                    "\n".join(
                        [
                            f"ENTITYNAME={t.get('id', f'塔{i}')}",
                            "GROUPTYPE=TOWER",
                            f"BLHA={t['lat']:.6f},{t['lng']:.6f},{t['h']:.3f},{t['r']:.3f}",
                            f"BASEFAMILY={fam_name}",
                        ]
                    )
                    + "\n"
                )
            with open(os.path.join(cbm, fam_name), "w", encoding="utf-8") as f:
                for k, v in props.items():
                    f.write(f"_={k}={v}\n")

    with open(os.path.join(cbm, "project.cbm"), "w", encoding="utf-8") as f:
        f.write("ENTITYNAME=工程\n")
        for name in sub_names:
            f.write(f"SUBSYSTEM={name}\n")


def build_synthetic_gim(
    gim_path: str,
    towers: Sequence[dict],
    workdir: Optional[str] = None,
    header: Optional[bytes] = None,
) -> str:
    """Build a complete synthetic .gim file; returns the tree folder."""
    import tempfile

    folder = workdir or tempfile.mkdtemp(prefix="gim_tree_")
    build_gim_tree(folder, towers)
    if header is None:
        header = b"GIMHDR\x01" + bytes(range(256)) * 3  # arbitrary 776-ish content
    write_gim(folder, gim_path, header=header, level=1)
    return folder
