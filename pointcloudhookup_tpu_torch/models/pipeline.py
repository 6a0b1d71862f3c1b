"""Headless extraction API.

Counterpart of ``pointcloudhookup_tpu/models/pipeline.py`` for tower
extraction: ``extract`` (LAS in, towers out) -> ``extract_from_points``,
which routes a tile as the JAX package does: to the exact path
(``_exact_fast_plan`` / ``_extract_stats_exact_fast``, the capacity retry
ladder, ``ops/frontend_exact.py::exact_extract_graph``) where it is
eligible, otherwise, and where the exact path gives up, to the modular
``models/towers.py::extract_step`` with its density-floor retry.  The
device is explicit (``device=``): there is no fallback to the CPU when
CUDA is missing.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from pointcloudhookup_tpu_torch.config import (
    ClusterParams,
    ExtractParams,
    GroundParams,
    TowerFilterParams,
)
from pointcloudhookup_tpu_torch.io.las import make_las, read_las, write_las
from pointcloudhookup_tpu_torch.utils.logging import Reporter
from pointcloudhookup_tpu_torch.core.batch import round_up
from pointcloudhookup_tpu_torch.models.towers import Tower, extract_step, towers_from_stats
from pointcloudhookup_tpu_torch.ops.frontend_exact import (
    exact_cell_plan,
    exact_extract_graph,
)
from pointcloudhookup_tpu_torch.state import to_numpy


def extract(
    input_las_path: str,
    progress_callback=None,
    log_callback=None,
    eps: float = 8.0,
    min_points: int = 80,
    aspect_ratio_threshold: float = 0.8,
    min_height: float = 15.0,
    max_width: float = 50.0,
    min_width: float = 8.0,
    duplicate_threshold: float = 30.0,
    params: Optional[ExtractParams] = None,
    output_dir: Optional[str] = None,
    excel_path: Optional[str] = None,
    max_clusters: int = 128,
    device="cuda",
) -> list[Tower]:
    """Extract transmission towers from a LAS tile on ``device``.

    Keyword names and defaults mirror the JAX package's ``extract``;
    ``params`` overrides the whole parameter tree.  ``output_dir`` saves
    each tower's points as tower_<label>.las; ``excel_path`` writes the
    towers_info table (xlsx when pandas and an engine are available,
    otherwise csv)."""
    rep = Reporter(progress_callback, log_callback)
    if params is None:
        params = ExtractParams(
            ground=GroundParams(),
            cluster=ClusterParams(eps=eps, min_points=min_points),
            filters=TowerFilterParams(
                aspect_ratio_threshold=aspect_ratio_threshold,
                min_height=min_height,
                max_width=max_width,
                min_width=min_width,
                duplicate_threshold=duplicate_threshold,
            ),
            max_clusters=max_clusters,
        )

    rep.log(f"reading {input_las_path}")
    rep.progress(5)
    las = read_las(input_las_path)
    pts = las.xyz()
    rep.log(f"read {len(pts)} points")

    towers, stats, origin = extract_from_points(pts, params, device=device)
    if "ladder" in stats:
        rep.log(
            "exact path: density floor {floor}, core_cap {core_cap}, "
            "compact_cap {compact_cap}, compact_count {compact_count}".format(
                **stats["ladder"])
        )
    else:
        rep.log(
            "modular path: density floor {floor}, cells_overflow {cells_overflow}".format(
                **stats["modular"])
        )
    rep.progress(90)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        labels = np.asarray(stats["labels"])[: len(pts)]
        for t in towers:
            out = make_las(
                pts[labels == t.label], scales=las.scales, offsets=las.offsets,
                point_format=las.point_format, version=las.version,
            )
            write_las(out, os.path.join(output_dir, f"tower_{t.label}.las"))
        rep.log(f"saved {len(towers)} tower LAS files to {output_dir}")

    if excel_path:
        written = export_towers_table(towers, excel_path)
        rep.log(f"tower table written to {written}")

    rep.progress(100)
    rep.log(f"extraction complete: {len(towers)} towers")
    return towers


def _exact_fast_plan(points: np.ndarray, params: ExtractParams, cap: int):
    """Host-side routing decision for the exact front-end, identical to
    the JAX package's: the static cell-key bit plan, or None when the tile
    would take the modular path."""
    cp = params.cluster
    if cp.per_chunk or cp.method not in ("auto", "grid"):
        return None
    if cp.method == "auto" and cap <= cp.auto_grid_threshold:
        return None
    # the 32768 rule is the TPU kernels'; kept so tiles route as in JAX
    if cap % 32768 or cp.max_cells % 1024:
        return None
    if not len(points):
        return None
    span = points.max(axis=0) - points.min(axis=0)
    return exact_cell_plan(span, cp.eps)


def _extract_stats_exact_fast(
    xyz: np.ndarray,
    mask: np.ndarray,
    params: ExtractParams,
    cell_bits,
    _ccap: Optional[int] = None,
    _core_cap0: int = 2048,
    device="cuda",
) -> Optional[dict]:
    """Run the exact front-end under the reference's retry ladder and
    rebuild input-order labels / ground_keep on the host.

    The survivor compaction starts at N/4 capacity and retries ONCE at
    full capacity (always exact) on overflow; a dense-cell table spill
    doubles the density floor (up to 16); a core-table spill re-sizes
    core_cap directly from the spill count (core_overflow = n_core -
    cap).  Returns None when the core cells exceed the largest flood
    table (32768).  The numpy stats dict gains 'labels', 'ground_keep'
    and 'ladder' (the settled floor, core_cap, compact_cap and the true
    compact_count).  _ccap injects a small starting capacity for tests."""
    cap = xyz.shape[0]
    ccap = _ccap if _ccap is not None else min(
        round_up(max(cap // 4, 32768), 32768), cap
    )
    floor = params.cluster.min_cell_points
    core_cap = _core_cap0
    xyz_t = torch.from_numpy(xyz).to(device)
    mask_t = torch.from_numpy(mask).to(device)
    while True:
        stats = exact_extract_graph(
            xyz_t, mask_t, params, cell_bits=cell_bits, compact_cap=ccap,
            max_cells=params.cluster.max_cells, min_cell_points=floor,
            core_cap=core_cap,
        )
        stats = to_numpy(stats)
        if float(stats["core_overflow"]) > 0.0:
            if core_cap < 32768:
                need = core_cap + int(stats["core_overflow"])
                core_cap = min(32768, 1 << (need - 1).bit_length())
                continue
            return None
        if int(stats["compact_count"]) > ccap:
            ccap = cap  # survivors <= N, so full capacity always fits
            continue
        if float(stats["cells_overflow"]) > 0.0 and floor < 16:
            floor = min(floor * 2 if floor > 1 else 2, 16)
            continue
        break

    stats.pop("core_overflow")
    labels = np.full(cap, -1, np.int32)
    labs = stats.pop("labels_sorted")
    rows = stats.pop("rows_sorted")
    sel = labs >= 0
    labels[rows[sel]] = labs[sel]
    off = (
        params.ground.retry_offset
        if bool(stats.pop("used_retry"))
        else params.ground.offset
    )
    base = np.float32(stats["base_height"])
    keep = mask & (xyz[:, 2].astype(np.float32) > base + np.float32(off))
    stats["ladder"] = dict(
        floor=floor, core_cap=core_cap, compact_cap=ccap,
        compact_count=int(stats.pop("compact_count")),
    )
    stats["labels"] = labels
    stats["ground_keep"] = keep
    return stats


def extract_from_points(
    points: np.ndarray,
    params: ExtractParams = ExtractParams(),
    capacity: Optional[int] = None,
    device="cuda",
) -> tuple[list[Tower], dict, np.ndarray]:
    """Extraction from an in-memory f64[N,3] world-coordinate array on
    ``device``.  Returns (towers, stats dict as numpy, origin).
    ``capacity`` pins the padded buffer size.

    Eligible tiles take the exact path (stats gain 'ladder'); the others,
    and tiles with more core cells than the exact path's largest flood
    table, take the modular ``extract_step``, re-run with a doubled
    density floor (up to 16) while dense grid cells overflow the table, as
    the JAX package does (stats gain 'modular': the settled floor and its
    cells_overflow)."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    origin = points.mean(axis=0) if len(points) else np.zeros(3)
    if capacity is not None:
        cap = capacity
    elif params.cluster.per_chunk:
        cap = round_up(max(len(points), 1), params.cluster.chunk_size)
    elif len(points) > params.cluster.auto_grid_threshold:
        cap = round_up(max(len(points), 1), 32768)
    else:
        cap = round_up(max(len(points), 1), 1024)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(points)] = (points - origin).astype(np.float32)
    mask = np.zeros(cap, bool)
    mask[: len(points)] = True

    plan = _exact_fast_plan(points, params, cap)
    if plan is not None:
        stats = _extract_stats_exact_fast(xyz, mask, params, plan, device=device)
        if stats is not None:
            return towers_from_stats(stats, origin), stats, origin
    stats = _extract_stats_modular(xyz, mask, params, device=device)
    return towers_from_stats(stats, origin), stats, origin


def _extract_stats_modular(xyz: np.ndarray, mask: np.ndarray, params: ExtractParams,
                           device="cuda") -> dict:
    """Run ``extract_step`` under the JAX package's density-floor retry: a
    grid table overflow drops dense cells (whole towers, at corridor
    scale), so the step re-runs with the floor doubled (at least 2, at
    most 16) while cells_overflow > 0.  Returns the numpy stats with
    'modular' = dict(floor, cells_overflow)."""
    xyz_t = torch.from_numpy(xyz).to(device)
    mask_t = torch.from_numpy(mask).to(device)
    floor = params.cluster.min_cell_points
    stats = to_numpy(extract_step(xyz_t, mask_t, params))
    while float(stats["cells_overflow"]) > 0.0 and floor < 16:
        floor = min(floor * 2 if floor > 1 else 2, 16)
        retry = dataclasses.replace(
            params, cluster=dataclasses.replace(params.cluster, min_cell_points=floor)
        )
        stats = to_numpy(extract_step(xyz_t, mask_t, retry))
    stats["modular"] = dict(floor=floor, cells_overflow=float(stats["cells_overflow"]))
    return stats


_TABLE_HEADERS = ("ID", "经度", "纬度", "海拔高度", "杆塔高度", "北方向偏角", "宽度", "长宽比")


def export_towers_table(towers: Sequence[Tower], path: str) -> str:
    """Write the towers_info table with the reference's Chinese headers.
    xlsx needs pandas and an Excel engine; without them, and for any other
    path, the table is written as csv.  Returns the path written."""
    rows = [
        (
            t.id, t.center[0], t.center[1], t.center[2], t.height,
            t.north_angle, t.width, t.height / max(t.width, 1e-6),
        )
        for t in towers
    ]
    if path.endswith(".xlsx"):
        try:
            import pandas as pd

            pd.DataFrame(rows, columns=list(_TABLE_HEADERS)).to_excel(
                path, index=False
            )
            return path
        except ImportError:  # no pandas, or no Excel engine
            path = path[:-5] + ".csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(_TABLE_HEADERS)
        writer.writerows(rows)
    return path
