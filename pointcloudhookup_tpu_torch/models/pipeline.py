"""Headless pipeline API.

Counterpart of ``pointcloudhookup_tpu/models/pipeline.py``, the reference's
workflow with the same parameter names and defaults:

  compress(...)    voxel-grid downsample of a LAS file (on ``device``)
  extract(...)     tower extraction from a LAS tile (on ``device``)
  reproject_las    EPSG:4547 -> WGS84 of every point (f32 deltas on ``device``)
  import_gim(...)  unpack a .gim and parse its tower records (host)
  match(...)       pair GIM towers with extracted towers (host f64)
  correct(...)     match, then write the point-cloud positions back (host f64;
                   icp=True refines them by batched ICP on ``device``)
  save_gim(...)    rewrite the CBM BLHA lines and repack the .gim (host)

``extract`` -> ``extract_from_points`` routes a tile as the JAX package
does: to the exact path (``_exact_fast_plan`` / ``_extract_stats_exact_fast``,
the capacity retry ladder, ``ops/frontend_exact.py::exact_extract_graph``)
where it is eligible, otherwise, and where the exact path gives up, to the
modular ``models/towers.py::extract_step`` with its density-floor retry.
The device is explicit (``device=``): there is no fallback to the CPU when
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
from pointcloudhookup_tpu_torch.core.batch import round_up
from pointcloudhookup_tpu_torch.io.cbm import apply_corrections, load_towers_from_gim_folder
from pointcloudhookup_tpu_torch.io.gim import extract_gim, write_gim
from pointcloudhookup_tpu_torch.io.las import (
    LasData,
    make_las,
    read_las,
    write_kept_rows,
    write_las,
)
from pointcloudhookup_tpu_torch.models.towers import Tower, extract_step, towers_from_stats
from pointcloudhookup_tpu_torch.native import prepare_tile
from pointcloudhookup_tpu_torch.ops.frontend_exact import (
    exact_cell_plan,
    exact_extract_graph,
)
from pointcloudhookup_tpu_torch.ops.geo import (
    GeoidGrid,
    ellipsoid_to_orthometric,
    haversine_matrix,
    local_cgcs2000_to_wgs84,
    tm_inverse,
)
from pointcloudhookup_tpu_torch.ops.voxel import voxel_downsample, voxel_downsample_chunked
from pointcloudhookup_tpu_torch.state import to_numpy
from pointcloudhookup_tpu_torch.utils import trace
from pointcloudhookup_tpu_torch.utils.logging import Reporter


# ------------------------------------------------------------ compress
def compress(
    input_path: str,
    output_path: str,
    voxel_size: float = 0.1,
    chunk_size: int = 500_000,
    progress_callback=None,
    log_callback=None,
    per_chunk: bool = False,
    device="cuda",
) -> int:
    """Voxel-grid downsample a LAS file on ``device``, keeping the source's
    scales, offsets, point format and version.  per_chunk=True dedups
    voxels within each chunk_size block only, as the reference does.
    Returns the output point count."""
    with trace.span("compress"):
        rep = Reporter(progress_callback, log_callback)
        las, pts = _read_las(input_path)
        rep.log(f"read {len(pts)} points from {input_path}")
        rep.progress(10)

        with trace.span("compress.prepare"):
            cap = round_up(max(len(pts), 1), chunk_size if per_chunk else 1024)
            origin, xyz, mask, _ = _centre_tile(pts, cap)
            xyz_t, mask_t = _upload(xyz, device), _upload(mask, device)
        with trace.span("compress.voxel"):
            if per_chunk:
                out_xyz, out_mask = voxel_downsample_chunked(
                    xyz_t, mask_t, voxel_size, chunk_size=chunk_size)
            else:
                out_xyz, out_mask = voxel_downsample(xyz_t, mask_t, voxel_size)
        rep.progress(80)
        with trace.span("compress.fetch"):
            rows, keep = to_numpy(out_xyz), to_numpy(out_mask)

        with trace.span("compress.write"):
            # one native pass from the kept rows to the file's records; the
            # same bytes as make_las + write_las, which write without it
            n = write_kept_rows(output_path, rows, keep, origin, las.scales, las.offsets,
                                las.point_format, las.version)
            if n is not None:
                trace.count("compress.write.native")
            else:
                out = rows[keep].astype(np.float64) + origin
                reduced = make_las(
                    out, scales=las.scales, offsets=las.offsets,
                    point_format=las.point_format, version=las.version,
                )
                write_las(reduced, output_path)
                n = len(out)
        rep.progress(100)
        rep.log(f"downsampled to {n} points -> {output_path}")
    return n


def _read_las(path) -> tuple[LasData, np.ndarray]:
    """The LAS/LAZ file at ``path`` and its world xyz f64[N, 3], under one
    las.load span: read_las's header read (las.read), then the xyz decode
    (las.xyz), native in one pass for an uncompressed file where the
    decoder is built (io/las.py ``_LasFile``)."""
    with trace.span("las.load"):
        las = read_las(path)
        with trace.span("las.xyz"):
            return las, las.xyz()


def _upload(array: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, its bytes counted as upload_bytes."""
    trace.count("upload_bytes", array.nbytes)
    return torch.from_numpy(array).to(device)


# ------------------------------------------------------------ extract
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
    las, pts = _read_las(input_las_path)
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


def _exact_fast_plan(points: np.ndarray, params: ExtractParams, cap: int, span=None):
    """Host-side routing decision for the exact front-end, identical to
    the JAX package's: the static cell-key bit plan, or None when the tile
    would take the modular path.  ``span`` is the tile's per-axis
    ``max - min`` where the caller has it already."""
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
    if span is None:
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
    with trace.span("extract.upload"):
        xyz_t, mask_t = _upload(xyz, device), _upload(mask, device)
    while True:
        trace.count("extract.ladder_step")
        with trace.span("extract.graph"):
            stats = exact_extract_graph(
                xyz_t, mask_t, params, cell_bits=cell_bits, compact_cap=ccap,
                max_cells=params.cluster.max_cells, min_cell_points=floor,
                core_cap=core_cap,
            )
        with trace.span("extract.fetch"):
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

    with trace.span("extract.finish"):
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
    with trace.span("extract"):
        with trace.span("extract.prepare"):
            origin, xyz, mask, plan = _prepare_tile(points, params, capacity)

        stats = None
        if plan is not None:
            stats = _extract_stats_exact_fast(xyz, mask, params, plan, device=device)
        if stats is None:
            stats = _extract_stats_modular(xyz, mask, params, device=device)
        with trace.span("extract.finish"):
            towers = towers_from_stats(stats, origin)
    return towers, stats, origin


def _prepare_tile(points, params: ExtractParams, capacity: Optional[int]):
    """A tile's host preparation: (origin f64[3], xyz f32[cap, 3] centred
    on it with zero padding rows, mask bool[cap], the exact path's plan),
    through ``_centre_tile``; a tile the native passes prepared counts as
    ``extract.prepare.native``."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    n = len(points)
    if capacity is not None:
        cap = capacity
    elif params.cluster.per_chunk:
        cap = round_up(max(n, 1), params.cluster.chunk_size)
    elif n > params.cluster.auto_grid_threshold:
        cap = round_up(max(n, 1), 32768)
    else:
        cap = round_up(max(n, 1), 1024)
    origin, xyz, mask, span = _centre_tile(points, cap)
    if span is not None:
        trace.count("extract.prepare.native")
    return origin, xyz, mask, _exact_fast_plan(points, params, cap, span)


def _centre_tile(points: np.ndarray, cap: int):
    """(origin f64[3], xyz f32[cap, 3], mask bool[cap], span f64[3] or None)
    of f64 rows [N, 3]: the origin is their mean, xyz the rows' f32 ``points
    - origin`` followed by zero rows, mask True on the N rows.  Where
    ``native.prepare_tile`` takes the rows (a C-ordered f64 array with no
    NaN or inf) two native passes give them, with the span ``max - min``;
    otherwise numpy does, with the same bits, and the span is None."""
    n = len(points)
    prepared = prepare_tile(points, cap)
    if prepared is None:
        origin = points.mean(axis=0) if n else np.zeros(3)
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:n] = (points - origin).astype(np.float32)
        span = None
    else:
        origin, xyz, span = prepared
    mask = np.empty(cap, bool)
    mask[:n] = True
    mask[n:] = False
    return origin, xyz, mask, span


def _extract_stats_modular(xyz: np.ndarray, mask: np.ndarray, params: ExtractParams,
                           device="cuda") -> dict:
    """Run ``extract_step`` under the JAX package's density-floor retry: a
    grid table overflow drops dense cells (whole towers, at corridor
    scale), so the step re-runs with the floor doubled (at least 2, at
    most 16) while cells_overflow > 0.  Returns the numpy stats with
    'modular' = dict(floor, cells_overflow)."""
    with trace.span("extract.upload"):
        xyz_t, mask_t = _upload(xyz, device), _upload(mask, device)
    floor = params.cluster.min_cell_points
    step_params = params
    while True:
        trace.count("extract.ladder_step")
        with trace.span("extract.graph"):
            stats = extract_step(xyz_t, mask_t, step_params)
        with trace.span("extract.fetch"):
            stats = to_numpy(stats)
        if not (float(stats["cells_overflow"]) > 0.0 and floor < 16):
            break
        floor = min(floor * 2 if floor > 1 else 2, 16)
        step_params = dataclasses.replace(
            params, cluster=dataclasses.replace(params.cluster, min_cell_points=floor)
        )
    stats["modular"] = dict(floor=floor, cells_overflow=float(stats["cells_overflow"]))
    return stats


_TABLE_HEADERS = ("ID", "经度", "纬度", "海拔高度", "杆塔高度", "北方向偏角", "宽度", "长宽比")


def export_towers_table(towers: Sequence[Tower], path: str) -> str:
    """Write the towers_info table with the reference's Chinese headers.
    Returns the path written (see ``write_table``)."""
    rows = [
        (
            t.id, t.center[0], t.center[1], t.center[2], t.height,
            t.north_angle, t.width, t.height / max(t.width, 1e-6),
        )
        for t in towers
    ]
    return write_table(_TABLE_HEADERS, rows, path)


def write_table(headers: Sequence[str], rows: Sequence[Sequence], path: str) -> str:
    """Write a table: xlsx needs pandas and an Excel engine; without them,
    and for any other path, the table is written as csv (an .xlsx path
    becomes .csv).  Returns the path written."""
    if path.endswith(".xlsx"):
        try:
            import pandas as pd

            pd.DataFrame(list(rows), columns=list(headers)).to_excel(path, index=False)
            return path
        except ImportError:  # no pandas, or no Excel engine
            path = path[:-5] + ".csv"
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator=os.linesep)  # as pandas ends lines
        writer.writerow(headers)
        writer.writerows(rows)
    return path


# ------------------------------------------------------------ reproject
def reproject_las(
    input_path: str,
    output_path: str,
    log_callback=None,
    batch: int = 1 << 20,
    device="cuda",
) -> int:
    """Transform every point of a LAS file from EPSG:4547 to WGS84 lon/lat.

    One host-f64 LocalTaylor2D expansion around the tile's mean, then f32
    delta evaluation on ``device`` in ``batch``-point blocks: sub-mm
    agreement with the f64 inverse over a +-2 km tile.  The output LAS
    stores degrees at 1e-7 scale and carries the source's VLR block
    through.  Returns the point count."""
    rep = Reporter(None, log_callback)
    las = read_las(input_path)
    xyz = las.xyz()
    n = len(xyz)
    e0, n0 = (float(xyz[:, 0].mean()), float(xyz[:, 1].mean())) if n else (500000.0, 0.0)
    lt = local_cgcs2000_to_wgs84(e0, n0)

    lons = np.empty(n)
    lats = np.empty(n)
    for start in range(0, n, batch):
        sl = slice(start, min(start + batch, n))
        de = torch.from_numpy((xyz[sl, 0] - e0).astype(np.float32)).to(device)
        dn = torch.from_numpy((xyz[sl, 1] - n0).astype(np.float32)).to(device)
        dlon, dlat = lt.eval_delta(de, dn)
        lons[sl] = lt.u0 + dlon.cpu().numpy().astype(np.float64)
        lats[sl] = lt.v0 + dlat.cpu().numpy().astype(np.float64)
    out = np.column_stack([lons, lats, xyz[:, 2]])
    deg = make_las(
        out,
        scales=[1e-7, 1e-7, las.scales[2]],
        offsets=[float(np.floor(lons.min())) if n else 0.0,
                 float(np.floor(lats.min())) if n else 0.0,
                 las.offsets[2]],
        point_format=las.point_format,
        version=las.version,
        vlr_bytes=las.vlr_bytes,
        num_vlrs=las.num_vlrs,
    )
    write_las(deg, output_path)
    rep.log(f"reprojected {n} points -> {output_path}")
    return n


# ------------------------------------------------------------ import GIM
def import_gim(gim_path: str, output_folder: str = "output", log_callback=None):
    """Unpack a .gim and parse its tower records.
    Returns (tower_records, extracted_folder, header)."""
    with trace.span("gim.import"):
        rep = Reporter(None, log_callback)
        folder, header = extract_gim(gim_path, output_folder)
        rep.log(f"extracted GIM to {folder}")
        records = load_towers_from_gim_folder(folder, rep.log)
        rep.log(f"parsed {len(records)} towers from GIM")
    return records, folder, header


# ------------------------------------------------------------ match
@dataclasses.dataclass
class ConvertedTower:
    """A point-cloud tower after CRS and elevation conversion (the
    reference's converted_tower dict)."""

    id: str
    converted_center: list  # [lon_wgs84, lat_wgs84, orthometric_h]
    height: float
    north_angle: float
    original_center: list  # [e_cgcs2000, n_cgcs2000, h_ellipsoid]
    ellipsoid_height: float
    orthometric_height: float
    n_value: float
    height_conversion_applied: bool
    # set where a refinement moved the tower (the JAX package's ICP)
    icp_rmse: Optional[float] = None


_GIM_HEADERS = ("杆塔编号", "纬度", "经度", "高程", "北方向偏角")
_PC_HEADERS = ("杆塔编号(PC)", "纬度(WGS84)", "经度(WGS84)", "高程(正高)", "北方向偏角(PC)")


def _csv_columns(rows: Sequence[Sequence], n: int) -> list[list[str]]:
    """The columns of one side table as pandas writes them after
    ``pd.concat(axis=1)`` pads it with NaN to n rows: NaN is an empty field,
    and a column of ints that needs padding turns float ("1.0")."""
    if not rows:
        return []
    cols = []
    for values in zip(*rows):
        as_float = len(values) < n and all(
            isinstance(v, int) and not isinstance(v, bool) for v in values)
        cells = [repr(float(v)) if as_float else str(v) for v in values]
        cols.append(cells + [""] * (n - len(values)))
    return cols


@dataclasses.dataclass
class MatchResult:
    """The reference's match/correct panel, headless: the two tables, the
    pair list and the converted towers."""

    pairs: list  # [(gim_idx, pc_idx)]
    converted_towers: list  # [ConvertedTower]
    gim_rows: list  # left table rows [id, lat, lng, h, r]
    pc_rows: list  # right table rows [id, lat, lng, h_ortho, north]
    corrected_gim: bool = False  # True when produced by correct()

    def to_csv(self, path: str) -> None:
        """Side-by-side tables; the pairing is explicit in the 配对 columns.
        The bytes are those of the JAX package's pandas writer
        (``pd.concat([left, right], axis=1).to_csv(index=False)``), written
        with the csv module."""
        pair_of_gim = {gi: pi for gi, pi in self.pairs}
        pair_of_pc = {pi: gi for gi, pi in self.pairs}
        left = [[pair_of_gim.get(i, "")] + list(r) for i, r in enumerate(self.gim_rows)]
        right = [[pair_of_pc.get(i, "")] + list(r) for i, r in enumerate(self.pc_rows)]
        n = max(len(left), len(right))
        headers = ["配对PC行", *_GIM_HEADERS, "配对GIM行", *_PC_HEADERS]
        cols = (_csv_columns(left, n) or [[""] * n] * 6) + (
            _csv_columns(right, n) or [[""] * n] * 6)
        with open(path, "w", newline="", encoding="utf-8") as f:
            writer = csv.writer(f, lineterminator=os.linesep)
            writer.writerow(headers)
            writer.writerows(zip(*cols))

    # rotating row-highlight palette, as in the reference's Qt panel
    # (lightblue / light yellow / gainsboro)
    _COLORS = ("#ADD8E6", "#FFFFCC", "#DCDCDC")

    def to_html(self, path: str, title: str = "匹配结果") -> None:
        """Self-contained review page: GIM and point-cloud tables side by
        side, matched pairs highlighted in rotating colors."""
        color_of_gim = {}
        color_of_pc = {}
        for i, (gi, pi) in enumerate(self.pairs):
            c = self._COLORS[i % len(self._COLORS)]
            color_of_gim[gi] = c
            color_of_pc[pi] = c

        def table(rows, headers, colors):
            out = ["<table border='1' cellspacing='0' cellpadding='4'>"]
            out.append(
                "<tr>" + "".join(f"<th>{h}</th>" for h in headers) + "</tr>"
            )
            for i, row in enumerate(rows):
                style = f" style='background:{colors[i]}'" if i in colors else ""
                out.append(
                    f"<tr{style}>" + "".join(f"<td>{v}</td>" for v in row) + "</tr>"
                )
            out.append("</table>")
            return "\n".join(out)

        left = table(self.gim_rows, list(_GIM_HEADERS), color_of_gim)
        right = table(
            self.pc_rows,
            ["杆塔编号", "纬度(WGS84)", "经度(WGS84)", "高程(正高)", "北方向偏角"],
            color_of_pc,
        )
        mode = "校对" if self.corrected_gim else "匹配"
        html = f"""<!doctype html><meta charset="utf-8"><title>{title}</title>
<h2>{title} ({mode}; {len(self.pairs)} 对)</h2>
<div style="display:flex; gap:24px; font-family:sans-serif; font-size:13px">
<div><h3>GIM 数据</h3>{left}</div>
<div><h3>点云数据 (正高转换后)</h3>{right}</div>
</div>"""
        with open(path, "w", encoding="utf-8") as f:
            f.write(html)


def convert_pointcloud_towers(
    pc_towers: Sequence[Tower],
    region_n_value: float = 25.0,
    geoid: Optional[GeoidGrid] = None,
) -> list[ConvertedTower]:
    """CGCS2000 -> WGS84 and ellipsoid -> orthometric for extracted towers,
    in host f64 (the tower list is small; precision beats batching)."""
    out = []
    for i, t in enumerate(pc_towers):
        e, n, h_ellip = float(t.center[0]), float(t.center[1]), float(t.center[2])
        lon, lat = tm_inverse(e, n)
        lon, lat = float(lon), float(lat)
        h_ortho = float(ellipsoid_to_orthometric(lat, lon, h_ellip, geoid, region_n_value))
        out.append(
            ConvertedTower(
                id=f"PC-{i + 1}",
                converted_center=[lon, lat, h_ortho],
                height=float(t.height),
                north_angle=float(t.north_angle),
                original_center=[e, n, h_ellip],
                ellipsoid_height=h_ellip,
                orthometric_height=h_ortho,
                n_value=h_ellip - h_ortho,
                height_conversion_applied=True,
            )
        )
    return out


def match_towers(
    gim_list: Sequence,
    converted: Sequence[ConvertedTower],
    distance_threshold: float = 50.0,
    height_threshold: float = 100.0,
) -> list[tuple[int, int]]:
    """Greedy first-match pairing, the reference's loop: for each GIM tower
    in order, the first point-cloud tower within both thresholds wins;
    point-cloud towers are not consumed (one may pair repeatedly)."""
    if not len(gim_list) or not len(converted):
        return []
    g_lat = np.array([float(t.get("lat", 0) or 0) for t in gim_list])
    g_lon = np.array([float(t.get("lng", 0) or 0) for t in gim_list])
    g_h = np.array([float(t.get("h", 0) or 0) for t in gim_list])
    p_lon = np.array([c.converted_center[0] for c in converted])
    p_lat = np.array([c.converted_center[1] for c in converted])
    p_h = np.array([c.converted_center[2] for c in converted])
    dist = haversine_matrix(g_lat, g_lon, p_lat, p_lon)
    ok = (dist <= distance_threshold) & (
        np.abs(g_h[:, None] - p_h[None, :]) <= height_threshold
    )
    first = ok.argmax(axis=1)
    return [(int(i), int(first[i])) for i in np.nonzero(ok.any(axis=1))[0]]


def _tower_prop(gim_tower, key, default=""):
    props = gim_tower.get("properties") or {}
    return props.get(key, default) if isinstance(props, dict) else default


def _build_result(gim_list, converted, pairs, corrected: bool) -> MatchResult:
    gim_rows = [
        [
            _tower_prop(t, "杆塔编号"),
            f"{float(t.get('lat', 0) or 0):.6f}",
            f"{float(t.get('lng', 0) or 0):.6f}",
            f"{float(t.get('h', 0) or 0):.2f}",
            f"{float(t.get('r', 0) or 0):.1f}",
        ]
        for t in gim_list
    ]
    pc_rows = [
        [
            c.id,
            f"{c.converted_center[1]:.6f}",
            f"{c.converted_center[0]:.6f}",
            f"{c.converted_center[2]:.2f}",
            f"{c.north_angle:.1f}",
        ]
        for c in converted
    ]
    for gi, pi in pairs:
        gim_id = _tower_prop(gim_list[gi], "杆塔编号")
        gim_r = float(gim_list[gi].get("r", 0) or 0)
        # matched point-cloud towers adopt the GIM id and north angle
        converted[pi].id = str(gim_id)
        converted[pi].north_angle = gim_r
        pc_rows[pi][0] = str(gim_id)
        pc_rows[pi][4] = f"{gim_r:.1f}"
        if corrected:
            # correct(): the point-cloud coordinates flow back into the GIM
            # table; the GIM north angle is kept
            c = converted[pi]
            gim_rows[gi][1] = f"{c.converted_center[1]:.6f}"
            gim_rows[gi][2] = f"{c.converted_center[0]:.6f}"
            gim_rows[gi][3] = f"{c.converted_center[2]:.2f}"
    return MatchResult(
        pairs=pairs,
        converted_towers=list(converted),
        gim_rows=gim_rows,
        pc_rows=pc_rows,
        corrected_gim=corrected,
    )


def match(
    gim_list: Sequence,
    pc_towers: Sequence[Tower],
    region_n_value: float = 25.0,
    distance_threshold: float = 50.0,
    height_threshold: float = 100.0,
    geoid: Optional[GeoidGrid] = None,
) -> MatchResult:
    """Match GIM towers to extracted point-cloud towers."""
    converted = convert_pointcloud_towers(pc_towers, region_n_value, geoid)
    pairs = match_towers(gim_list, converted, distance_threshold, height_threshold)
    return _build_result(gim_list, converted, pairs, corrected=False)


def correct(
    gim_list: Sequence,
    pc_towers: Sequence[Tower],
    region_n_value: float = 25.0,
    distance_threshold: float = 50.0,
    height_threshold: float = 100.0,
    geoid: Optional[GeoidGrid] = None,
    icp: bool = False,
    pc_clouds: Optional[Sequence] = None,
    icp_iters: int = 30,
    icp_max_corr_dist: float = 2.0,
    device="cuda",
) -> MatchResult:
    """Match, then write the point-cloud derived coordinates back into the
    GIM rows.

    icp=True needs ``pc_clouds``, each tower's member points in world
    coordinates (aligned with ``pc_towers``): every matched tower's
    position is refined by batched ICP on ``device`` against an idealised
    pylon frame before the write-back (models/refine.py), its height from
    the GIM tower's 杆塔高 where the record has one.  Refined pairs carry
    their ICP rmse in ConvertedTower.icp_rmse."""
    with trace.span("gim.correct"):
        converted = convert_pointcloud_towers(pc_towers, region_n_value, geoid)
        pairs = match_towers(gim_list, converted, distance_threshold, height_threshold)
        if icp and pairs:
            if pc_clouds is None:
                raise ValueError("correct(icp=True) requires pc_clouds")
            from pointcloudhookup_tpu_torch.models.refine import refine_tower_centers

            tmpl = {}
            for gi, pi in pairs:
                try:
                    th = float(_tower_prop(gim_list[gi], "杆塔高", ""))
                except (TypeError, ValueError):
                    th = None
                if th:
                    tmpl[pi] = (th, None)
            refined = refine_tower_centers(
                pc_towers, pc_clouds, [pi for _, pi in pairs],
                iters=icp_iters, max_corr_dist=icp_max_corr_dist,
                template_params=tmpl or None, device=device,
            )
            for pi, r in refined.items():
                e, n, h_ellip = (float(v) for v in r["center"])
                lon, lat = (float(v) for v in tm_inverse(e, n))
                h_ortho = float(ellipsoid_to_orthometric(lat, lon, h_ellip, geoid,
                                                         region_n_value))
                c = converted[pi]
                c.converted_center = [lon, lat, h_ortho]
                c.original_center = [e, n, h_ellip]
                c.ellipsoid_height = h_ellip
                c.orthometric_height = h_ortho
                c.n_value = h_ellip - h_ortho
                c.icp_rmse = float(r["rmse"])
        return _build_result(gim_list, converted, pairs, corrected=True)


# ------------------------------------------------------------ save
def corrected_rows_from_result(result: MatchResult, gim_list: Sequence) -> list[dict]:
    """The corrected rows save_gim consumes, carrying each matched tower's
    CBM path."""
    rows = []
    for gi, pi in result.pairs:
        c = result.converted_towers[pi]
        rows.append(
            {
                "杆塔编号": _tower_prop(gim_list[gi], "杆塔编号"),
                "纬度": c.converted_center[1],
                "经度": c.converted_center[0],
                "高度": c.converted_center[2],
                "北方向偏角": c.north_angle,
                "CBM路径": gim_list[gi].get("cbm_path", ""),
            }
        )
    return rows


def save_gim(
    extracted_gim_folder: str,
    corrected_data: Sequence[dict],
    output_gim_path: str,
    original_gim_path: Optional[str] = None,
    log_callback=None,
    level: int = 9,
) -> bool:
    """Update the CBM BLHA lines from corrected rows and repack the .gim
    behind the original's 776-byte header.  Returns False (and logs why)
    when the files cannot be written."""
    rep = Reporter(None, log_callback)
    with trace.span("gim.save"):
        try:
            updated = apply_corrections(extracted_gim_folder, list(corrected_data), rep.log)
            rep.log(f"updated {updated} CBM files")
            header = None
            if original_gim_path and os.path.exists(original_gim_path):
                with open(original_gim_path, "rb") as f:
                    header = f.read(776)
            write_gim(extracted_gim_folder, output_gim_path, header=header, level=level)
            rep.log(f"GIM written: {output_gim_path}")
            return True
        except (OSError, ValueError) as e:
            rep.log(f"save failed: {e}")
            return False
