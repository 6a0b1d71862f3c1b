"""Elevation conversion reporting (ellipsoid -> orthometric).

Counterpart of ``pointcloudhookup_tpu/models/elevation_report.py``: the
geoid grid where one is given, else the regional empirical N, applied to a
tower table, with CSV, text-report and optional bar-chart outputs.  The
CSV is written with the csv module, byte for byte what the JAX package's
``pandas.DataFrame.to_csv(index=False)`` writes; the chart alone needs
matplotlib, imported when asked for, and is skipped without it.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np

from pointcloudhookup_tpu_torch.ops.geo import GeoidGrid


@dataclasses.dataclass
class ElevationRow:
    tower_id: str
    lat: float
    lon: float
    h_ellipsoid: float
    h_orthometric: float
    n_value: float
    method: str


def convert_to_orthometric(
    towers: Sequence[dict],
    geoid: Optional[GeoidGrid] = None,
    empirical_n: float = 28.0,
) -> list[ElevationRow]:
    """Per tower dict {id, lat, lon, h}: N from the geoid grid, or the
    empirical N without one."""
    rows = []
    for t in towers:
        lat, lon, h = float(t["lat"]), float(t["lon"]), float(t["h"])
        if geoid is not None:
            n = float(geoid.interp(lat, lon))
            method = "geoid_grid"
        else:
            n = empirical_n
            method = "empirical_n"
        rows.append(
            ElevationRow(
                tower_id=str(t.get("id", "")),
                lat=lat,
                lon=lon,
                h_ellipsoid=h,
                h_orthometric=h - n,
                n_value=n,
                method=method,
            )
        )
    return rows


def _csv_field(v) -> str:
    """A value as pandas writes it: floats by repr, NaN as an empty field."""
    if isinstance(v, float):
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_csv(rows: Sequence[ElevationRow], path: str) -> None:
    """The rows as ``pd.DataFrame([asdict(r) ...]).to_csv(path,
    index=False)`` writes them: a header line of the field names (an
    empty line for no rows, a frame without columns), then a line a row."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator=os.linesep)  # as pandas ends lines
        writer.writerow([field.name for field in dataclasses.fields(ElevationRow)]
                        if rows else [])
        for r in rows:
            writer.writerow(_csv_field(v) for v in dataclasses.astuple(r))


def write_report(
    rows: Sequence[ElevationRow],
    csv_path: Optional[str] = None,
    text_path: Optional[str] = None,
    chart_path: Optional[str] = None,
) -> str:
    """Emit CSV / text / bar-chart artifacts; returns the text report."""
    if csv_path:
        write_csv(rows, csv_path)

    lines = ["Elevation conversion report", "=" * 32]
    for r in rows:
        lines.append(
            f"{r.tower_id}: ellipsoid {r.h_ellipsoid:.2f} m -> orthometric "
            f"{r.h_orthometric:.2f} m (N={r.n_value:.2f}, {r.method})"
        )
    if rows:
        ns = np.array([r.n_value for r in rows])
        lines.append("-" * 32)
        lines.append(
            f"N statistics: mean {ns.mean():.2f} m, min {ns.min():.2f}, max {ns.max():.2f}"
        )
        if np.abs(ns).mean() < 0.01:
            lines.append("WARNING: mean N ~ 0 — geoid grid not in effect")
    report = "\n".join(lines)
    if text_path:
        with open(text_path, "w", encoding="utf-8") as f:
            f.write(report + "\n")
    if chart_path and rows:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            ids = [r.tower_id for r in rows]
            x = np.arange(len(rows))
            fig, ax = plt.subplots(figsize=(max(6, len(rows)), 4))
            ax.bar(x - 0.2, [r.h_ellipsoid for r in rows], 0.4, label="ellipsoid")
            ax.bar(x + 0.2, [r.h_orthometric for r in rows], 0.4, label="orthometric")
            ax.set_xticks(x, ids)
            ax.set_ylabel("height (m)")
            ax.legend()
            fig.tight_layout()
            fig.savefig(chart_path, dpi=100)
            plt.close(fig)
        except Exception:  # the chart is best-effort decoration
            pass
    return report
