"""Geoid grid loaders (.gtx / .npz) and the grid-in-effect check.

Copy of ``pointcloudhookup_tpu/io/geoid.py``: a NOAA/PROJ .gtx grid or a
simulated-EGM2008-style .npz (lat[nlat], lon[nlon], geoid[nlat, nlon])
loads into the port's ``ops.geo.GeoidGrid``, and ``check_grid_effective``
flags a grid whose mean |N| is near zero (not in effect).  Grids are local
files: nothing is downloaded.
"""

from __future__ import annotations

import struct

import numpy as np

from pointcloudhookup_tpu_torch.ops.geo import GeoidGrid


def load_gtx(path: str) -> GeoidGrid:
    """NOAA/PROJ .gtx vertical grid: header = 4 big-endian f64 (ll_lat,
    ll_lon, delta_lat, delta_lon) + 2 big-endian i32 (nrows, ncols),
    then nrows*ncols big-endian f32 values, south-to-north rows."""
    with open(path, "rb") as f:
        header = f.read(40)
        lat0, lon0, dlat, dlon = struct.unpack(">4d", header[:32])
        nrows, ncols = struct.unpack(">2i", header[32:40])
        data = np.frombuffer(f.read(nrows * ncols * 4), ">f4").reshape(nrows, ncols)
    return GeoidGrid(
        lat0=lat0, lon0=lon0, dlat=dlat, dlon=dlon,
        values=np.asarray(data, np.float32),
    )


def save_gtx(grid: GeoidGrid, path: str) -> None:
    vals = np.asarray(grid.values, ">f4")
    with open(path, "wb") as f:
        f.write(struct.pack(">4d", grid.lat0, grid.lon0, grid.dlat, grid.dlon))
        f.write(struct.pack(">2i", vals.shape[0], vals.shape[1]))
        f.write(vals.tobytes())


def load_npz(path: str) -> GeoidGrid:
    """Simulated-EGM2008-style .npz with arrays lat[nlat], lon[nlon],
    geoid[nlat, nlon] (uniform spacing assumed)."""
    z = np.load(path)
    lat, lon, geoid = z["lat"], z["lon"], z["geoid"]
    return GeoidGrid(
        lat0=float(lat[0]),
        lon0=float(lon[0]),
        dlat=float(lat[1] - lat[0]),
        dlon=float(lon[1] - lon[0]),
        values=np.asarray(geoid, np.float32),
    )


def load_geoid(path: str) -> GeoidGrid:
    if path.endswith(".gtx"):
        return load_gtx(path)
    if path.endswith(".npz"):
        return load_npz(path)
    raise ValueError(f"unknown geoid grid format: {path}")


def check_grid_effective(grid: GeoidGrid, sample_points=None) -> tuple[bool, float]:
    """Mean |N| over sample points; near zero means the grid is not in
    effect.  Returns (effective, mean_abs_n)."""
    if sample_points is None:
        sample_points = [(28.2, 113.0), (28.3, 113.1), (28.4, 113.2), (28.5, 113.3)]
    ns = [float(grid.interp(lat, lon)) for lat, lon in sample_points]
    mean_abs = float(np.mean(np.abs(ns)))
    return mean_abs > 0.01, mean_abs
