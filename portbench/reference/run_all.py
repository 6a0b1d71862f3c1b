"""Plain NumPy reference of the run-all workflow on one tile.

The upstream tool's workflow (compress -> extract -> import GIM -> correct
-> save) with the semantics the repository's JAX package fixes:

  1. compress: the tile centred on its float64 mean in float32; voxel
     index floor((p - min) / voxel_size) (a float32 division), one row a
     voxel in (kx, ky, kz) order at the voxel's centroid, moved back by the
     mean and written at the source file's scales and offsets;
  2. extract: ``exact.py`` on the downsampled tile as read back;
  3. correct: each accepted tower's centre to longitude and latitude
     (EPSG:4547, ``geo.py``: Snyder's series, written apart from the
     program's) and to orthometric height (ellipsoidal minus the regional
     N, 25 m); each GIM tower in order takes the first tower within 50 m
     (haversine) and 100 m of height; its BLHA line becomes the tower's
     lat, lng (6 decimals), height (3) and the GIM's rotation; the other
     GIM towers keep theirs.

Imports nothing of the program.  ``lower="bfloat16"``: the control, the
centred coordinates of both the compress and the extraction in bfloat16.
"""

from __future__ import annotations

import numpy as np

from portbench import geo, lasio
from portbench.reference import exact

f32 = np.float32


def compress(points, scales, offsets, voxel_size: float, lower=None) -> np.ndarray:
    """World coordinates of the downsampled tile as its LAS stores them."""
    origin = points.mean(axis=0)
    xyz = (points - origin).astype(f32)
    if lower == "bfloat16":
        xyz = exact.to_bfloat16(xyz)
    k = np.floor((xyz - xyz.min(axis=0)) / f32(voxel_size)).astype(np.int64)
    order = np.lexsort((k[:, 2], k[:, 1], k[:, 0]))
    ks = k[order]
    start = np.r_[True, (ks[1:] != ks[:-1]).any(axis=1)]
    first = np.flatnonzero(start)
    sums = np.add.reduceat(xyz[order].astype(np.float64), first, axis=0)
    counts = np.diff(np.r_[first, len(order)])
    cent = (sums / counts[:, None]).astype(f32).astype(np.float64) + origin
    rec = np.round((cent - offsets) / scales)
    return rec * scales + offsets


def correct(towers: dict, gim_towers, region_n: float = 25.0, distance: float = 50.0,
            height: float = 100.0) -> dict:
    """{GIM tower id: (lat, lng, h, r)} after the correction, as written."""
    ids = sorted(i for i in towers if towers[i]["accepted"])
    cen = np.array([towers[i]["center"] for i in ids]).reshape(-1, 3)
    lon, lat = geo.tm_inverse(cen[:, 0], cen[:, 1])
    h = cen[:, 2] - region_n
    out = {}
    for g in gim_towers:
        row = (g["lat"], g["lng"], g["h"], g["r"])
        if len(ids):
            ok = (geo.haversine_m(g["lat"], g["lng"], lat, lon) <= distance) & (
                np.abs(g["h"] - h) <= height)
            if ok.any():
                j = int(np.argmax(ok))
                row = (lat[j], lon[j], h[j], g["r"])
        out[g["id"]] = tuple(float(f"{v:.{d}f}") for v, d in zip(row, (6, 6, 3, 3)))
    return out


def run(inputs: dict, config: dict, lower: str | None = None) -> dict:
    points, scales, offsets = lasio.read_las_frame(inputs["path"])
    ds = compress(points, scales, offsets, config["compress"]["voxel_size"], lower)
    ref = exact.extract(ds, config["params"], lower)
    towers = {i: dict(accepted=bool(ref["accepted"][i]), center=ref["center"][i])
              for i in range(len(ref["accepted"]))}
    ref["ds"] = ds
    ref["blha"] = correct(towers, inputs["gim_towers"])
    return ref
