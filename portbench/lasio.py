"""A minimal LAS 1.2 writer and reader (point format 0), frozen for the
benchmark.

The writer is a trimmed copy of ``pointcloudhookup_tpu_torch/io/las.py``
(``make_las`` :178-207 and ``write_las`` :210-254): records are
``round((xyz - offset) / scale)`` with the offset ``floor(min)``.  The
reader gives the world coordinates ``record * scale + offset`` in float64,
as the LAS specification defines them; the plain reference reads the tiles
with it, never with the program's reader.
"""

from __future__ import annotations

import struct

import numpy as np

HEADER_SIZE = 227
POINT_DTYPE = np.dtype([
    ("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"), ("flags", "u1"),
    ("classification", "u1"), ("scan_angle", "i1"), ("user_data", "u1"),
    ("point_source_id", "<u2"),
])


def write_las(path: str, xyz: np.ndarray, scale: float) -> None:
    """Write world coordinates f64[N, 3] as a LAS 1.2 file of point format
    0 at one scale on every axis."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    scales = np.full(3, float(scale))
    offsets = np.floor(xyz.min(axis=0)) if len(xyz) else np.zeros(3)
    rec = np.round((xyz - offsets) / scales)
    if np.any(np.abs(rec) > 2**31 - 1):
        raise ValueError("coordinates out of int32 range for the given scale")
    points = np.zeros(len(xyz), POINT_DTYPE)
    for a, key in enumerate("XYZ"):
        points[key] = rec[:, a].astype(np.int64)
    world = points_xyz(points, scales, offsets)
    mins = world.min(axis=0) if len(xyz) else np.zeros(3)
    maxs = world.max(axis=0) if len(xyz) else np.zeros(3)
    buf = bytearray(HEADER_SIZE)
    buf[0:4] = b"LASF"
    buf[24], buf[25] = 1, 2
    buf[26:58] = b"portbench".ljust(32, b"\x00")
    buf[58:90] = b"portbench".ljust(32, b"\x00")
    struct.pack_into("<HH", buf, 90, 1, 2026)
    struct.pack_into("<HIIBHI", buf, 94, HEADER_SIZE, HEADER_SIZE, 0, 0,
                     POINT_DTYPE.itemsize, len(points))
    struct.pack_into("<5I", buf, 111, len(points), 0, 0, 0, 0)
    struct.pack_into("<3d", buf, 131, *scales)
    struct.pack_into("<3d", buf, 155, *offsets)
    struct.pack_into("<6d", buf, 179, maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2])
    with open(path, "wb") as f:
        f.write(bytes(buf))
        f.write(points.tobytes())


def points_xyz(points, scales, offsets) -> np.ndarray:
    """World coordinates f64[N, 3] of point records."""
    return np.column_stack([points[k] * scales[a] + offsets[a] for a, k in enumerate("XYZ")])


def read_las(path: str) -> np.ndarray:
    """World coordinates f64[N, 3] of a LAS 1.2 file of point format 0."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"LASF":
        raise ValueError(f"not a LAS file: {path!r}")
    point_offset = struct.unpack_from("<I", data, 96)[0]
    fmt, record_len, count = struct.unpack_from("<BHI", data, 104)
    if fmt != 0 or record_len != POINT_DTYPE.itemsize:
        raise ValueError(f"{path!r}: point format {fmt}, record {record_len} B; expected 0, 20")
    scales = np.frombuffer(data, "<f8", 3, 131)
    offsets = np.frombuffer(data, "<f8", 3, 155)
    points = np.frombuffer(data, POINT_DTYPE, count, point_offset)
    return points_xyz(points, scales, offsets)


def read_las_frame(path: str):
    """(world coordinates f64[N, 3], scales f64[3], offsets f64[3]) of a
    LAS 1.2 file of point format 0."""
    with open(path, "rb") as f:
        head = f.read(HEADER_SIZE)
    scales = np.frombuffer(head, "<f8", 3, 131).copy()
    offsets = np.frombuffer(head, "<f8", 3, 155).copy()
    return read_las(path), scales, offsets
