"""LAS point-cloud reader/writer (pure numpy, no laspy dependency).

Copy of ``pointcloudhookup_tpu/io/las.py`` (``LasData``, ``read_las``,
``write_las``, ``make_las``, ``peek_point_count``), so that the PyTorch port
imports nothing of the JAX package.  LAS 1.2-1.4, point record formats 0-3
and 6-10.  Scaled-integer semantics match laspy and the LAS spec: world =
record * scale + offset; scales and offsets round-trip.  LAZ files route
through ``io/laz.py`` and the native LASzip decoder in ``read_las``.  Unlike
the copy, ``read_las`` leaves an uncompressed file's records on disk until
they are used, so that ``read_las(path).xyz()`` is one native pass from the
file to f64 rows, and ``write_kept_rows`` writes compress's output from the
f32 voxel rows in one native pass, with the header ``write_las`` packs.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Optional

import numpy as np

from pointcloudhookup_tpu_torch import native
from pointcloudhookup_tpu_torch.utils import trace

_SIGNATURE = b"LASF"

# point-record numpy dtypes (little-endian) per format id
_COMMON0 = [
    ("X", "<i4"),
    ("Y", "<i4"),
    ("Z", "<i4"),
    ("intensity", "<u2"),
    ("flags", "u1"),
    ("classification", "u1"),
    ("scan_angle", "i1"),
    ("user_data", "u1"),
    ("point_source_id", "<u2"),
]
_COMMON6 = [
    ("X", "<i4"),
    ("Y", "<i4"),
    ("Z", "<i4"),
    ("intensity", "<u2"),
    ("return_info", "u1"),
    ("flags", "u1"),
    ("classification", "u1"),
    ("user_data", "u1"),
    ("scan_angle", "<i2"),
    ("point_source_id", "<u2"),
    ("gps_time", "<f8"),
]
_RGB = [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
_WAVE = [
    ("wave_descriptor", "u1"),
    ("wave_offset", "<u8"),
    ("wave_size", "<u4"),
    ("wave_return_point", "<f4"),
    ("wave_xt", "<f4"),
    ("wave_yt", "<f4"),
    ("wave_zt", "<f4"),
]

POINT_DTYPES = {
    0: np.dtype(_COMMON0),
    1: np.dtype(_COMMON0 + [("gps_time", "<f8")]),
    2: np.dtype(_COMMON0 + _RGB),
    3: np.dtype(_COMMON0 + [("gps_time", "<f8")] + _RGB),
    6: np.dtype(_COMMON6),
    7: np.dtype(_COMMON6 + _RGB),
    8: np.dtype(_COMMON6 + _RGB + [("nir", "<u2")]),
    9: np.dtype(_COMMON6 + _WAVE),
    10: np.dtype(_COMMON6 + _RGB + [("nir", "<u2")] + _WAVE),
}

_HEADER_SIZES = {(1, 2): 227, (1, 3): 235, (1, 4): 375}


@dataclasses.dataclass
class LasData:
    """In-memory LAS file: world-coordinate points + raw attributes."""

    points: np.ndarray  # structured array (POINT_DTYPES[fmt])
    scales: np.ndarray  # f8[3]
    offsets: np.ndarray  # f8[3]
    point_format: int = 0
    version: tuple[int, int] = (1, 2)
    vlr_bytes: bytes = b""
    num_vlrs: int = 0

    @property
    def x(self) -> np.ndarray:
        return self.points["X"] * self.scales[0] + self.offsets[0]

    @property
    def y(self) -> np.ndarray:
        return self.points["Y"] * self.scales[1] + self.offsets[1]

    @property
    def z(self) -> np.ndarray:
        return self.points["Z"] * self.scales[2] + self.offsets[2]

    def xyz(self) -> np.ndarray:
        """World coordinates f64[N,3]."""
        return np.column_stack([self.x, self.y, self.z])

    def __len__(self) -> int:
        return len(self.points)


def peek_point_count(path) -> int:
    """Point count from the LAS/LAZ header alone (no point decode)."""
    with open(path, "rb") as f:
        data = f.read(375)
    if data[:4] != _SIGNATURE:
        raise ValueError(f"not a LAS file (bad signature): {path!r}")
    if len(data) < 111:
        raise ValueError(f"truncated LAS header ({len(data)} bytes): {path!r}")
    ver = (data[24], data[25])
    count = struct.unpack_from("<I", data, 107)[0]
    if ver >= (1, 4) and len(data) >= 255:
        count64 = struct.unpack_from("<Q", data, 247)[0]
        if count64:
            count = count64
    return count


class _LasFile(LasData):
    """What read_las returns for an uncompressed file: its header and VLR
    block, with the records left in the file until they are asked for.
    ``points`` reads them on first use.  ``xyz()`` before that decodes the
    world coordinates from the file in one native pass
    (``native/las_codec.cpp``, counted as ``las.read.native``) where the
    decoder is built and returns every record the header counts, and from
    the records otherwise: the same bits either way."""

    def __init__(self, path: str, point_offset: int, count: int, record_len: int, **header):
        self._path, self._point_offset = path, point_offset
        self._count, self._record_len = count, record_len
        super().__init__(None, **header)

    @property
    def points(self) -> np.ndarray:
        if self._points is None:
            with open(self._path, "rb") as f:
                f.seek(self._point_offset)
                raw = np.fromfile(f, np.uint8, self._count * self._record_len)
            dtype = POINT_DTYPES[self.point_format]
            raw = raw.reshape(self._count, self._record_len)
            # records may carry extra bytes; view only the leading known fields
            self._points = np.ascontiguousarray(raw[:, : dtype.itemsize]).view(dtype).reshape(
                self._count
            )
        return self._points

    @points.setter
    def points(self, value: Optional[np.ndarray]) -> None:
        self._points = value

    def xyz(self) -> np.ndarray:
        if self._points is None:
            xyz = native.las_read_xyz(self._path)
            if xyz is not None and len(xyz) == self._count:
                trace.count("las.read.native")
                return xyz
        return super().xyz()

    def __len__(self) -> int:
        return self._count if self._points is None else len(self._points)


def read_las(path) -> LasData:
    """The LAS/LAZ file at ``path``.  Raises ValueError for a file it cannot
    read whole: a bad signature, a header or point block cut short, a point
    format it does not know, records shorter than their format.  A LAZ file
    is decoded at once; an uncompressed one keeps its records in the file
    until they are used (``_LasFile``)."""
    with trace.span("las.read"):
        with open(path, "rb") as f:
            data = f.read(375)  # the largest public header (LAS 1.4)
        if data[:4] != _SIGNATURE:
            raise ValueError(f"not a LAS file (bad signature): {path!r}")
        if len(data) < 227:
            # smallest legal header (LAS 1.2); truncated files would
            # otherwise leak struct.error from the field unpacks below
            raise ValueError(
                f"truncated LAS header ({len(data)} bytes): {path!r}"
            )
        ver = (data[24], data[25])
        if ver >= (1, 4) and len(data) < 375:
            raise ValueError(
                f"truncated LAS 1.4 header ({len(data)} bytes): {path!r}"
            )
        header_size, point_offset, num_vlrs = struct.unpack_from("<HII", data, 94)
        fmt_raw = data[104]
        if fmt_raw & 0x80:
            # LAZ: chunked-arithmetic LASzip payload (native codec)
            from pointcloudhookup_tpu_torch.io.laz import read_laz_bytes

            with open(path, "rb") as f:
                return read_laz_bytes(f.read(), str(path))
        fmt = fmt_raw & 0x3F
        if fmt not in POINT_DTYPES:
            raise ValueError(f"unsupported point format {fmt}")
        record_len = struct.unpack_from("<H", data, 105)[0]
        legacy_count = struct.unpack_from("<I", data, 107)[0]
        scales = np.frombuffer(data, "<f8", 3, 131).copy()
        offsets = np.frombuffer(data, "<f8", 3, 155).copy()
        count = legacy_count
        if ver >= (1, 4):
            count64 = struct.unpack_from("<Q", data, 247)[0]
            if count64:
                count = count64
        dtype = POINT_DTYPES[fmt]
        if record_len < dtype.itemsize:
            raise ValueError(
                f"record length {record_len} smaller than format {fmt} size {dtype.itemsize}"
            )
        if point_offset + count * record_len > os.path.getsize(path):
            raise ValueError(
                f"truncated LAS point block ({count} records of {record_len} bytes"
                f" from byte {point_offset}): {path!r}"
            )
        with open(path, "rb") as f:
            f.seek(header_size)
            vlr_bytes = f.read(max(point_offset - header_size, 0))
        return _LasFile(
            os.fsdecode(path), point_offset, count, record_len,
            scales=scales,
            offsets=offsets,
            point_format=fmt,
            version=ver,
            vlr_bytes=vlr_bytes,
            num_vlrs=num_vlrs,
        )


def make_las(
    xyz: np.ndarray,
    scales: Optional[np.ndarray] = None,
    offsets: Optional[np.ndarray] = None,
    point_format: int = 0,
    version: tuple[int, int] = (1, 2),
    vlr_bytes: bytes = b"",
    num_vlrs: int = 0,
) -> LasData:
    """Build a LasData from world coordinates f64[N,3].  Pass the source
    file's vlr_bytes/num_vlrs to carry CRS and other VLR metadata
    through derived outputs."""
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    if scales is None:
        scales = np.array([0.001, 0.001, 0.001])
    scales = np.asarray(scales, np.float64)
    if offsets is None:
        offsets = np.floor(xyz.min(axis=0)) if len(xyz) else np.zeros(3)
    offsets = np.asarray(offsets, np.float64)
    points = np.zeros(len(xyz), POINT_DTYPES[point_format])
    rec = np.round((xyz - offsets) / scales)
    if np.any(np.abs(rec) > 2**31 - 1):
        raise ValueError("coordinates out of int32 range for given scale/offset")
    points["X"] = rec[:, 0].astype(np.int64)
    points["Y"] = rec[:, 1].astype(np.int64)
    points["Z"] = rec[:, 2].astype(np.int64)
    return LasData(
        points, scales, offsets, point_format, version,
        vlr_bytes=vlr_bytes, num_vlrs=num_vlrs,
    )


def _header(point_format: int, version, n: int, scales, offsets, mins, maxs,
            num_vlrs: int = 0, vlr_len: int = 0) -> bytes:
    """The public header of a LAS file of ``n`` records: ``version``
    normalised to one this writer knows (1.4 for formats 6-10), the record
    length of ``point_format``, the point block after ``vlr_len`` bytes of
    VLRs, and the bounds ``mins`` and ``maxs`` of the decoded coordinates."""
    fmt = point_format
    ver = tuple(version)
    if ver not in _HEADER_SIZES:
        ver = (1, 4) if fmt >= 6 else (1, 2)
    if fmt >= 6 and ver < (1, 4):
        ver = (1, 4)
    header_size = _HEADER_SIZES[ver]
    point_offset = header_size + vlr_len

    buf = bytearray(header_size)
    buf[0:4] = _SIGNATURE
    struct.pack_into("<HH", buf, 4, 0, 0)  # file source id, global encoding
    buf[24] = ver[0]
    buf[25] = ver[1]
    buf[26 : 26 + 32] = b"pointcloudhookup_tpu".ljust(32, b"\x00")
    buf[58 : 58 + 32] = b"pointcloudhookup_tpu".ljust(32, b"\x00")
    struct.pack_into("<HH", buf, 90, 1, 2026)  # creation day/year
    legacy_n = n if (ver < (1, 4) or n < 2**32) else 0
    struct.pack_into(
        "<HIIBH I", buf, 94, header_size, point_offset, num_vlrs, fmt,
        POINT_DTYPES[fmt].itemsize, legacy_n
    )
    # legacy number by return (first slot = all points, like simple writers)
    struct.pack_into("<5I", buf, 111, legacy_n, 0, 0, 0, 0)
    struct.pack_into("<3d", buf, 131, *scales)
    struct.pack_into("<3d", buf, 155, *offsets)
    struct.pack_into(
        "<6d", buf, 179, maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2]
    )
    if ver >= (1, 3):
        struct.pack_into("<Q", buf, 227, 0)  # waveform offset
    if ver >= (1, 4):
        struct.pack_into("<QIQ", buf, 235, 0, 0, n)  # EVLR offset/count, count64
        struct.pack_into("<15Q", buf, 255, n, *([0] * 14))
    return bytes(buf)


def write_las(las: LasData, path) -> None:
    dtype = POINT_DTYPES[las.point_format]
    n = len(las.points)
    xyz = las.xyz()
    mins = xyz.min(axis=0) if n else np.zeros(3)
    maxs = xyz.max(axis=0) if n else np.zeros(3)
    header = _header(las.point_format, las.version, n, las.scales, las.offsets, mins, maxs,
                     las.num_vlrs, len(las.vlr_bytes))
    with open(path, "wb") as f:
        f.write(header)
        f.write(las.vlr_bytes)
        f.write(las.points.astype(dtype, copy=False).tobytes())


def write_kept_rows(path, rows: np.ndarray, keep: np.ndarray, origin, scales, offsets,
                    point_format: int = 0, version: tuple[int, int] = (1, 2)) -> Optional[int]:
    """Write the file that ``write_las(make_las(rows[keep].astype(np.float64)
    + origin, scales, offsets, point_format, version), path)`` writes, byte
    for byte, with the records encoded in one native pass over the f32
    ``rows`` and their bool ``keep`` mask (``native/las_encode.cpp``) and
    written from its buffer.  Returns the point count; raises make_las's
    ValueError for a coordinate beyond int32 (or NaN); returns None, writing
    nothing, where ``native.encode_las_records`` leaves the rows to numpy
    (no compiler, or a scale or an offset that is not finite): the caller
    writes them with make_las and write_las."""
    record_len = POINT_DTYPES[point_format].itemsize
    got = native.encode_las_records(rows, keep, origin, scales, offsets, record_len)
    if got is None:
        return None
    records, mins, maxs = got
    n = len(records) // record_len
    header = _header(point_format, version, n, scales, offsets, mins, maxs)
    with open(path, "wb") as f:
        f.write(header)
        f.write(records)
    return n
