"""LAZ (LASzip-compressed LAS) reading and writing.

Copy of ``pointcloudhookup_tpu/io/laz.py``: the LASzip VLR (user id
"laszip encoded", record 22204), the 8-byte chunk-table pointer at the
start of the point-data section, and LasData assembly around the native
point codec (``native/laz_codec.cpp``: ``laz_decode_points[14]`` and
``laz_encode_points[14]``).  ``write_laz`` writes the JAX package's bytes
for the same ``LasData``.

Supported:
  * point formats 0-3 (POINT10 + GPSTIME11 + RGB12, item v2,
    compressor 2 = chunked, coder 0 = arithmetic);
  * LAS 1.4 native point formats 6-10 (POINT14 + RGB14 / RGBNIR14 /
    WAVEPACKET14, item v3, compressor 3 = layered chunked);
  * fixed AND variable-size chunks (chunk_size 0xFFFFFFFF: per-chunk
    point counts come from the chunk table);
  * the chunk-table-offset -1 layout (non-seekable writers append the
    table and park its position in the final 8 bytes of the section).
"""

from __future__ import annotations

import ctypes
import os
import struct
import tempfile

import numpy as np

from pointcloudhookup_tpu_torch.io.las import POINT_DTYPES, LasData, write_las

LASZIP_USER_ID = b"laszip encoded\x00\x00"
LASZIP_RECORD_ID = 22204
DEFAULT_CHUNK_SIZE = 50000

_ITEM_POINT10 = 6
_ITEM_GPSTIME11 = 7
_ITEM_RGB12 = 8
_ITEM_POINT14 = 10
_ITEM_RGB14 = 11
_ITEM_RGBNIR14 = 12
_ITEM_WAVEPACKET14 = 13

_FMT_ITEMS = {
    0: [(_ITEM_POINT10, 20)],
    1: [(_ITEM_POINT10, 20), (_ITEM_GPSTIME11, 8)],
    2: [(_ITEM_POINT10, 20), (_ITEM_RGB12, 6)],
    3: [(_ITEM_POINT10, 20), (_ITEM_GPSTIME11, 8), (_ITEM_RGB12, 6)],
    6: [(_ITEM_POINT14, 30)],
    7: [(_ITEM_POINT14, 30), (_ITEM_RGB14, 6)],
    8: [(_ITEM_POINT14, 30), (_ITEM_RGBNIR14, 8)],
    9: [(_ITEM_POINT14, 30), (_ITEM_WAVEPACKET14, 29)],
    10: [(_ITEM_POINT14, 30), (_ITEM_RGBNIR14, 8), (_ITEM_WAVEPACKET14, 29)],
}


def _fmt_item_version(fmt: int) -> int:
    return 3 if fmt >= 6 else 2


def _fmt_compressor(fmt: int) -> int:
    return 3 if fmt >= 6 else 2  # 2 = chunked, 3 = layered chunked


def _codec():
    from pointcloudhookup_tpu_torch.native import get_laz_lib

    lib = get_laz_lib()
    if lib is None:
        raise RuntimeError(
            "LAZ support needs the native codec (g++ unavailable?); "
            "decompress the file externally or install a compiler"
        )
    return lib


def build_laszip_vlr(point_format: int, chunk_size: int = DEFAULT_CHUNK_SIZE) -> bytes:
    """The LASzip VLR (54-byte header + record payload)."""
    items = _FMT_ITEMS[point_format]
    ver = _fmt_item_version(point_format)
    payload = struct.pack(
        "<HHBBHIIqqH",
        _fmt_compressor(point_format),  # 2 chunked / 3 layered chunked
        0,  # coder: arithmetic
        3 if ver == 3 else 2,  # version major
        4,  # version minor
        0,  # revision
        0,  # options
        chunk_size,
        -1,  # number of special evlrs
        -1,  # offset of special evlrs
        len(items),
    )
    for typ, size in items:
        payload += struct.pack("<HHH", typ, size, ver)
    # the JAX package's writer names itself in the description field; the
    # same bytes keep the two packages' .laz files identical
    header = struct.pack("<H16sHH32s", 0, LASZIP_USER_ID, LASZIP_RECORD_ID,
                         len(payload), b"pointcloudhookup_tpu laz")
    return header + payload


def _is_laszip_vlr(user_id: bytes, record_id: int) -> bool:
    return user_id.rstrip(b"\x00") == b"laszip encoded" and record_id == LASZIP_RECORD_ID


def parse_laszip_vlr(vlr_bytes: bytes):
    """Find + parse the LASzip VLR; returns dict or None."""
    pos = 0
    n = len(vlr_bytes)
    while pos + 54 <= n:
        user_id, record_id, length = struct.unpack_from("<16sHH", vlr_bytes, pos + 2)
        body = vlr_bytes[pos + 54 : pos + 54 + length]
        if _is_laszip_vlr(user_id, record_id):
            (compressor, coder, vmaj, vmin, rev, _options, chunk_size, _evlrs,
             _evlr_off, num_items) = struct.unpack_from("<HHBBHIIqqH", body, 0)
            items = [
                struct.unpack_from("<HHH", body, 34 + 6 * i) for i in range(num_items)
            ]
            return dict(
                compressor=compressor,
                coder=coder,
                version=(vmaj, vmin, rev),
                chunk_size=chunk_size,
                items=items,
            )
        pos += 54 + length
    return None


def strip_laszip_vlr(vlr_bytes: bytes) -> tuple[bytes, int]:
    """Remove the LASzip VLR; returns (rest, n_removed)."""
    out = b""
    removed = 0
    pos = 0
    n = len(vlr_bytes)
    while pos + 54 <= n:
        user_id, record_id, length = struct.unpack_from("<16sHH", vlr_bytes, pos + 2)
        rec = vlr_bytes[pos : pos + 54 + length]
        if _is_laszip_vlr(user_id, record_id):
            removed += 1
        else:
            out += rec
        pos += 54 + length
    return out, removed


def decode_point_section(
    data: bytes,
    point_offset: int,
    count: int,
    fmt: int,
    record_len: int,
    chunk_size: int,
    section_end: int | None = None,
) -> np.ndarray:
    """Decode the LAZ point-data section of a raw .laz file image into
    raw little-endian point records u8[count, record_len].

    ``section_end`` bounds the point-data section (start of the first
    EVLR, or EOF); it resolves the chunk-table-offset -1 layout, where a
    non-seekable writer appends the chunk table and stores its absolute
    position in the section's final 8 bytes."""
    lib = _codec()
    if section_end is None:
        section_end = len(data)
    table_abs = struct.unpack_from("<q", data, point_offset)[0]
    if table_abs == -1:
        if section_end - 8 < point_offset + 8:
            raise ValueError("LAZ: truncated section with chunk table offset -1")
        table_abs = struct.unpack_from("<q", data, section_end - 8)[0]
        # the parked-position layout ends [table][i64 position]; drop the
        # trailing pointer from the section handed to the decoder
        section_end -= 8
    if not (point_offset + 8 <= table_abs < section_end):
        raise ValueError(f"LAZ: chunk table offset {table_abs} out of bounds")
    section = np.frombuffer(data, np.uint8, section_end - point_offset - 8,
                            point_offset + 8)
    table_rel = table_abs - point_offset - 8
    out = np.empty((count, record_len), np.uint8)
    decode = lib.laz_decode_points14 if fmt >= 6 else lib.laz_decode_points
    got = decode(
        section.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        len(section),
        table_rel,
        count,
        fmt,
        chunk_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if got != count:
        raise ValueError(f"LAZ decode failed (decoded {got} of {count} points)")
    return out


def encode_point_section(records: np.ndarray, fmt: int,
                         chunk_size: int = DEFAULT_CHUNK_SIZE) -> tuple[bytes, int]:
    """Compress raw point records u8[n, record_len]; returns
    (section bytes WITHOUT the table-offset field, table_rel)."""
    lib = _codec()
    records = np.ascontiguousarray(records, np.uint8)
    n, record_len = records.shape
    encode = lib.laz_encode_points14 if fmt >= 6 else lib.laz_encode_points
    table_rel = ctypes.c_longlong()

    def run(cap):
        out = np.empty(cap, np.uint8)
        size = encode(
            records.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), n, fmt, chunk_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), cap, ctypes.byref(table_rel),
        )
        return out, size

    out, size = run(int(n * record_len + (n // chunk_size + 2) * 128 + 4096))
    if size == -2:
        # pathological expansion: retry with the worst-case cap
        out, size = run(int(n * record_len * 3 + (n // chunk_size + 2) * 128 + 65536))
    if size < 0:
        raise ValueError(f"LAZ encode failed (rc={size})")
    return out[:size].tobytes(), int(table_rel.value)


def write_laz(las: LasData, path, chunk_size: int = DEFAULT_CHUNK_SIZE) -> None:
    """Write a LasData as .laz (formats 0-3 chunked v2; 6-10 layered v3):
    the uncompressed image's header with the format's 0x80 bit set, its
    VLRs plus the LASzip VLR, then [table offset i64][chunks][table]."""
    fmt = las.point_format
    if fmt not in _FMT_ITEMS:
        raise ValueError(f"LAZ write supports point formats 0-3 and 6-10, got {fmt}")
    fd, tmp = tempfile.mkstemp(suffix=".las")
    os.close(fd)
    try:
        write_las(las, tmp)
        with open(tmp, "rb") as f:
            img = f.read()
    finally:
        os.unlink(tmp)
    header_size, point_offset, num_vlrs = struct.unpack_from("<HII", img, 94)
    record_len = struct.unpack_from("<H", img, 105)[0]
    vlr = build_laszip_vlr(fmt, chunk_size)
    records = np.frombuffer(
        img, np.uint8, len(las.points) * record_len, point_offset
    ).reshape(len(las.points), record_len)
    section, table_rel = encode_point_section(records, fmt, chunk_size)

    header = bytearray(img[:header_size])
    header[104] = fmt | 0x80
    new_point_offset = point_offset + len(vlr)
    struct.pack_into("<HII", header, 94, header_size, new_point_offset, num_vlrs + 1)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(img[header_size:point_offset])  # existing VLRs
        f.write(vlr)
        f.write(struct.pack("<q", new_point_offset + 8 + table_rel))
        f.write(section)


def read_laz_bytes(data: bytes, path_for_err: str = "<bytes>") -> LasData:
    """Parse a raw .laz file image into LasData (decompressing points)."""
    if len(data) < 227 or data[:4] != b"LASF":
        raise ValueError(
            f"LAZ: not a LAS/LAZ image (need a >=227-byte LASF header), "
            f"got {len(data)} bytes in {path_for_err!r}"
        )
    ver = (data[24], data[25])
    if ver >= (1, 4) and len(data) < 375:
        raise ValueError(
            f"LAZ: truncated LAS 1.4 header ({len(data)} bytes) in "
            f"{path_for_err!r}"
        )
    header_size, point_offset, num_vlrs = struct.unpack_from("<HII", data, 94)
    if header_size > len(data) or point_offset > len(data) \
            or point_offset < header_size:
        raise ValueError(
            f"LAZ: header/point offsets out of bounds in {path_for_err!r}"
        )
    fmt = data[104] & 0x3F
    if fmt not in _FMT_ITEMS:
        raise ValueError(f"LAZ: unsupported point format {fmt} in {path_for_err!r}")
    record_len = struct.unpack_from("<H", data, 105)[0]
    count = struct.unpack_from("<I", data, 107)[0]
    if ver >= (1, 4):
        count64 = struct.unpack_from("<Q", data, 247)[0]
        if count64:
            count = count64
    scales = np.frombuffer(data, "<f8", 3, 131).copy()
    offsets = np.frombuffer(data, "<f8", 3, 155).copy()
    vlr_bytes = data[header_size:point_offset]
    info = parse_laszip_vlr(vlr_bytes)
    if info is None:
        raise ValueError(f"LAZ file without LASzip VLR: {path_for_err!r}")
    want_compressor = _fmt_compressor(fmt)
    if info["compressor"] != want_compressor or info["coder"] != 0:
        raise ValueError(
            f"unsupported LAZ compressor/coder {info['compressor']}/"
            f"{info['coder']} for point format {fmt} (expected "
            f"{want_compressor}/0)"
        )
    # the native decoder writes rows at ITS layout stride for `fmt` and
    # assumes exactly the standard item list: validate both against the
    # file before handing it a buffer (a mismatched record_len would
    # corrupt memory or desync the arithmetic decode)
    want_items = _FMT_ITEMS[fmt]
    want_len = sum(size for _, size in want_items)
    got_items = [(typ, size) for typ, size, _ver in info["items"]]
    if got_items != want_items:
        raise ValueError(
            f"unsupported LAZ item layout {got_items} for point format "
            f"{fmt} in {path_for_err!r} (extra-bytes/custom items are not "
            f"supported; expected {want_items})"
        )
    want_ver = _fmt_item_version(fmt)
    bad_ver = [v for _, _, v in info["items"] if v != want_ver]
    if bad_ver:
        raise ValueError(
            f"unsupported LAZ item version(s) {bad_ver} in {path_for_err!r} "
            f"(point format {fmt} uses version-{want_ver} items)"
        )
    if record_len != want_len:
        raise ValueError(
            f"LAZ record_len {record_len} does not match point format "
            f"{fmt}'s layout ({want_len} bytes) in {path_for_err!r}; "
            f"extra per-point bytes are not supported"
        )
    # the point section ends at the first EVLR (LAS 1.4) or EOF; needed
    # for the chunk-table-offset -1 layout
    section_end = len(data)
    if ver >= (1, 4):
        evlr_start = struct.unpack_from("<Q", data, 235)[0]
        if 0 < evlr_start <= len(data):
            section_end = evlr_start
    raw = decode_point_section(
        data, point_offset, count, fmt, record_len, info["chunk_size"],
        section_end=section_end,
    )
    dtype = POINT_DTYPES[fmt]
    points = (
        np.ascontiguousarray(raw[:, : dtype.itemsize]).view(dtype).reshape(count)
    )
    rest_vlrs, removed = strip_laszip_vlr(vlr_bytes)
    return LasData(
        points=points.copy(),
        scales=scales,
        offsets=offsets,
        point_format=fmt,
        version=ver,
        vlr_bytes=rest_vlrs,
        num_vlrs=max(num_vlrs - removed, 0),
    )
