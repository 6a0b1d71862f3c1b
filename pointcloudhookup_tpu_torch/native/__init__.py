"""Native (C++) host components, loaded with ctypes.

Counterpart of ``pointcloudhookup_tpu/native/__init__.py``: the LAS xyz
decoder of the tile streamer (``las_codec.cpp``: ``las_probe``,
``las_read_xyz``, ``las_read_xyz_range``) and the LAZ point codec that
``io/laz.py`` reads and writes with (``laz_codec.cpp``); beside them, the
port's own passes: the extract tile's preparation (``prepare.cpp``) and
compress's record encoder (``las_encode.cpp``).  Each compiles with g++ on
first use into ``<repo>/build/native/``, keyed by a hash of the source,
never next to the source.  Without a compiler the LAS functions return None
(the caller reads with ``io/las.py``), ``prepare_tile`` and
``encode_las_records`` return None (the caller prepares or encodes with
numpy), ``get_laz_lib`` returns None and reading or writing a .laz file
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "las_codec.cpp")
_LAZ_SRC = os.path.join(_DIR, "laz_codec.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
# x * scale + offset rounded twice, as numpy computes io/las.py's xyz()
_LAS_FLAGS = _FLAGS + ("-ffp-contract=off",)
_PREP_SRC = os.path.join(_DIR, "prepare.cpp")
# sums in row order and p - origin rounded as numpy rounds them
_PREP_FLAGS = _LAS_FLAGS + ("-pthread",)
_ENCODE_SRC = os.path.join(_DIR, "las_encode.cpp")
_lock = threading.Lock()
_libs: dict = {}  # source -> its loaded library, or None once it failed


def _library_path(src: str, flags=_FLAGS) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD, f"{stem}-{h.hexdigest()[:16]}.so")


def _build(src: str, so: str, flags=_FLAGS) -> bool:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", *flags, src, "-o", tmp],
            check=True, capture_output=True, timeout=300,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)
    return True


def _load(src: str, flags, bind) -> Optional[ctypes.CDLL]:
    """The library of ``src``, built with ``flags`` on first use and given
    its signatures by ``bind``; None when it cannot be built or loaded
    (tried once a process)."""
    with _lock:
        if src not in _libs:
            so = _library_path(src, flags)
            lib = None
            if os.path.exists(so) or _build(src, so, flags):
                try:
                    lib = ctypes.CDLL(so)
                except OSError:
                    pass
            if lib is not None:
                bind(lib)
            _libs[src] = lib
        return _libs[src]


def _bind_las(lib) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    lib.las_probe.restype = ctypes.c_longlong
    lib.las_probe.argtypes = [ctypes.c_char_p, dp, dp, ctypes.POINTER(ctypes.c_int)]
    lib.las_read_xyz.restype = ctypes.c_longlong
    lib.las_read_xyz.argtypes = [ctypes.c_char_p, dp, ctypes.c_longlong]
    lib.las_read_xyz_range.restype = ctypes.c_longlong
    lib.las_read_xyz_range.argtypes = [ctypes.c_char_p, dp, ctypes.c_longlong,
                                       ctypes.c_longlong]


def _bind_laz(lib) -> None:
    decode_args = [
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_uint,
        ctypes.POINTER(ctypes.c_ubyte),
    ]
    encode_args = [
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_uint,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong),
    ]
    # formats 0-3 (compressor 2) and the LAS 1.4 layered 6-10 (3)
    for fn, args in ((lib.laz_decode_points, decode_args),
                     (lib.laz_decode_points14, decode_args),
                     (lib.laz_encode_points, encode_args),
                     (lib.laz_encode_points14, encode_args)):
        fn.restype = ctypes.c_longlong
        fn.argtypes = args


def _bind_prepare(lib) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    lib.prep_stats.restype = None
    lib.prep_stats.argtypes = [dp, ctypes.c_longlong, dp]
    lib.prep_centre.restype = None
    lib.prep_centre.argtypes = [dp, ctypes.c_longlong, dp, ctypes.POINTER(ctypes.c_float),
                                ctypes.c_longlong, ctypes.c_int]


def _bind_encode(lib) -> None:
    dp = ctypes.POINTER(ctypes.c_double)
    lib.las_encode_rows.restype = ctypes.c_longlong
    lib.las_encode_rows.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong,
        dp, dp, dp, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_longlong, ctypes.c_int, dp,
    ]


def get_lib() -> Optional[ctypes.CDLL]:
    """The LAS xyz decoder, built on first use; None when no compiler is
    available (callers fall back to io/las.py)."""
    return _load(_SRC, _LAS_FLAGS, _bind_las)


def get_laz_lib() -> Optional[ctypes.CDLL]:
    """The LAZ point codec, built on first use; None when no compiler is
    available."""
    return _load(_LAZ_SRC, _FLAGS, _bind_laz)


def get_prepare_lib() -> Optional[ctypes.CDLL]:
    """The tile preparation passes, built on first use; None when no
    compiler is available (the caller prepares with numpy)."""
    return _load(_PREP_SRC, _PREP_FLAGS, _bind_prepare)


def get_encode_lib() -> Optional[ctypes.CDLL]:
    """Compress's LAS record encoder, built on first use; None when no
    compiler is available (the caller encodes with numpy)."""
    return _load(_ENCODE_SRC, _PREP_FLAGS, _bind_encode)


def _threads(rows: int) -> int:
    """Threads for an elementwise pass: one a million rows, at most 4."""
    return max(1, min(4, os.cpu_count() or 1, rows >> 20))


def prepare_tile(points: np.ndarray, cap: int):
    """(origin f64[3], xyz f32[cap, 3], span f64[3]) of a tile's f64 rows,
    bit-identical to numpy's ``points.mean(axis=0)``, the rows' f32
    ``points - origin`` followed by zero rows, and ``points.max(axis=0) -
    points.min(axis=0)``.  None means: prepare it with numpy.  That is the
    case without a compiler, for rows that are not a C-ordered f64 [N, 3]
    with 1 <= N <= cap (numpy sums other layouts in another order), and for
    a tile holding a NaN or an inf (its sums are not finite)."""
    n = len(points)
    if (points.dtype != np.float64 or points.ndim != 2 or points.shape[1] != 3
            or not points.flags.c_contiguous or not 0 < n <= cap):
        return None
    lib = get_prepare_lib()
    if lib is None:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    stats = np.empty(9, np.float64)
    lib.prep_stats(points.ctypes.data_as(dp), n, stats.ctypes.data_as(dp))
    if not np.isfinite(stats[:3]).all():
        return None
    origin = stats[:3] / n  # as numpy's mean divides its sum
    xyz = np.empty((cap, 3), np.float32)
    lib.prep_centre(points.ctypes.data_as(dp), n, origin.ctypes.data_as(dp),
                    xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap, _threads(cap))
    return origin, xyz, stats[6:] - stats[3:6]


def encode_las_records(rows: np.ndarray, keep: np.ndarray, origin, scales, offsets,
                       record_len: int):
    """(records u8[n * record_len], mins f64[3], maxs f64[3]) of the kept
    rows ``rows[keep]`` (C-ordered f32 [cap, 3] and bool [cap], as compress
    fetches them) at ``origin``: the point records, and the header's bounds,
    that ``make_las(rows[keep].astype(np.float64) + origin, scales, offsets,
    fmt)`` and ``write_las`` give for a format of ``record_len`` bytes, bit
    for bit.  Raises make_las's ValueError for a record beyond int32, and
    for a NaN record (which no voxel row of integer records gives, and
    make_las would write as whatever its cast gives).  None means: encode it
    with numpy, without a compiler or for a scale or an offset that is not
    finite (the header's bounds would not be numbers)."""
    cap = len(rows)
    if not (rows.dtype == np.float32 and rows.shape == (cap, 3) and rows.flags.c_contiguous
            and keep.dtype == np.bool_ and keep.shape == (cap,) and keep.flags.c_contiguous):
        raise ValueError("rows must be C-ordered f32 [cap, 3] and keep bool [cap]")
    origin, scales, offsets = (np.ascontiguousarray(a, np.float64)
                               for a in (origin, scales, offsets))
    if not np.isfinite(np.concatenate([scales, offsets])).all():
        return None
    lib = get_encode_lib()
    if lib is None:
        return None
    records = np.empty(int(np.count_nonzero(keep)) * record_len, np.uint8)
    bounds = np.zeros(6, np.float64)
    dp, bp = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_ubyte)
    got = lib.las_encode_rows(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), keep.ctypes.data_as(bp), cap,
        origin.ctypes.data_as(dp), scales.ctypes.data_as(dp), offsets.ctypes.data_as(dp),
        records.ctypes.data_as(bp), record_len, _threads(cap), bounds.ctypes.data_as(dp))
    if got < 0:
        raise ValueError("coordinates out of int32 range for given scale/offset")
    return records, bounds[:3], bounds[3:]


def las_probe(path: str):
    """(count, scales f64[3], offsets f64[3], point_format) from a LAS
    header, or None (no compiler, or not a LAS file)."""
    lib = get_lib()
    if lib is None:
        return None
    scales = (ctypes.c_double * 3)()
    offsets = (ctypes.c_double * 3)()
    fmt = ctypes.c_int()
    n = lib.las_probe(path.encode(), scales, offsets, ctypes.byref(fmt))
    if n < 0:
        return None
    return int(n), np.array(scales), np.array(offsets), fmt.value


def las_read_xyz(path: str) -> Optional[np.ndarray]:
    """World xyz f64[N, 3] of a LAS file, decoded natively; None means: read
    it with io/las.py."""
    probe = las_probe(path)
    if probe is None:
        return None
    n = probe[0]
    out = np.empty((max(n, 1), 3), np.float64)
    got = get_lib().las_read_xyz(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    if got < 0:
        return None
    return out[:got]


def las_read_xyz_range(path: str, start: int, count: int) -> Optional[np.ndarray]:
    """World xyz of points [start, start + count) of a LAS file, or None."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((max(count, 1), 3), np.float64)
    got = lib.las_read_xyz_range(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), start, count)
    if got < 0:
        return None
    return out[:got]
