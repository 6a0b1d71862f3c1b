"""Native (C++) host components, loaded with ctypes.

Counterpart of ``pointcloudhookup_tpu/native/__init__.py``: the LAS xyz
decoder of the tile streamer (``las_codec.cpp``: ``las_probe``,
``las_read_xyz``, ``las_read_xyz_range``) and the LAZ point codec that
``io/laz.py`` reads and writes with (``laz_codec.cpp``).  Each compiles
with g++ on first use into ``<repo>/build/native/``, keyed by a hash of the
source, never next to the source.  Without a compiler the LAS functions
return None (the caller reads with ``io/las.py``), ``get_laz_lib`` returns
None and reading or writing a .laz file raises.
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
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_laz_lib: Optional[ctypes.CDLL] = None
_laz_tried = False


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


def get_lib() -> Optional[ctypes.CDLL]:
    """The LAS xyz decoder, built on first use; None when no compiler is
    available (callers fall back to io/las.py)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _library_path(_SRC, _LAS_FLAGS)
        if not os.path.exists(so) and not _build(_SRC, so, _LAS_FLAGS):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        lib.las_probe.restype = ctypes.c_longlong
        lib.las_probe.argtypes = [ctypes.c_char_p, dp, dp, ctypes.POINTER(ctypes.c_int)]
        lib.las_read_xyz.restype = ctypes.c_longlong
        lib.las_read_xyz.argtypes = [ctypes.c_char_p, dp, ctypes.c_longlong]
        lib.las_read_xyz_range.restype = ctypes.c_longlong
        lib.las_read_xyz_range.argtypes = [ctypes.c_char_p, dp, ctypes.c_longlong,
                                           ctypes.c_longlong]
        _lib = lib
        return _lib


def get_laz_lib() -> Optional[ctypes.CDLL]:
    """The LAZ point codec, built on first use; None when no compiler is
    available."""
    global _laz_lib, _laz_tried
    with _lock:
        if _laz_lib is not None or _laz_tried:
            return _laz_lib
        _laz_tried = True
        so = _library_path(_LAZ_SRC)
        if not os.path.exists(so) and not _build(_LAZ_SRC, so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
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
        _laz_lib = lib
        return _laz_lib


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
