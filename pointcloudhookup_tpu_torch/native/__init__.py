"""Native (C++) host components, loaded with ctypes.

Counterpart of ``pointcloudhookup_tpu/native/__init__.py``, trimmed to the
LAZ point decoder that ``io/laz.py`` needs.  ``laz_codec.cpp`` compiles
with g++ on first use into ``<repo>/build/native/``, keyed by a hash of the
source, never next to the source.  Without a compiler, ``get_laz_lib``
returns None and reading a .laz file raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_LAZ_SRC = os.path.join(_DIR, "laz_codec.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_laz_lib: Optional[ctypes.CDLL] = None
_laz_tried = False


def _library_path(src: str) -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD, f"{stem}-{h.hexdigest()[:16]}.so")


def _build(src: str, so: str) -> bool:
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", *_FLAGS, src, "-o", tmp],
            check=True, capture_output=True, timeout=300,
        )
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)
    return True


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
        # formats 0-3 (compressor 2) and the LAS 1.4 layered 6-10 (3)
        for fn in (lib.laz_decode_points, lib.laz_decode_points14):
            fn.restype = ctypes.c_longlong
            fn.argtypes = decode_args
        _laz_lib = lib
        return _laz_lib
