"""The port's LAZ writer (``io/laz.py::write_laz`` over the native encoder,
``native/laz_codec.cpp``) against the JAX package's: the same .laz bytes
for the same LasData in point formats 0-3 and 6-10, at the default chunk
size and at a small one, and the port's reader gives the records back."""

import numpy as np
import pytest

from pointcloudhookup_tpu.io import las as jlas
from pointcloudhookup_tpu.io import laz as jlaz
from pointcloudhookup_tpu_torch.io import laz
from pointcloudhookup_tpu_torch.io.las import POINT_DTYPES, LasData, read_las

FORMATS = [0, 1, 2, 3, 6, 7, 8, 9, 10]


def _records(fmt: int, n: int, seed: int) -> np.ndarray:
    """Point records with every field filled: random bytes, coordinates a
    random walk (so the coder sees realistic deltas), sorted GPS times."""
    rng = np.random.default_rng(seed)
    dtype = POINT_DTYPES[fmt]
    pts = rng.integers(0, 256, n * dtype.itemsize, dtype=np.uint8).view(dtype).copy()
    for axis in "XYZ":
        pts[axis] = np.cumsum(rng.integers(-300, 301, n)).astype(np.int32)
    if "gps_time" in dtype.names:
        pts["gps_time"] = np.sort(rng.uniform(3e5, 3e5 + 600, n))
    return pts


def _las(fmt: int, n: int, seed: int) -> LasData:
    return LasData(points=_records(fmt, n, seed), scales=np.array([0.001, 0.001, 0.001]),
                   offsets=np.array([4.3e5, 3.1e6, 0.0]), point_format=fmt,
                   version=(1, 4) if fmt >= 6 else (1, 2))


@pytest.mark.parametrize("chunk_size", [laz.DEFAULT_CHUNK_SIZE, 997])
@pytest.mark.parametrize("fmt", FORMATS)
def test_laz_bytes_equal_jax(tmp_path, fmt, chunk_size):
    las = _las(fmt, 6000, seed=fmt)
    mine, theirs = tmp_path / "t.laz", tmp_path / "j.laz"
    laz.write_laz(las, str(mine), chunk_size=chunk_size)
    jlaz.write_laz(jlas.LasData(**vars(las)), str(theirs), chunk_size=chunk_size)
    assert mine.read_bytes() == theirs.read_bytes()
    back = read_las(str(mine))
    assert back.point_format == fmt and back.points.tobytes() == las.points.tobytes()
    assert np.array_equal(back.scales, las.scales) and np.array_equal(back.offsets, las.offsets)


@pytest.mark.parametrize("fmt", FORMATS)
def test_laszip_vlr_and_section_equal_jax(fmt):
    for chunk in (laz.DEFAULT_CHUNK_SIZE, 1, 4096):
        assert laz.build_laszip_vlr(fmt, chunk) == jlaz.build_laszip_vlr(fmt, chunk)
    info = laz.parse_laszip_vlr(laz.build_laszip_vlr(fmt, 777))
    assert info["chunk_size"] == 777 and info["compressor"] == (3 if fmt >= 6 else 2)
    rec = _records(fmt, 2500, seed=20 + fmt)
    raw = np.frombuffer(rec.tobytes(), np.uint8).reshape(len(rec), -1)
    assert laz.encode_point_section(raw, fmt, 500) == jlaz.encode_point_section(raw, fmt, 500)


def test_laz_keeps_vlrs_and_rejects_other_formats(tmp_path):
    """Existing VLRs ride along before the LASzip VLR (the reader strips only
    that one), as in the JAX package; a format without a LAZ layout raises."""
    las = _las(1, 3000, seed=30)
    vlr = (b"\x00\x00" + b"pch_test".ljust(16, b"\x00") + (7).to_bytes(2, "little")
           + (4).to_bytes(2, "little") + b"desc".ljust(32, b"\x00") + b"abcd")
    las.vlr_bytes, las.num_vlrs = vlr, 1
    mine, theirs = tmp_path / "t.laz", tmp_path / "j.laz"
    laz.write_laz(las, str(mine))
    jlaz.write_laz(jlas.LasData(**vars(las)), str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    back = read_las(str(mine))
    assert back.vlr_bytes == vlr and back.num_vlrs == 1
    bad = LasData(points=np.zeros(3, POINT_DTYPES[0]), scales=np.ones(3) * 0.01,
                  offsets=np.zeros(3), point_format=4)
    with pytest.raises(ValueError, match="formats 0-3 and 6-10"):
        laz.write_laz(bad, str(tmp_path / "bad.laz"))
