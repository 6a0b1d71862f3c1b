"""compress's native LAS record encoder (``native/las_encode.cpp`` through
``io/las.py::write_kept_rows``) against make_las + write_las, which write
the same file with numpy: byte for byte in every case it takes, the same
ValueError where make_las raises, and numpy's bytes wherever it declines."""

import numpy as np
import pytest

from pointcloudhookup_tpu_torch import native
from pointcloudhookup_tpu_torch.io import las as tlas
from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu_torch.models import pipeline as tpipe
from pointcloudhookup_tpu_torch.utils import trace


def _numpy_bytes(tmp_path, rows, keep, origin, scales, offsets, fmt=0, version=(1, 2)):
    path = tmp_path / "numpy.las"
    out = rows[keep].astype(np.float64) + origin
    tlas.write_las(tlas.make_las(out, scales=scales, offsets=offsets, point_format=fmt,
                                 version=version), str(path))
    return path.read_bytes()


def _native_bytes(tmp_path, rows, keep, origin, scales, offsets, fmt=0, version=(1, 2)):
    path = tmp_path / "native.las"
    n = tlas.write_kept_rows(str(path), rows, keep, origin, scales, offsets, fmt, version)
    assert n == np.count_nonzero(keep), "the encoder declined rows it takes"
    return path.read_bytes()


def _tile(seed, cap=5000, kept=0.8):
    rng = np.random.default_rng(seed)
    rows = rng.uniform(-400.0, 400.0, (cap, 3)).astype(np.float32)
    keep = rng.random(cap) < kept
    return rows, keep, np.array([512_345.678, 3_101_234.5, 81.25])


@pytest.mark.parametrize("version", [(1, 2), (1, 4)], ids=["v12", "v14"])
@pytest.mark.parametrize("fmt", [0, 1, 2, 6])
def test_records_and_header_match_make_las_write_las(tmp_path, fmt, version):
    """Formats 0, 1, 2 and 6 at LAS 1.2 and 1.4 (a 1.2 request with format 6
    written as 1.4 by both): the whole file is the same bytes."""
    rows, keep, origin = _tile(fmt)
    scales, offsets = np.array([0.01, 0.01, 0.005]), np.array([512_000.0, 3_101_000.0, 0.0])
    got = _native_bytes(tmp_path, rows, keep, origin, scales, offsets, fmt, version)
    assert got == _numpy_bytes(tmp_path, rows, keep, origin, scales, offsets, fmt, version)
    assert got[24:26] == bytes((1, 4) if fmt >= 6 else version) and got[104] == fmt
    las = tlas.read_las(str(tmp_path / "native.las"))
    assert len(las) == np.count_nonzero(keep)


def test_halves_round_to_even_and_negative_rows(tmp_path):
    """Scale 1, offset 0: .5 steps round half to even as np.round does,
    negative coordinates included, and decode to the header's bounds."""
    rows = np.array([[0.5, 1.5, 2.5], [-0.5, -1.5, -2.5], [3.5, -3.5, 4.5],
                     [-7.25, -1e4, -0.25]], np.float32)
    keep = np.ones(4, bool)
    origin, scales, offsets = np.zeros(3), np.ones(3), np.zeros(3)
    got = _native_bytes(tmp_path, rows, keep, origin, scales, offsets)
    assert got == _numpy_bytes(tmp_path, rows, keep, origin, scales, offsets)
    las = tlas.read_las(str(tmp_path / "native.las"))
    np.testing.assert_array_equal(
        las.xyz(), [[0, 2, 2], [-0.0, -2, -2], [4, -4, 4], [-7, -1e4, -0.0]])


def test_no_kept_rows_write_an_empty_file(tmp_path):
    """An all-False mask: zero records, zero counts and zero bounds."""
    rows, _, origin = _tile(7, cap=1024)
    keep = np.zeros(len(rows), bool)
    scales, offsets = np.full(3, 0.01), np.array([512_000.0, 3_101_000.0, 0.0])
    got = _native_bytes(tmp_path, rows, keep, origin, scales, offsets)
    assert got == _numpy_bytes(tmp_path, rows, keep, origin, scales, offsets)
    assert len(got) == 227 and got[107:111] == bytes(4) and got[179:227] == bytes(48)


@pytest.mark.parametrize("threads", [1, 2, 3, 4, 7])
def test_bytes_do_not_depend_on_the_thread_split(tmp_path, monkeypatch, threads):
    """Kept rows on both sides of every split, a run of dropped rows over
    one, and a thread with no kept row at all: the same file at any
    number of threads, the extreme rows in any part."""
    rows, keep, origin = _tile(11, cap=4099, kept=0.5)
    keep[1020:1030] = True
    keep[2040:2060] = False
    keep[3000:4099] = False
    rows[3500] = (-1e5, -1e5, -1e5)  # a dropped row never reaches the bounds
    rows[17] = (-399.0, 399.0, -399.0)
    keep[17] = True
    monkeypatch.setattr(native, "_threads", lambda rows: threads)
    scales, offsets = np.full(3, 0.001), np.array([512_000.0, 3_101_000.0, 0.0])
    got = _native_bytes(tmp_path, rows, keep, origin, scales, offsets)
    assert got == _numpy_bytes(tmp_path, rows, keep, origin, scales, offsets)


@pytest.mark.parametrize("origin_z, raises", [
    (2**31 - 1, False), (-(2**31 - 1), False), (2**31, True), (-(2**31), True),
    (np.inf, True),
])
def test_records_beyond_int32_raise_as_make_las_does(tmp_path, origin_z, raises):
    """|record| up to 2**31 - 1 is written, beyond it (an inf too) raises
    make_las's ValueError, and no file is left."""
    rows = np.zeros((4, 3), np.float32)
    keep = np.array([True, False, True, True])
    origin, scales, offsets = np.array([0.0, 0.0, float(origin_z)]), np.ones(3), np.zeros(3)
    if not raises:
        got = _native_bytes(tmp_path, rows, keep, origin, scales, offsets)
        assert got == _numpy_bytes(tmp_path, rows, keep, origin, scales, offsets)
        return
    with pytest.raises(ValueError) as ref:
        _numpy_bytes(tmp_path, rows, keep, origin, scales, offsets)
    path = tmp_path / "native.las"
    with pytest.raises(ValueError, match=str(ref.value)):
        tlas.write_kept_rows(str(path), rows, keep, origin, scales, offsets)
    assert not path.exists()


@pytest.mark.parametrize("case", ["inf-scale", "no-compiler"])
def test_the_encoder_leaves_to_numpy_what_numpy_decides(tmp_path, monkeypatch, case):
    """A scale that is not finite (bounds that are not numbers) and no
    compiler: write_kept_rows writes nothing and returns None."""
    rows, keep, origin = _tile(13, cap=256)
    scales, offsets = np.full(3, 0.01), np.array([512_000.0, 3_101_000.0, 0.0])
    if case == "inf-scale":
        scales[2] = np.inf
    else:
        monkeypatch.setattr(native, "get_encode_lib", lambda: None)
    path = tmp_path / "native.las"
    assert tlas.write_kept_rows(str(path), rows, keep, origin, scales, offsets) is None
    assert not path.exists()


@pytest.mark.parametrize("column", [0, 1, 2])
def test_a_nan_record_raises(tmp_path, column):
    """A kept NaN row, in any column, raises the ValueError and leaves no
    file; a dropped one is never read."""
    rows, keep, origin = _tile(13, cap=256)
    scales, offsets = np.full(3, 0.01), np.array([512_000.0, 3_101_000.0, 0.0])
    rows[np.flatnonzero(~keep)[0]] = np.nan
    dropped = tmp_path / "dropped.las"
    assert tlas.write_kept_rows(str(dropped), rows, keep, origin, scales, offsets) == keep.sum()
    rows[np.flatnonzero(keep)[3], column] = np.nan
    path = tmp_path / "native.las"
    with pytest.raises(ValueError, match="out of int32 range"):
        tlas.write_kept_rows(str(path), rows, keep, origin, scales, offsets)
    assert not path.exists()


@pytest.mark.parametrize("per_chunk", [False, True], ids=["global", "per_chunk"])
def test_compress_writes_the_same_bytes_with_and_without_the_encoder(tmp_path, monkeypatch,
                                                                     per_chunk):
    """compress() writes the same file whether the native encoder writes it
    (counted once as compress.write.native) or make_las + write_las do (no
    library: counted never), the source's format and version carried."""
    pts, _ = synthetic_corridor(np.random.default_rng(17), n_ground=3000, n_veg=400,
                                pts_per_tower=300, extent=150.0,
                                origin=(512_000.0, 3_101_000.0, 80.0))
    src = str(tmp_path / "in.las")
    tlas.write_las(tlas.make_las(pts, scales=[0.01, 0.01, 0.005], point_format=1,
                                 version=(1, 3)), src)
    runs = []
    for lib in ("native", None):
        if lib is None:
            monkeypatch.setattr(native, "get_encode_lib", lambda: None)
        before = trace.counter("compress.write.native")
        out = tmp_path / f"out_{lib}.las"
        n = tpipe.compress(src, str(out), voxel_size=0.5, chunk_size=1024,
                           per_chunk=per_chunk, device="cpu")
        assert trace.counter("compress.write.native") - before == (lib is not None)
        runs.append((n, out.read_bytes()))
    assert runs[0] == runs[1] and 0 < runs[0][0] < len(pts)
    assert runs[0][1][24:26] == bytes((1, 3)) and runs[0][1][104] == 1
