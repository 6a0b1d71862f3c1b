"""The port's extraction pipeline: extract_from_points and its retry ladder
against the JAX package on the tests/test_exact_frontend.py workload,
extract() on a LAS file, the CLI, and tiles the exact path does not take,
which run the modular extract_step (tests/test_torch_modular.py holds
that path in every method)."""

import dataclasses

import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.config import ClusterParams, ExtractParams, GroundParams
from pointcloudhookup_tpu.io.las import make_las, write_las
from pointcloudhookup_tpu.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu.models import pipeline as jpipe
from pointcloudhookup_tpu_torch.__main__ import main as cli_main
from pointcloudhookup_tpu_torch.models import pipeline as tpipe

torch.set_num_threads(2)

CAP = 32768
PARAMS = ExtractParams(
    ground=GroundParams(min_points_after=100),
    cluster=ClusterParams(eps=5.0, min_points=30, method="grid", max_cells=4096),
    max_clusters=32,
    obb_angles=64,
)


@pytest.fixture(scope="module")
def tile():
    rng = np.random.default_rng(3)
    return synthetic_corridor(
        rng, n_ground=20_000, n_veg=4_000,
        towers=((0.0, 0.0), (160.0, 60.0), (-170.0, -80.0)),
        pts_per_tower=1_500, extent=300.0,
    )


@pytest.fixture(scope="module")
def jax_result(tile):
    """JAX extract_from_points on the tile, computed once for the module."""
    pts, _ = tile
    return jpipe.extract_from_points(pts, PARAMS, capacity=CAP)


def _assert_same_extraction(got, ref):
    np.testing.assert_array_equal(got["ground_keep"], ref["ground_keep"])
    # cell ids are deterministic on both sides: identical labels, hence
    # an identical partition
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_array_equal(got["count"], ref["count"])
    np.testing.assert_array_equal(got["accepted"], ref["accepted"])


def test_extract_from_points_matches_jax(tile, jax_result):
    pts, centers = tile
    towers, stats, origin = tpipe.extract_from_points(
        pts, PARAMS, capacity=CAP, device="cpu"
    )
    j_towers, j_stats, j_origin = jax_result
    np.testing.assert_array_equal(origin, j_origin)
    _assert_same_extraction(stats, j_stats)
    assert stats["ladder"]["floor"] == 1 and stats["ladder"]["core_cap"] == 2048
    assert len(towers) == len(j_towers) == len(centers)
    for t, jt in zip(towers, j_towers):
        assert (t.label, t.num_points) == (jt.label, jt.num_points)
        # within one angle step of the box (see test_torch_frontend_exact)
        np.testing.assert_allclose(t.center, jt.center, atol=1.0)


@pytest.mark.parametrize(
    "ladder,expect",
    [
        (dict(_core_cap0=8), lambda lad: lad["core_cap"] > 8),
        (dict(_ccap=1024), lambda lad: lad["compact_cap"] == CAP),
    ],
    ids=["core_cap-resize", "compact-retry"],
)
def test_retry_ladders_reach_the_same_result(tile, jax_result, ladder, expect):
    """A too-small core flood table is re-sized from its spill count, a
    too-small survivor capacity retries at full capacity: both end at the
    default run's result (the JAX one)."""
    pts, centers = tile
    origin = pts.mean(axis=0)
    xyz = np.zeros((CAP, 3), np.float32)
    xyz[: len(pts)] = (pts - origin).astype(np.float32)
    mask = np.zeros(CAP, bool)
    mask[: len(pts)] = True
    plan = tpipe._exact_fast_plan(pts, PARAMS, CAP)
    got = tpipe._extract_stats_exact_fast(
        xyz, mask, PARAMS, plan, device="cpu", **ladder
    )
    assert expect(got["ladder"])
    _assert_same_extraction(got, jax_result[1])
    assert int(got["accepted"].sum()) == len(centers)


def test_extract_las_file(tmp_path, corridor):
    pts, centers = corridor
    path = str(tmp_path / "corridor.las")
    write_las(make_las(pts, scales=[0.001] * 3), path)
    # auto routing with a low threshold: the 6k-point tile takes the exact
    # path exactly as the JAX package routes it
    params = ExtractParams(
        cluster=ClusterParams(eps=5.0, min_points=30, auto_grid_threshold=1000)
    )
    logs = []
    towers = tpipe.extract(
        path, params=params, device="cpu", log_callback=logs.append,
        output_dir=str(tmp_path / "towers"), excel_path=str(tmp_path / "t.xlsx"),
    )
    assert len(towers) == len(centers)
    for t in towers:
        d = np.linalg.norm(centers[:, :2] - t.center[:2], axis=1)
        assert d.min() < 2.0
        assert (tmp_path / "towers" / f"tower_{t.label}.las").exists()
    table = tmp_path / "t.xlsx"
    if not table.exists():
        table = tmp_path / "t.csv"
    assert table.exists()
    assert any("exact path: density floor 1" in line for line in logs)


def test_cli_extract(tmp_path, capsys):
    # > auto_grid_threshold points, so the CLI's defaults route the tile
    # to the exact path; mostly ground, which the percentile cut removes
    rng = np.random.default_rng(21)
    pts, centers = synthetic_corridor(
        rng, n_ground=205_000, n_veg=1_500, pts_per_tower=1_500, extent=400.0
    )
    path = str(tmp_path / "big.las")
    write_las(make_las(pts, scales=[0.001] * 3), path)
    cli_main(["extract", path, "--device", "cpu", "--cluster-method", "grid"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("tower_")]
    assert len(lines) == len(centers), out
    assert f"extraction complete: {len(centers)} towers" in out


@pytest.mark.parametrize(
    "cluster",
    [
        ClusterParams(eps=5.0, min_points=30, method="grid", max_cells=4096),
        ClusterParams(eps=5.0, min_points=30, per_chunk=True, chunk_size=4096),
        ClusterParams(eps=5.0, min_points=30, method="exact"),
    ],
    ids=["small-capacity", "per-chunk", "exact-dbscan"],
)
def test_ineligible_tile_raises(corridor, cluster):
    """Tiles the exact path does not take (a capacity below
    auto_grid_threshold, per_chunk, method "exact") run the modular
    extract_step, as in the JAX package: the same labels, keep set, counts
    and accepted towers as the JAX extract_from_points.  (The grid table
    and the chunks are cut to 4,096 to keep the JAX side's O(M^2) XLA
    passes short.)  The name is kept from when the port raised on these
    tiles: it now checks that they run, and nothing raises."""
    pts, _ = corridor
    params = ExtractParams(cluster=cluster)
    towers, stats, origin = tpipe.extract_from_points(pts, params, device="cpu")
    j_towers, j_stats, j_origin = jpipe.extract_from_points(pts, params)
    np.testing.assert_array_equal(origin, j_origin)
    _assert_same_extraction(stats, j_stats)
    assert "ladder" not in stats and "modular" in stats
    assert len(towers) == len(j_towers) == 3
    for t, jt in zip(towers, j_towers):
        assert (t.label, t.num_points) == (jt.label, jt.num_points)
        np.testing.assert_allclose(t.center, jt.center, atol=1.0)


# ------------------------------------------------- the tile's preparation
GRID = ExtractParams(cluster=ClusterParams(eps=5.0, method="grid"))


def _numpy_prepare(points, params, capacity):
    """The numpy lines extract_from_points prepared every tile with before
    the native passes; the reference for both paths of _prepare_tile."""
    points = np.asarray(points, np.float64).reshape(-1, 3)
    origin = points.mean(axis=0) if len(points) else np.zeros(3)
    if capacity is not None:
        cap = capacity
    elif params.cluster.per_chunk:
        cap = tpipe.round_up(max(len(points), 1), params.cluster.chunk_size)
    elif len(points) > params.cluster.auto_grid_threshold:
        cap = tpipe.round_up(max(len(points), 1), 32768)
    else:
        cap = tpipe.round_up(max(len(points), 1), 1024)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(points)] = (points - origin).astype(np.float32)
    mask = np.zeros(cap, bool)
    mask[: len(points)] = True
    return origin, xyz, mask, tpipe._exact_fast_plan(points, params, cap)


def _outcome(fn, *args):
    try:
        return fn(*args)
    except (ValueError, OverflowError) as err:  # a NaN or inf span's plan
        return type(err)


def _assert_bits_equal(got, ref):
    if isinstance(ref, type):
        assert got is ref
        return
    (origin, xyz, mask, plan), (r_origin, r_xyz, r_mask, r_plan) = got, ref
    assert origin.dtype == np.float64 and xyz.dtype == np.float32 and mask.dtype == bool
    assert xyz.shape == r_xyz.shape and mask.shape == r_mask.shape  # the cap
    np.testing.assert_array_equal(origin.view(np.int64), r_origin.view(np.int64))
    np.testing.assert_array_equal(xyz.view(np.int32), r_xyz.view(np.int32))
    np.testing.assert_array_equal(mask, r_mask)
    assert plan == r_plan


def _las_like(rng, n, scale):
    """Rows as io/las.py decodes them: int32 * scale + offset, projected
    corridor coordinates (~5e5 east, ~3.3e6 north, 0-80 m up)."""
    ints = np.column_stack([
        rng.integers(0, int(2_000 / scale), n),
        rng.integers(0, int(2_000 / scale), n),
        rng.integers(0, int(80 / scale), n),
    ]).astype(np.int32)
    return np.column_stack([ints[:, 0] * scale + 500_000.0,
                            ints[:, 1] * scale + 3_300_000.0,
                            ints[:, 2] * scale + 12.5])


@pytest.mark.parametrize("given_cap", [False, True], ids=["cap-derived", "cap-given"])
@pytest.mark.parametrize("kind", ["las-0.01", "las-0.001", "random"])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 1_023, 1_024, 32_769, 1_000_003])
def test_prepare_tile_native_is_numpy_bit_for_bit(n, kind, given_cap):
    """The two native passes give the numpy lines' origin, padded f32 rows,
    mask, capacity and exact plan bit for bit, and are counted once."""
    rng = np.random.default_rng(n)
    if kind == "random":
        points = rng.normal(0.0, 1e2, (n, 3)) + rng.uniform(-1e6, 1e6, 3)
    else:
        points = _las_like(rng, n, float(kind.split("-")[1]))
    # a given capacity: a multiple of 32768 with padding, so the plan is made
    capacity = tpipe.round_up(n + 5, 32768) if given_cap else None
    before = tpipe.trace.counter("extract.prepare.native")
    got = tpipe._prepare_tile(points, GRID, capacity)
    assert tpipe.trace.counter("extract.prepare.native") == before + 1
    _assert_bits_equal(got, _numpy_prepare(points, GRID, capacity))
    assert (got[3] is not None) == (got[1].shape[0] % 32768 == 0)


# rows the native passes do not take (False), and two they take once
# converted to a C-ordered f64 array (True)
LAYOUTS = {
    "fortran": False, "strided": False, "float32": True, "float32-fortran": False,
    "nan": False, "inf": False, "minus-inf": False, "empty": False, "flat-list": True,
}


def _layout(name):
    rows = _las_like(np.random.default_rng(5), 40_000, 0.01)
    if name == "nan":
        rows[123, 1] = np.nan
    elif name == "inf":
        rows[39_999, 2] = np.inf
    elif name == "minus-inf":
        rows[0, 0] = -np.inf
    elif name == "fortran":
        rows = np.asfortranarray(rows)
    elif name == "strided":
        rows = np.repeat(rows, 2, axis=0)[::2]
    elif name == "float32":
        rows = rows.astype(np.float32)
    elif name == "float32-fortran":
        rows = np.asfortranarray(rows.astype(np.float32))
    elif name == "empty":
        rows = np.zeros((0, 3))
    elif name == "flat-list":
        rows = rows[:9].ravel().tolist()
    return rows


@pytest.mark.parametrize("capacity", [None, 65536], ids=["cap-derived", "cap-given"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prepare_tile_other_layouts_take_numpy(layout, capacity):
    """Rows that are not a C-ordered f64 array after conversion, and tiles
    with a NaN or inf or no rows, take the numpy lines and get their result
    (an error where the lines raise on a NaN or inf span's plan)."""
    points = _layout(layout)
    before = tpipe.trace.counter("extract.prepare.native")
    got = _outcome(tpipe._prepare_tile, points, GRID, capacity)
    _assert_bits_equal(got, _outcome(_numpy_prepare, points, GRID, capacity))
    assert tpipe.trace.counter("extract.prepare.native") == before + LAYOUTS[layout]


def test_extract_from_points_with_and_without_the_native_passes(tile, jax_result, monkeypatch):
    """extract_from_points gives the same towers, stats and origin, the JAX
    package's, whether the native passes prepare the tile (counted once a
    call) or numpy does (no native library: counted never)."""
    from pointcloudhookup_tpu_torch import native

    pts, centers = tile
    runs = []
    for lib in ("native", None):
        if lib is None:
            monkeypatch.setattr(native, "get_prepare_lib", lambda: None)
        before = tpipe.trace.counter("extract.prepare.native")
        runs.append(tpipe.extract_from_points(pts, PARAMS, capacity=CAP, device="cpu"))
        assert tpipe.trace.counter("extract.prepare.native") == before + (lib is not None)
    (towers, stats, origin), (n_towers, n_stats, n_origin) = runs
    np.testing.assert_array_equal(origin.view(np.int64), n_origin.view(np.int64))
    np.testing.assert_array_equal(origin, jax_result[2])
    assert stats.keys() == n_stats.keys()
    for key in stats:
        if key in ("ladder", "modular"):
            assert stats[key] == n_stats[key]
        else:
            np.testing.assert_array_equal(stats[key], n_stats[key])
    _assert_same_extraction(stats, jax_result[1])
    assert len(towers) == len(n_towers) == len(centers)
    for t, nt in zip(towers, n_towers):
        for field in dataclasses.fields(t):
            np.testing.assert_array_equal(getattr(t, field.name), getattr(nt, field.name))


def test_compress_with_and_without_the_native_passes(tile, tmp_path, monkeypatch):
    """compress writes the same bytes whether the native passes prepare the
    tile (they take the LAS's xyz) or numpy does (no native library), and
    counts no extract.prepare.native either way."""
    from pointcloudhookup_tpu_torch import native

    pts, _ = tile
    las = str(tmp_path / "tile.las")
    write_las(make_las(pts + (500_000.0, 3_100_000.0, 80.0), scales=[0.01, 0.01, 0.01]), las)
    prepared = []

    def recorded(points, cap):
        prepared.append(native.prepare_tile(points, cap) is not None)
        return native.prepare_tile(points, cap)

    monkeypatch.setattr(tpipe, "prepare_tile", recorded)
    runs = []
    for lib in ("native", None):
        if lib is None:
            monkeypatch.setattr(native, "get_prepare_lib", lambda: None)
        before = tpipe.trace.counter("extract.prepare.native")
        out = str(tmp_path / f"compressed_{lib}.las")
        n = tpipe.compress(las, out, voxel_size=0.5, device="cpu")
        assert tpipe.trace.counter("extract.prepare.native") == before
        with open(out, "rb") as f:
            runs.append((n, f.read()))
    assert prepared == [True, False]
    assert runs[0] == runs[1] and 0 < runs[0][0] < len(pts)


def _counted_native_reads(fn):
    """fn()'s result and how many reads the native LAS decoder served in it."""
    before = tpipe.trace.counter("las.read.native")
    out = fn()
    return out, tpipe.trace.counter("las.read.native") - before


def test_extract_las_file_with_and_without_the_native_reader(tmp_path, corridor, monkeypatch):
    """extract() gives the same towers, labels, ground keep and origin, and
    writes the same per-tower LAS bytes, whether the native decoder reads
    the tile (counted once) or read_las(...).xyz() does (no native library:
    counted never)."""
    from pointcloudhookup_tpu_torch import native

    pts, _ = corridor
    path = str(tmp_path / "corridor.las")
    write_las(make_las(pts, scales=[0.001] * 3), path)
    params = ExtractParams(
        cluster=ClusterParams(eps=5.0, min_points=30, auto_grid_threshold=1000)
    )
    inner = tpipe.extract_from_points
    kept = []

    def capture(*args, **kwargs):
        kept.append(inner(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(tpipe, "extract_from_points", capture)
    runs = []
    for lib in ("native", None):
        if lib is None:
            monkeypatch.setattr(native, "get_lib", lambda: None)
        out_dir = tmp_path / f"towers_{lib}"
        towers, served = _counted_native_reads(lambda: tpipe.extract(
            path, params=params, device="cpu", output_dir=str(out_dir)))
        assert served == (lib is not None)
        files = {p.name: p.read_bytes() for p in sorted(out_dir.iterdir())}
        runs.append((towers, kept[-1], files))
    (towers, (_, stats, origin), files), (n_towers, (_, n_stats, n_origin), n_files) = runs
    np.testing.assert_array_equal(origin.view(np.int64), n_origin.view(np.int64))
    for key in ("labels", "ground_keep"):
        np.testing.assert_array_equal(stats[key], n_stats[key])
    assert len(towers) == len(n_towers) > 0
    for t, nt in zip(towers, n_towers):
        for field in dataclasses.fields(t):
            np.testing.assert_array_equal(getattr(t, field.name), getattr(nt, field.name))
    assert files == n_files and len(files) == len(towers)


def test_compress_with_and_without_the_native_reader(tile, tmp_path, monkeypatch):
    """compress writes the same bytes whether the native decoder reads the
    source (counted once) or read_las(...).xyz() does (counted never); the
    version and point format of the source carry through either way."""
    from pointcloudhookup_tpu_torch import native

    pts, _ = tile
    las = str(tmp_path / "tile.las")
    write_las(make_las(pts + (500_000.0, 3_100_000.0, 80.0), scales=[0.01, 0.01, 0.005],
                       point_format=1, version=(1, 3)), las)
    runs = []
    for lib in ("native", None):
        if lib is None:
            monkeypatch.setattr(native, "get_lib", lambda: None)
        out = str(tmp_path / f"compressed_{lib}.las")
        n, served = _counted_native_reads(
            lambda: tpipe.compress(las, out, voxel_size=0.5, device="cpu"))
        assert served == (lib is not None)
        with open(out, "rb") as f:
            runs.append((n, f.read()))
    assert runs[0] == runs[1] and 0 < runs[0][0] < len(pts)
    assert runs[0][1][24:26] == bytes((1, 3)) and runs[0][1][104] == 1


# each case turns a sound format-0 file (20-byte records) into one read_las refuses
BAD_FILES = {
    "bad-signature": lambda d: b"LASX" + d[4:],
    "truncated-header": lambda d: d[:200],
    "truncated-points": lambda d: d[:-(10 * 20 + 7)],
    "point-format-4": lambda d: d[:104] + bytes((4,)) + d[105:],
    "short-records": lambda d: d[:105] + (19).to_bytes(2, "little") + d[107:],
}


@pytest.mark.parametrize("case", [*BAD_FILES, "laz", "short-decode"])
def test_the_native_reader_takes_only_what_read_las_reads(tmp_path, corridor, case,
                                                          monkeypatch):
    """A file that the JAX package's read_las refuses makes the port's
    read_las, extract() and compress() raise the same error type, and the
    native decoder serves none of it (it would read formats 4 and 5, and
    records shorter than their format).  A LAZ file, and a decode that
    returns fewer rows than the header counts, are read from the records:
    the same rows, never fewer."""
    from pointcloudhookup_tpu.io.las import read_las as jread_las
    from pointcloudhookup_tpu_torch import native
    from pointcloudhookup_tpu_torch.io import las as tlas
    from pointcloudhookup_tpu_torch.io import laz as tlaz

    pts, _ = corridor
    path = str(tmp_path / ("tile.laz" if case == "laz" else "tile.las"))
    if case == "laz":
        tlaz.write_laz(tlas.make_las(pts, scales=[0.001] * 3), path)
    else:
        write_las(make_las(pts, scales=[0.001] * 3), path)
    if case in BAD_FILES:
        with open(path, "rb") as f:
            data = BAD_FILES[case](f.read())
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(Exception) as parent:
            jread_las(path).xyz()
        before = tpipe.trace.counter("las.read.native")
        for run in (lambda: tlas.read_las(path).xyz(),
                    lambda: tpipe.extract(path, device="cpu"),
                    lambda: tpipe.compress(path, str(tmp_path / "out.las"), device="cpu")):
            with pytest.raises(type(parent.value)):
                run()
        assert tpipe.trace.counter("las.read.native") == before
        return
    ref = tlas.read_las(path)
    ref_xyz = ref.xyz() if case == "laz" else jread_las(path).xyz()
    if case == "short-decode":
        inner = native.las_read_xyz
        monkeypatch.setattr(native, "las_read_xyz", lambda p: inner(p)[:-1])
    (las, xyz), served = _counted_native_reads(lambda: tpipe._read_las(path))
    assert served == 0 and len(xyz) == len(las) == len(pts)
    np.testing.assert_array_equal(xyz.view(np.int64), ref_xyz.view(np.int64))
    assert (las.point_format, las.version) == (ref.point_format, ref.version)


@pytest.mark.parametrize("fmt,extra", [(0, 0), (1, 0), (2, 0), (3, 6), (6, 0), (7, 0),
                                       (8, 3), (9, 0), (10, 0)])
def test_read_las_reads_records_only_when_used(tmp_path, fmt, extra):
    """read_las leaves a file's records on disk: xyz() decodes natively
    (counted once) to the JAX package's rows, points reads the same records
    as the JAX package (records longer than their format too), and xyz()
    after points are replaced gives the rows of the new points, as the
    record path always did."""
    from pointcloudhookup_tpu.io.las import POINT_DTYPES as JDTYPES
    from pointcloudhookup_tpu.io.las import read_las as jread_las
    from pointcloudhookup_tpu_torch.io.las import read_las

    rng = np.random.default_rng(fmt)
    n = 3000
    src = make_las(np.zeros((n, 3)), scales=[0.01, 0.001, 0.0025], point_format=fmt)
    src.points = np.ascontiguousarray(rng.integers(0, 256, (n, JDTYPES[fmt].itemsize), np.uint8)
                                      ).view(JDTYPES[fmt]).reshape(n)
    path = str(tmp_path / "r.las")
    write_las(src, path)
    if extra:  # widen every record by `extra` trailing bytes, as the header says
        with open(path, "rb") as f:
            data = bytearray(f.read())
        off = int.from_bytes(data[96:100], "little")
        rec = JDTYPES[fmt].itemsize
        body = np.frombuffer(bytes(data[off:]), np.uint8).reshape(n, rec)
        body = np.concatenate([body, np.full((n, extra), 7, np.uint8)], axis=1)
        data[105:107] = (rec + extra).to_bytes(2, "little")
        with open(path, "wb") as f:
            f.write(bytes(data[:off]) + body.tobytes())
    ref = jread_las(path)
    (xyz, served) = _counted_native_reads(lambda: read_las(path).xyz())
    assert served == 1
    np.testing.assert_array_equal(xyz.view(np.int64), ref.xyz().view(np.int64))
    las = read_las(path)
    assert len(las) == n
    assert las.points.tobytes() == ref.points.tobytes() and las.points.flags.writeable
    las.points = las.points[: n // 2]
    half, served = _counted_native_reads(las.xyz)
    assert served == 0
    np.testing.assert_array_equal(half.view(np.int64), ref.xyz()[: n // 2].view(np.int64))
