"""The port's extraction pipeline: extract_from_points and its retry ladder
against the JAX package on the tests/test_exact_frontend.py workload,
extract() on a LAS file, the CLI, and tiles the exact path does not take,
which run the modular extract_step (tests/test_torch_modular.py holds
that path in every method)."""

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
