"""The port's modular extraction path against the JAX package's, on the
CPU: ``extract_step`` in each clustering method, ``extract_from_points`` on
tiles the exact path does not take (with the density-floor retry), the
golden corridor, the ``fast=False`` resolver on a saturated tile, the CLI
on a small LAS file and ``entry()``.

Integer outputs (labels, keep, counts, alive, accepted, cells_overflow)
and the ground base must be identical; geometry agrees to f32 summation
order (the OBB centroid sums) or within one angle step of the box (see
tests/test_torch_overflow.py)."""

import dataclasses
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.config import ClusterParams, ExtractParams, GroundParams
from pointcloudhookup_tpu.io.las import make_las, write_las
from pointcloudhookup_tpu.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu.models import overflow as joverflow
from pointcloudhookup_tpu.models import pipeline as jpipe
from pointcloudhookup_tpu.models.towers import extract_step as jextract_step
from pointcloudhookup_tpu_torch import state
from pointcloudhookup_tpu_torch.__main__ import main as cli_main
from pointcloudhookup_tpu_torch.entry import entry
from pointcloudhookup_tpu_torch.models import overflow as toverflow
from pointcloudhookup_tpu_torch.models import pipeline as tpipe
from pointcloudhookup_tpu_torch.models.towers import extract_step as textract_step

torch.set_num_threads(2)

CAP = 8192
INT_KEYS = ("labels", "ground_keep", "count", "alive", "accepted", "cells_overflow")


def _port(params):
    return state.extract_params_from_dict(dataclasses.asdict(params))


@functools.cache
def _corridor(seed=42):
    """tests/conftest.py's ~6.2k-point corridor (three towers)."""
    return synthetic_corridor(
        np.random.default_rng(seed), n_ground=4000, n_veg=800, pts_per_tower=400,
        extent=250.0,
    )


def _padded(pts, cap):
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    return xyz, np.arange(cap) < len(pts)


def _assert_same_stats(got, ref):
    """Integer outputs identical, base bit for bit, geometry of the alive
    clusters within f32 summation order (centroids: sums of a few hundred
    coordinates below 300 m) and one angle step (boxes)."""
    for key in INT_KEYS:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert np.float32(got["base_height"]).view(np.uint32) == \
        np.float32(ref["base_height"]).view(np.uint32)
    alive = ref["alive"]
    np.testing.assert_allclose(got["centroid"][alive], ref["centroid"][alive], atol=1e-3)
    tol = max(float(ref["extent"][alive, 0].max()), 1.0) * math.pi / 2 / 64
    for key in ("center", "extent"):
        np.testing.assert_allclose(got[key][alive], ref[key][alive], atol=tol, err_msg=key)


PARAMS = ExtractParams(ground=GroundParams(min_points_after=100),
                       cluster=ClusterParams(eps=5.0, min_points=30, max_cells=4096),
                       max_clusters=32, obb_angles=64)
METHODS = {
    "auto-dbscan": {},
    "exact": dict(method="exact"),
    "grid": dict(method="grid"),
    "adaptive": dict(method="adaptive"),
    "per-chunk": dict(per_chunk=True, chunk_size=4096),
    "grid-overflow": dict(method="grid", max_cells=1024),
}
# no ground cut: the ground's sparse cells overflow a 1,024-cell table
ALL_ROWS = GroundParams(percentile=0.0, offset=-1.0, min_points_after=0)


@pytest.mark.parametrize("method", list(METHODS), ids=list(METHODS))
def test_extract_step_matches_jax(method):
    """extract_step on the corridor tile in each branch: the JAX function's
    outputs (three towers accepted; without the ground cut, the small grid
    table overflows)."""
    params = dataclasses.replace(
        PARAMS, cluster=dataclasses.replace(PARAMS.cluster, **METHODS[method]))
    if method == "grid-overflow":
        params = dataclasses.replace(params, ground=ALL_ROWS)
    xyz, mask = _padded(_corridor()[0], CAP)
    ref = {k: np.asarray(v) for k, v in
           jextract_step(jnp.asarray(xyz), jnp.asarray(mask), params).items()}
    got = state.to_numpy(textract_step(torch.from_numpy(xyz), torch.from_numpy(mask),
                                       _port(params)))
    assert set(got) == set(ref)
    _assert_same_stats(got, ref)
    if method == "grid-overflow":
        assert float(ref["cells_overflow"]) > 0
    else:
        assert int(ref["accepted"].sum()) == 3


def test_density_floor_retry_matches_jax():
    """A grid tile whose dense cells overflow a 1,024-cell table: both
    packages double the density floor until the table fits, with the same
    result; the port records the settled floor."""
    params = dataclasses.replace(
        PARAMS, ground=ALL_ROWS,
        cluster=dataclasses.replace(PARAMS.cluster, method="grid", max_cells=1024))
    pts = _corridor()[0]
    _, ref, _ = jpipe.extract_from_points(pts, params, capacity=CAP)
    towers, got, _ = tpipe.extract_from_points(pts, _port(params), capacity=CAP,
                                               device="cpu")
    _assert_same_stats(got, ref)
    assert got["modular"] == dict(floor=2, cells_overflow=0.0)
    assert len(towers) == 3


def test_golden_corridor():
    """tests/golden_corridor.json through the port, at the tolerances of
    tests/test_golden.py (capacity 8,192: the modular path, dbscan)."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "golden_corridor.json")) as f:
        golden = json.load(f)
    pts, _ = synthetic_corridor(
        np.random.default_rng(golden["seed"]), n_ground=4000, n_veg=800,
        pts_per_tower=400, extent=250.0,
    )
    params = _port(ExtractParams(
        ground=GroundParams(min_points_after=100),
        cluster=ClusterParams(eps=golden["params"]["eps"],
                              min_points=golden["params"]["min_points"]),
        max_clusters=32, obb_angles=64,
    ))
    towers, stats, _ = tpipe.extract_from_points(pts, params, capacity=8192, device="cpu")
    assert "modular" in stats
    towers = sorted(towers, key=lambda t: t.center[0])
    assert len(towers) == len(golden["towers"])
    for t, g in zip(towers, golden["towers"]):
        np.testing.assert_allclose(t.center, g["center"], atol=0.05)
        np.testing.assert_allclose(t.extent, g["extent"], atol=0.35)
        assert t.num_points == g["num_points"]
        diff = abs(t.north_angle - g["north_angle"]) % 180.0
        assert min(diff, 180.0 - diff) < 1.5


def test_saturated_resolver_runs_the_modular_path():
    """fast=False on a saturated corridor tile (max_clusters 2 against three
    towers and vegetation clusters): the top tile and its four quadrants
    all run the modular path, and the towers and resolver info are the JAX
    resolver's."""
    pts, centers = _corridor()
    params = ExtractParams(cluster=ClusterParams(eps=5.0, min_points=30), max_clusters=2,
                           obb_angles=64)
    ref, ref_info = joverflow.extract_from_points_resolving(pts, params, fast=False,
                                                            max_depth=1)
    towers, info = toverflow.extract_from_points_resolving(pts, _port(params), fast=False,
                                                           max_depth=1, device="cpu")
    assert info == ref_info and info["saturated_tiles"] >= 1 and info["tiles_run"] == 5
    assert len(towers) == len(ref) >= 2
    key = lambda t: (round(t.center[0]), round(t.center[1]))  # noqa: E731
    got, ref = sorted(towers, key=key), sorted(ref, key=key)
    assert [t.num_points for t in got] == [t.num_points for t in ref]
    tol = max(t.extent[0] for t in ref) * math.pi / 2 / params.obb_angles
    np.testing.assert_allclose([t.center for t in got], [t.center for t in ref], atol=tol)


@pytest.mark.parametrize("extra", [[], ["--cluster-method", "adaptive"], ["--per-chunk"]],
                         ids=["defaults", "adaptive", "per-chunk"])
def test_cli_extract_small_las(tmp_path, capsys, extra):
    """The CLI on a corridor LAS file below auto_grid_threshold, as the
    verify skill makes it, with the default 65,536-cell table and 50,000-row
    chunks (test_extract_step_matches_jax holds these branches against the
    JAX package on smaller ones): every generated tower found, each within
    2 m (xy) of a box centre."""
    pts, centers = _corridor(1)
    path = str(tmp_path / "corridor.las")
    write_las(make_las(pts, scales=[0.01] * 3), path)
    cli_main(["extract", path, "--device", "cpu", "--eps", "5", "--min-points", "30",
              *extra])
    out = capsys.readouterr().out
    assert "modular path: " in out and f"extraction complete: {len(centers)} towers" in out
    found = np.array([[float(v) for v in ln.split("center=(")[1].split(")")[0].split(",")]
                      for ln in out.splitlines() if ln.startswith("tower_")])
    assert len(found) == len(centers), out
    dist = np.linalg.norm(centers[:, None, :2] - found[None, :, :2], axis=2)
    assert dist.min(axis=1).max() < 2.0


def test_entry_runs_the_modular_step():
    """entry() gives the modular step and its 60,000-point batch at
    capacity 65,536; on the CPU the three generated towers are accepted."""
    fn, (xyz, mask) = entry("cpu")
    assert xyz.shape == (65536, 3) and int(mask.sum()) == 60000
    out = fn(xyz, mask)
    assert out["labels"].shape == (65536,) and int(out["accepted"].sum()) == 3
