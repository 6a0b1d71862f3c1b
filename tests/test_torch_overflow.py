"""The port's overflow resolver (models/overflow.py) against the JAX
package's on the CPU.

The JAX resolver's fast path runs fused_extract_step, which takes the
sort-based OBB on the CPU; the port always accumulates.  So the JAX side
runs with a twin of its accelerator branch patched into
``pointcloudhookup_tpu.models.overflow._fast_extract`` (inside these
tests only): the JAX fused front-end, the accumulator OBB through the
Pallas kernel in interpret mode, and the JAX filters.

Tolerances: the same towers (count, member counts); centres within one
angle step of the largest box (u/v extremes may differ by an ulp between
XLA's and torch's angle tables, and a near-tie of two angles' areas may
then pick the neighbouring angle)."""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dataclasses

from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
from pointcloudhookup_tpu.models import overflow as joverflow
from pointcloudhookup_tpu.models.towers import filter_and_dedup, towers_from_stats
from pointcloudhookup_tpu.ops.frontend_fused import fused_downsample_ground_cluster
from pointcloudhookup_tpu.ops.obb import _obb_from_accum
from pointcloudhookup_tpu.ops.pallas.obb_accum import obb_accumulate
from pointcloudhookup_tpu_torch import state
from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu_torch.models import overflow as toverflow
from pointcloudhookup_tpu_torch.models import pipeline as tpipe

torch.set_num_threads(2)


def _jax_fast_extract_accum(points, params):
    """The JAX package's _fast_extract with the accumulator OBB (its
    accelerator choice), on the CPU."""
    from pointcloudhookup_tpu.core.batch import round_up

    origin = points.mean(axis=0) if len(points) else np.zeros(3)
    cap = round_up(max(len(points), 1), 1024)
    if cap >= 131072:
        cap = round_up(cap, 32768)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(points)] = (points - origin).astype(np.float32)
    mask = np.arange(cap) < len(points)
    hi, lo, keep, labels, base, mn, cells_over, _ = fused_downsample_ground_cluster(
        jnp.asarray(xyz), jnp.asarray(mask), params,
        min_cell_points=max(params.cluster.min_cell_points, 1),
        geometric_voxels=True, emit="codes", return_cells_overflow=True,
        precut_div=4,
    )
    k = params.max_clusters
    lab = jnp.where((labels >= 0) & (labels < k) & keep, labels, -1)
    acc = obb_accumulate(hi, lo, lab, mn, max_clusters=k,
                         num_angles=params.obb_angles, interpret=True)
    stats = _obb_from_accum(acc, k, params.obb_angles)
    stats["accepted"] = filter_and_dedup(stats, params.filters)
    stats.update(base_height=base, cells_overflow=cells_over)
    stats = {key: np.asarray(v) for key, v in stats.items()}
    return towers_from_stats(stats, origin), stats


@pytest.fixture
def jax_accum(monkeypatch):
    monkeypatch.setattr(joverflow, "_fast_extract", _jax_fast_extract_accum)


def _dense_tile(rng, nx, ny, pts_per_tower=400, n_ground=40_000, spacing=45.0):
    """tests/test_overflow.py's grid of towers."""
    xs = (np.arange(nx) - (nx - 1) / 2) * spacing
    ys = (np.arange(ny) - (ny - 1) / 2) * spacing
    towers = [(float(x), float(y)) for x in xs for y in ys]
    extent = max(xs.max(), ys.max()) + 60.0
    return synthetic_corridor(
        rng, n_ground=n_ground, n_veg=2000, towers=towers, tower_width=14.0,
        pts_per_tower=pts_per_tower, extent=float(extent),
    )


def _port_params(params):
    return state.extract_params_from_dict(dataclasses.asdict(params))


def _assert_same_towers(got, ref, params):
    assert len(got) == len(ref)
    key = lambda t: (round(t.center[0]), round(t.center[1]))  # noqa: E731
    got, ref = sorted(got, key=key), sorted(ref, key=key)
    assert [t.num_points for t in got] == [t.num_points for t in ref]
    tol = max(t.extent[0] for t in ref) * math.pi / 2 / params.obb_angles
    np.testing.assert_allclose(
        np.array([t.center for t in got]), np.array([t.center for t in ref]), atol=tol
    )


def test_saturated_detects_cells_overflow():
    params = ExtractParams()
    stats = dict(alive=np.zeros(128, bool), cells_overflow=np.float32(3.0))
    assert toverflow.saturated(stats, params)
    stats = dict(alive=np.zeros(128, bool), cells_overflow=np.float32(0.0))
    assert not toverflow.saturated(stats, params)
    assert toverflow.saturated(dict(alive=np.ones(128, bool)), params)


def test_no_split_when_not_saturated(jax_accum):
    """An ordinary tile runs exactly once and gives the JAX towers."""
    pts, centers = _dense_tile(np.random.default_rng(42), 3, 2, n_ground=8000)
    params = ExtractParams(cluster=ClusterParams(eps=8.0, min_points=60, method="grid"))
    towers, info = toverflow.extract_from_points_resolving(
        pts, _port_params(params), fast=True, device="cpu"
    )
    assert info == dict(saturated_tiles=0, tiles_run=1, max_depth_used=0, resolved=True)
    assert len(towers) == len(centers)
    ref, ref_info = joverflow.extract_from_points_resolving(pts, params, fast=True)
    assert ref_info == info
    _assert_same_towers(towers, ref, params)


def test_300_structure_tile_fully_extracted(jax_accum):
    """20 x 15 = 300 towers against max_clusters=128: the base step
    saturates and the quadrant re-split finds all 300, as in the JAX
    package."""
    pts, centers = _dense_tile(np.random.default_rng(42), 20, 15)
    params = ExtractParams(
        cluster=ClusterParams(eps=8.0, min_points=60, method="grid"), max_clusters=128,
    )
    towers, info = toverflow.extract_from_points_resolving(
        pts, _port_params(params), fast=True, device="cpu"
    )
    assert info["saturated_tiles"] >= 1 and info["resolved"] is True
    assert info["max_depth_used"] >= 1
    assert len(towers) == len(centers) == 300
    ref, ref_info = joverflow.extract_from_points_resolving(pts, params, fast=True)
    assert ref_info == info
    _assert_same_towers(towers, ref, params)
    got = np.array([t.centroid[:2] for t in towers])
    for c in centers:
        assert np.linalg.norm(got - c[None, :2], axis=1).min() < 2.0


def test_exact_path_resolver_matches_extract_from_points():
    """fast=False resolves through the exact path: on an unsaturated tile
    of 65,000 points (a 65,536-row capacity, eligible for the exact path)
    it returns extract_from_points' towers, as the JAX resolver does."""
    pts, centers = _dense_tile(np.random.default_rng(9), 3, 2, n_ground=61_000)
    assert 63 * 1024 < len(pts) <= 64 * 1024  # capacity 65,536
    params = ExtractParams(cluster=ClusterParams(eps=8.0, min_points=60, method="grid"))
    tparams = _port_params(params)
    towers, info = toverflow.extract_from_points_resolving(
        pts, tparams, fast=False, device="cpu"
    )
    assert info["tiles_run"] == 1 and info["resolved"] is True
    direct, _, _ = tpipe.extract_from_points(pts, tparams, device="cpu")
    assert [t.num_points for t in towers] == [t.num_points for t in direct]
    ref, ref_info = joverflow.extract_from_points_resolving(pts, params, fast=False)
    assert ref_info == info and len(towers) == len(centers)
    _assert_same_towers(towers, ref, params)
