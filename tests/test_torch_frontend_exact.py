"""The port's exact_extract_graph against the JAX package's, stage by stage
(the _cut early exits, and JAX intermediates fed into port stages through
state.py) and whole, on the tests/test_exact_frontend.py workload (CAP
32768, eps 5, min_points 30, grid, max_cells 4096, K 32, A 64).

Tolerances and why:
  * every stage up to the per-row labels is identical: the percentile
    bisection, the order-preserving compaction and the cell keys are
    exact integer/f32 arithmetic, cell keys are unique, so the stable
    torch.sort and lax.sort give the same cell order;
  * per-cluster counts, z extremes and the partition are identical;
  * centroids to 1e-3 m: rows inside a cell may come in another order, so
    f32 sums are added in another order;
  * center and extent within one angle step: a near-tie of two angles'
    areas may resolve to the neighbouring angle, which moves a box by up
    to max(extent) * (pi/2)/A."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.config import ClusterParams, ExtractParams, GroundParams
from pointcloudhookup_tpu.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu.ops import frontend_exact as jfe
from pointcloudhookup_tpu_torch import state
from pointcloudhookup_tpu_torch.ops import cluster as tcluster
from pointcloudhookup_tpu_torch.ops import frontend_exact as tfe

torch.set_num_threads(2)

CAP = 32768
PARAMS = ExtractParams(
    ground=GroundParams(min_points_after=100),
    cluster=ClusterParams(eps=5.0, min_points=30, method="grid", max_cells=4096),
    max_clusters=32,
    obb_angles=64,
)
CUTS = (1, 2, 4, 41, 42, 5, 6, 0)


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(3)
    pts, centers = synthetic_corridor(
        rng, n_ground=20_000, n_veg=4_000,
        towers=((0.0, 0.0), (160.0, 60.0), (-170.0, -80.0)),
        pts_per_tower=1_500, extent=300.0,
    )
    origin = pts.mean(axis=0)
    xyz = np.zeros((CAP, 3), np.float32)
    xyz[: len(pts)] = (pts - origin).astype(np.float32)
    mask = np.zeros(CAP, bool)
    mask[: len(pts)] = True
    plan = jfe.exact_cell_plan(pts.max(axis=0) - pts.min(axis=0), PARAMS.cluster.eps)
    assert plan == tfe.exact_cell_plan(pts.max(axis=0) - pts.min(axis=0), 5.0)
    kw = dict(cell_bits=plan, compact_cap=CAP, max_cells=4096, core_cap=2048)
    return xyz, mask, kw


@pytest.fixture(scope="module")
def jax_cuts(workload):
    """The JAX graph at every cut, computed once for the module."""
    xyz, mask, kw = workload

    def host(v):
        return {k: host(x) for k, x in v.items()} if isinstance(v, dict) else np.asarray(v)

    return {
        cut: host(jfe.exact_extract_graph(
            xyz, mask, PARAMS, _cut=cut, return_acc=cut == 0, **kw
        ))
        for cut in CUTS
    }


def _port(workload, cut):
    xyz, mask, kw = workload
    out = tfe.exact_extract_graph(
        torch.from_numpy(xyz), torch.from_numpy(mask), PARAMS, _cut=cut, **kw
    )
    return state.to_numpy(out)


def test_exact_cell_plan():
    assert tfe.exact_cell_plan((4000.0, 4000.0, 300.0), 8.0) == (10, 10, 7)
    assert tfe.exact_cell_plan((1e7, 1e7, 1e4), 8.0) is None


@pytest.mark.parametrize("cut", [1, 2, 4, 41, 42, 5, 6])
def test_stage_outputs_identical(workload, jax_cuts, cut):
    got = _port(workload, cut)
    ref = jax_cuts[cut]
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=f"cut {cut} {key}")


def test_stages_fed_jax_intermediates(jax_cuts):
    """The clustering stage run on JAX's dense-cell table (cut 4, converted
    by state.py) reproduces JAX's pop (cut 41), flood representatives
    (cut 42) and compact cell labels (cut 5)."""
    cells = state.to_torch(jax_cuts[4])
    eps = torch.tensor(PARAMS.cluster.eps, dtype=torch.float32)
    args = (cells["centers"], cells["ccount"], cells["cell_alive"], eps * eps,
            PARAMS.cluster.min_points)
    pop, _ = tfe._core_flood_cluster(*args, core_cap=2048, _cut=41)
    np.testing.assert_array_equal(pop.numpy(), jax_cuts[41]["v"])
    rep, over = tfe._core_flood_cluster(*args, core_cap=2048, _cut=42)
    np.testing.assert_array_equal(rep.numpy(), jax_cuts[42]["v"])
    assert float(over) == float(jax_cuts[42]["o"]) == 0.0
    labels, _ = tfe._core_flood_cluster(*args, core_cap=2048)
    compact = tcluster.compact_labels(labels, 4096)
    np.testing.assert_array_equal(compact.numpy(), jax_cuts[5]["cell_labels"])


def _row_labels(out, n):
    lab = np.full(n, -1, np.int32)
    sel = out["labels_sorted"] >= 0
    lab[out["rows_sorted"][sel]] = out["labels_sorted"][sel]
    return lab


def test_whole_graph_matches(workload, jax_cuts):
    ref = jax_cuts[0]
    got = _port(workload, 0)
    for key in ("base_height", "used_retry", "compact_count", "cells_overflow",
                "core_overflow"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # identical rows below compact_count (same keep set) and the same
    # labels on them: cell ids are deterministic, so partition AND ids
    cnt = int(ref["compact_count"])
    np.testing.assert_array_equal(np.sort(got["rows_sorted"][:cnt]),
                                  np.sort(ref["rows_sorted"][:cnt]))
    np.testing.assert_array_equal(_row_labels(got, CAP), _row_labels(ref, CAP))

    np.testing.assert_array_equal(got["count"], ref["count"])
    np.testing.assert_array_equal(got["alive"], ref["alive"])
    np.testing.assert_array_equal(got["accepted"], ref["accepted"])
    assert int(ref["accepted"].sum()) == 3
    alive = ref["alive"]
    np.testing.assert_allclose(got["centroid"][alive], ref["centroid"][alive],
                               atol=1e-3)
    step = math.pi / 2 / PARAMS.obb_angles
    tol = float(ref["extent"][alive].max()) * step
    np.testing.assert_allclose(got["center"][alive], ref["center"][alive], atol=tol)
    np.testing.assert_allclose(got["extent"][alive], ref["extent"][alive], atol=tol)
    # z extremes and axis-aligned bounds are min/max: order-free, exact
    np.testing.assert_array_equal(got["aabb_min"], ref["aabb_min"])
    np.testing.assert_array_equal(got["aabb_max"], ref["aabb_max"])


def test_return_acc_and_local_rows(workload, jax_cuts):
    xyz, mask, kw = workload
    out = tfe.exact_extract_graph(
        torch.from_numpy(xyz), torch.from_numpy(mask), PARAMS, return_acc=True,
        local_rows=CAP // 2, **kw
    )
    acc = state.to_numpy(out["acc"])
    assert set(acc) == set(jax_cuts[0]["acc"])
    # rows >= local_rows are clustered but not accumulated
    lab = _row_labels(state.to_numpy(out), CAP)
    local = lab[: CAP // 2]
    want = np.bincount(local[local >= 0], minlength=PARAMS.max_clusters)
    np.testing.assert_array_equal(acc["cnt"], want.astype(np.float32))
    # a group of one rank (its collectives return their input) changes
    # nothing; several ranks are tests/test_torch_parallel.py's
    alone = tfe.exact_extract_graph(
        torch.from_numpy(xyz), torch.from_numpy(mask), PARAMS, return_acc=True,
        local_rows=CAP // 2, group=_OneRank(), **kw
    )
    for key, val in state.to_numpy(alone["acc"]).items():
        np.testing.assert_array_equal(val, acc[key])
    np.testing.assert_array_equal(alone["labels_sorted"].numpy(), out["labels_sorted"].numpy())
    assert float(alone["base_height"]) == float(out["base_height"])


class _OneRank:
    """The collectives of a group of one rank."""

    def all_reduce(self, t, op):
        return t.clone()


def _reciprocal_split_tile(workload, eps):
    """The module's tile with two groups of 20 kept rows placed in one
    cell as XLA:CPU assigns it -- it rewrites the graph's division by the
    constant cell = eps / 2 into a product with its f32 reciprocal -- where
    the first group's x lies one ulp below a cell edge, so that the true
    quotient floors it into the cell before (found with numpy: such rows
    exist at eps 6 and 3, not at 5 or 8)."""
    xyz, mask, kw = workload
    params = dataclasses.replace(
        PARAMS, cluster=dataclasses.replace(PARAMS.cluster, eps=eps)
    )
    keep = np.asarray(jfe.exact_extract_graph(xyz, mask, params, _cut=1, **kw)["keep"])
    mn = xyz[keep].min(axis=0)
    z_top = np.float32(xyz[keep, 2].max())
    cell = np.float32(eps) / np.float32(2.0)
    recip = np.float32(1.0) / cell
    for j in range(int(100.0 / cell), int(200.0 / cell)):
        edge = np.float32(j * float(cell)).view(np.int32)
        for step in range(1, 64):
            x = np.float32(mn[0] + np.int32(edge - step).view(np.float32))
            d = np.float32(x - mn[0])
            if np.floor(d * recip) == j and np.floor(d / cell) == j - 1:
                break
        else:
            continue
        break
    else:
        raise AssertionError("no row found where the two floors differ")
    inside = np.float32(mn[0] + (j + np.float32(0.5)) * cell)
    y = np.float32(mn[1] + np.float32(20.5) * cell)
    z = np.float32(z_top - np.float32(0.5))
    free = np.where(~mask)[0][:40]
    out, m = xyz.copy(), mask.copy()
    out[free] = np.stack([np.r_[np.full(20, x), np.full(20, inside)],
                          np.full(40, y), np.full(40, z)], 1)
    m[free] = True
    return out, m, params


@pytest.mark.parametrize("eps", [6.0, 3.0])
def test_cell_keys_round_as_xla(workload, eps):
    """The exact graph divides by the constant cell = eps / 2, which
    XLA:CPU computes as a product with the f32 reciprocal.  At eps 6 and 3
    the two round some rows into different cells; the port must follow
    XLA.  With a density floor of 25 the placed cell of 40 rows is dense
    only if both groups share it, so the keep set, partition and counts
    all depend on it."""
    _, _, kw = workload
    xyz, mask, params = _reciprocal_split_tile(workload, eps)
    kw = dict(kw, min_cell_points=25)
    ref = jfe.exact_extract_graph(xyz, mask, params, _cut=4, **kw)
    got = tfe.exact_extract_graph(torch.from_numpy(xyz), torch.from_numpy(mask), params,
                                  _cut=4, **kw)
    for key in ("centers", "ccount", "cell_alive"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    ref = {k: np.asarray(v) for k, v in jfe.exact_extract_graph(
        xyz, mask, params, **kw).items()}
    got = state.to_numpy(tfe.exact_extract_graph(
        torch.from_numpy(xyz), torch.from_numpy(mask), params, **kw))
    cnt = int(ref["compact_count"])
    assert int(got["compact_count"]) == cnt
    np.testing.assert_array_equal(np.sort(got["rows_sorted"][:cnt]),
                                  np.sort(ref["rows_sorted"][:cnt]))
    placed = _row_labels(ref, CAP)[~workload[1] & mask]
    assert (placed >= 0).all() and len(set(placed)) == 1  # one cluster, as XLA puts it
    np.testing.assert_array_equal(_row_labels(got, CAP), _row_labels(ref, CAP))
    for key in ("count", "alive", "accepted", "aabb_min", "aabb_max"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
