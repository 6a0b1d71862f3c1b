"""The port's fused fast path (ops/frontend_fused.py) against the JAX
package's on the CPU, on two tiles: the corridor fixture's tile (seed 42,
capacity 8192, eps 5, min_points 30, 2048 cells) and the 131,072-row
pre-cut tile of tests/test_precut.py (pre-cut at N/4 into 32,768 rows).

Tolerances and why:
  * every _cut exit and every output of fused_downsample_ground_cluster
    (hi, lo, keep, labels, base, mn, cells_over, hier_over) is identical:
    Morton keys, the sort of unique keys, the percentiles, scans, packs and
    clustering are exact integer/f32 arithmetic, and the port rounds the
    voxel-size division and the centre decodes as XLA compiles them;
  * fused_extract_step against a JAX twin of its accelerator branch (the
    JAX package takes obb="sort" on the CPU): counts, alive, accepted,
    labels and keep identical; centroids within the f32 summation bound;
    the chosen angle, the z centre and the z extent identical (z comes
    from zlo/zhi); the xy centres and extents within 4 ulp of the largest
    projected coordinate (a u/v extreme may differ by an ulp)."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloudhookup_tpu.config import ClusterParams, ExtractParams, GroundParams
from pointcloudhookup_tpu.models.towers import filter_and_dedup as jax_filter_and_dedup
from pointcloudhookup_tpu.ops import frontend_fused as jff
from pointcloudhookup_tpu.ops.obb import _obb_from_accum as jax_obb_from_accum
from pointcloudhookup_tpu.ops.pallas.compactidx import compact_indices_reference
from pointcloudhookup_tpu.ops.pallas.obb_accum import obb_accumulate as jax_obb_accumulate
from pointcloudhookup_tpu_torch import state
from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu_torch.ops import frontend_fused as tff

torch.set_num_threads(2)

CUTS = (1, 2, 3, 4, 5, 0)


def _corridor():
    pts, centers = synthetic_corridor(
        np.random.default_rng(42), n_ground=4000, n_veg=800, pts_per_tower=400,
        extent=250.0,
    )
    params = ExtractParams(
        ground=GroundParams(min_points_after=100),
        cluster=ClusterParams(eps=5.0, min_points=30), max_clusters=32, obb_angles=64,
    )
    return pts, centers, 8192, params, dict(max_cells=2048, min_cell_points=1)


def _precut():
    n = 131072
    rng = np.random.default_rng(5)
    xs = np.linspace(-400, 400, 6)
    ys = 30.0 * np.sin(xs / 200.0)
    pts, centers = synthetic_corridor(
        rng, n_ground=int(n * 0.8), n_veg=int(n * 0.12), towers=tuple(zip(xs, ys)),
        pts_per_tower=max((n - int(n * 0.92)) // 6, 1), extent=450.0, n_line=0,
    )
    return (pts[:n], centers, n, ExtractParams(max_clusters=64),
            dict(max_cells=2048, min_cell_points=3, precut_div=4))


WORKLOADS = {"corridor": _corridor, "precut": _precut}


def _padded(pts, cap):
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    return xyz, np.arange(cap) < len(pts)


@pytest.fixture(scope="module")
def runs():
    """Per workload: inputs, both packages' params, and the JAX outputs at
    every cut (the whole run with return_cells_overflow), computed once."""
    out = {}
    for name, make in WORKLOADS.items():
        pts, centers, cap, jparams, kw = make()
        xyz, mask = _padded(pts, cap)
        kw = dict(kw, geometric_voxels=True, emit="codes", return_cells_overflow=True)
        jax_cuts = {}
        for cut in CUTS:
            res = jff.fused_downsample_ground_cluster(
                jnp.asarray(xyz), jnp.asarray(mask), jparams, _cut=cut, **kw
            )
            jax_cuts[cut] = [np.asarray(r) for r in res]
        tparams = state.extract_params_from_dict(dataclasses.asdict(jparams))
        out[name] = dict(xyz=xyz, mask=mask, centers=centers, jparams=jparams,
                         tparams=tparams, kw=kw, jax=jax_cuts)
    return out


def _port(run, cut=0, **extra):
    kw = dict(run["kw"], **extra)
    res = tff.fused_downsample_ground_cluster(
        torch.from_numpy(run["xyz"]), torch.from_numpy(run["mask"]), run["tparams"],
        _cut=cut, **kw,
    )
    return [r.numpy() for r in res]


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_cut_outputs_identical(runs, workload, cut):
    run = runs[workload]
    ref = list(run["jax"][cut])
    if cut == 3:
        # on the CPU the JAX package packs by cumsum + searchsorted and
        # exits with the cumsum (pidx_row); the port exits with the flags
        ref[0] = np.diff(ref[0], prepend=-1) == 1
    got = _port(run, cut)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, (cut, i)
        np.testing.assert_array_equal(g, r, err_msg=f"{workload} cut {cut} output {i}")


def test_precut_engaged_and_clean(runs):
    hi = runs["precut"]["jax"][0][0]
    assert hi.shape == (32768,)  # compacted to the pre-cut capacity
    assert float(runs["precut"]["jax"][0][6]) == 0.0


def _jax_accum_twin(run, jax_out):
    """The JAX package's accelerator branch of fused_extract_step: the
    accumulator OBB through the Pallas kernel in interpret mode."""
    hi, lo, keep, labels, base, mn = jax_out[:6]
    p = run["jparams"]
    k = p.max_clusters
    lab = np.where((labels >= 0) & (labels < k) & keep, labels, -1).astype(np.int32)
    acc = jax_obb_accumulate(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(lab), jnp.asarray(mn),
        max_clusters=k, num_angles=p.obb_angles, interpret=True,
    )
    # jitted, as inside the JAX package's fused_extract_step
    stats = jax.jit(jax_obb_from_accum, static_argnums=(1, 2))(acc, k, p.obb_angles)
    stats["accepted"] = jax_filter_and_dedup(stats, p.filters)
    return {key: np.asarray(v) for key, v in stats.items()}


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_fused_extract_step_matches_jax_accum_twin(runs, workload):
    run = runs[workload]
    jax_out = run["jax"][0]
    ref = _jax_accum_twin(run, jax_out)
    kw = {key: v for key, v in run["kw"].items()
          if key in ("max_cells", "min_cell_points", "precut_div")}
    got = state.to_numpy(tff.fused_extract_step(
        torch.from_numpy(run["xyz"]), torch.from_numpy(run["mask"]), run["tparams"],
        geometric_voxels=True, **kw,
    ))
    for key, i in (("labels", 3), ("ground_keep", 2), ("base_height", 4),
                   ("cells_overflow", 6), ("hier_runs_over", 7)):
        np.testing.assert_array_equal(got[key], jax_out[i], err_msg=key)
    for key in ("count", "alive", "accepted", "aabb_min", "aabb_max"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert int(ref["accepted"].sum()) == len(run["centers"])
    alive = ref["alive"]
    # centroid: sums of n terms in two orders, 2 n u mean|x| apart at most
    bound = 2 * ref["count"][alive, None] * 2.0**-24 * np.abs(ref["centroid"][alive]) + 1e-5
    assert (np.abs(got["centroid"][alive] - ref["centroid"][alive]) <= bound).all()
    for key in ("angle", "north_angle"):
        np.testing.assert_array_equal(got[key][alive], ref[key][alive], err_msg=key)
    for key in ("center", "extent"):
        np.testing.assert_array_equal(got[key][alive, 2], ref[key][alive, 2], err_msg=key)
    # |u|, |v| <= |centre| + extent: an extreme's ulp there bounds the xy error
    coord = np.abs(ref["center"][alive, :2]).max() + ref["extent"][alive, :2].max()
    tol = 4 * float(np.spacing(np.float32(coord)))
    for key in ("center", "extent"):
        np.testing.assert_allclose(got[key][alive, :2], ref[key][alive, :2], rtol=0,
                                   atol=tol, err_msg=key)


@pytest.mark.parametrize("core_cap", [2048, 8], ids=["fits", "spills"])
def test_core_flood_branch_matches_jax(runs, core_cap):
    """A table of >= core_flood_cells cells takes the core flood (neighbor
    and cluster_converge kernels) instead of the full-table converge: the
    same labels and cells_over as the JAX package, and a spilled core
    table is reported through cells_over, never silently truncated."""
    run = runs["corridor"]
    kw = dict(run["kw"], core_flood_cells=2048, core_cap=core_cap)
    ref = [np.asarray(r) for r in jff.fused_downsample_ground_cluster(
        jnp.asarray(run["xyz"]), jnp.asarray(run["mask"]), run["jparams"], **kw
    )]
    got = _port(run, core_flood_cells=2048, core_cap=core_cap)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g, r, err_msg=f"output {i}")
    if core_cap == 8:
        assert float(got[6]) > 0.0
    else:
        # a sufficient core table floods to the converge branch's labels
        np.testing.assert_array_equal(got[3], run["jax"][0][3])


def test_pack_routes_agree(runs):
    """The dense-cell table pack through compactrows (row index payload),
    through compact_indices, and the cumsum + searchsorted the JAX package
    runs on the CPU give identical rows_m, dead slots at N - 1."""
    for run in runs.values():
        dense_start, _ = _port(run, 3)
        flags = torch.from_numpy(dense_start)
        n_dense = int(dense_start.sum())
        for m in (n_dense // 2, n_dense, 2048):
            want = np.asarray(compact_indices_reference(jnp.asarray(dense_start), m))
            for route in ("compactrows", "compactidx"):
                got = tff.pack_dense_rows(flags, m, route).numpy()
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, want, err_msg=f"{route} m={m}")
    assert tff.pack_route(720_896, 4096) == "compactrows"
    assert tff.pack_route(4 << 20, 4096) == "compactidx"
    assert tff.pack_route(4 << 20, 8192) == "compactrows"
    assert tff.pack_route(8192 + 1024, 2048) == "compactidx"


def test_label_scatter_on_the_last_row():
    """The reference scatters the labels of all m table slots; its dead
    slots (row n - 1) are written after the live ones, so when row n - 1
    is itself a labelled dense-cell start its label is overwritten with -1.
    Pinned here on a tile with no padding row whose last Morton row is a
    one-voxel cell on top of a tower; the port matches it."""
    rng = np.random.default_rng(8)
    n = 1024
    ground = np.column_stack([rng.uniform(-40, 40, (n - 300, 2)), rng.normal(0, 0.1, n - 300)])
    tower = np.column_stack([rng.uniform(30, 34, (299, 2)), rng.uniform(0, 30, 299)])
    top = np.array([[33.9, 33.9, 31.0]])  # the max Morton code: x, y, z maximal
    xyz = np.vstack([ground, tower, top]).astype(np.float32)
    mask = np.ones(n, bool)
    jparams = ExtractParams(
        ground=GroundParams(min_points_after=10),
        cluster=ClusterParams(eps=5.0, min_points=10), max_clusters=8, obb_angles=16,
    )
    tparams = state.extract_params_from_dict(dataclasses.asdict(jparams))
    kw = dict(max_cells=1024, min_cell_points=1, geometric_voxels=True, emit="codes")
    ref = [np.asarray(r) for r in jff.fused_downsample_ground_cluster(
        jnp.asarray(xyz), jnp.asarray(mask), jparams, **kw)]
    got = [r.numpy() for r in tff.fused_downsample_ground_cluster(
        torch.from_numpy(xyz), torch.from_numpy(mask), tparams, **kw)]
    dense_start, _ = [r.numpy() for r in tff.fused_downsample_ground_cluster(
        torch.from_numpy(xyz), torch.from_numpy(mask), tparams, _cut=3, **kw)]
    cell_labels, _ = [r.numpy() for r in tff.fused_downsample_ground_cluster(
        torch.from_numpy(xyz), torch.from_numpy(mask), tparams, _cut=5, **kw)]
    n_dense = int(dense_start.sum())
    # the edge case: row n-1 starts a labelled live cell, and dead slots exist
    assert dense_start[-1] and got[2][-1] and n_dense < 1024
    assert cell_labels[n_dense - 1] >= 0
    assert ref[3][-1] == -1  # the reference drops that row's label
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g, r, err_msg=f"output {i}")


def test_precut_overflow_flagged_like_jax():
    """A tile that is nearly all structure overflows the pre-cut capacity
    (32,768 of 131,072 rows): the dropped-row count folds into cells_over,
    and every output is identical to the JAX package's."""
    n = 131072
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(0, 80, n).astype(np.float32)  # tall block
    mask = np.ones(n, bool)
    jparams = ExtractParams(max_clusters=64)
    tparams = state.extract_params_from_dict(dataclasses.asdict(jparams))
    kw = dict(max_cells=2048, min_cell_points=3, geometric_voxels=True, emit="codes",
              precut_div=8, return_cells_overflow=True)
    ref = [np.asarray(r) for r in jff.fused_downsample_ground_cluster(
        jnp.asarray(xyz), jnp.asarray(mask), jparams, **kw)]
    got = [r.numpy() for r in tff.fused_downsample_ground_cluster(
        torch.from_numpy(xyz), torch.from_numpy(mask), tparams, **kw)]
    assert float(got[6]) > 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g, r, err_msg=f"output {i}")

