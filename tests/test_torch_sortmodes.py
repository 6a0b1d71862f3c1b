"""The fused front-end's sort modes ("cell", "hier", "merge"), its centroid
voxels and emit "xyz", and the sort-based OBB, in the port against the JAX
package on the CPU.

Tolerances and why:
  * kernel plain versions: identical to the JAX kernels run in interpret
    mode (and to their numpy/XLA references): integer outputs;
  * "hier" and "merge" under the hier guarantee (every cell run at most
    W/2 + 1 rows), and "cell", whose key sort is stable in the port and
    in XLA:CPU on these tiles: every front-end output identical
    positionally to the JAX package's same mode and to its "full" mode;
    on a dense tile (runs beyond the guarantee) hier_runs_over identical
    and the same towers;
  * fused_extract_step with the sort-based OBB and with centroid voxels
    against the JAX function itself: labels, keep, base, counts, alive,
    accepted and the axis-aligned boxes identical; centroids within
    2 n u |x| (two f32 summation orders of n terms, u = 2**-24); the
    chosen angle identical; the xy centre and extents within 4 ulp of the
    largest projected coordinate and the north angle within 1e-3 degrees
    modulo 360 (XLA:CPU contracts the projections into fused multiply-adds
    and its float32 cos/sin differ from torch's by an ulp at some angles).
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax import lax

from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
from pointcloudhookup_tpu.ops import frontend_fused as jff
from pointcloudhookup_tpu.ops.pallas.dupwin import (
    first_occurrence_flags as jax_first_occurrence_flags,
    first_occurrence_flags_reference,
)
from pointcloudhookup_tpu.ops.pallas.mergesort import merge_sort_2key as jax_merge_sort_2key
from pointcloudhookup_tpu.ops.pallas.winsort import window_sort_w as jax_window_sort_w
from pointcloudhookup_tpu_torch import state
from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu_torch.ops import frontend_fused as tff
from pointcloudhookup_tpu_torch.ops.kernels import dupwin, mergesort, winsort

torch.set_num_threads(2)

U = 2.0**-24


def _runs(n, max_run, seed):
    """Sorted u32 keys in runs of 1..max_run rows (the k1 of a key sort)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_run + 1, n)
    lens = lens[: np.searchsorted(np.cumsum(lens), n) + 1]
    k1 = np.repeat(np.cumsum(rng.integers(1, 5, len(lens))), lens)[:n]
    return k1.astype(np.uint32), rng


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("depth,order", [
    pytest.param(1, "sorted", id="1"), pytest.param(16, "sorted", id="16"),
    pytest.param(64, "sorted", id="64"), pytest.param(16, "unsorted", id="16-unsorted"),
    pytest.param(64, "unsorted", id="64-unsorted"),
    pytest.param(64, "sorted-then-unsorted", id="64-sorted-then-unsorted"),
])
def test_dupwin_plain_matches_jax_kernel(depth, order):
    """Runs up to 2 * depth + 3 rows (longer than the depth + 1 guarantee),
    a small w alphabet so duplicates occur near and beyond the window.
    "unsorted": the rows shuffled inside groups of 96 (the card kernel's
    full-compare branch); "sorted-then-unsorted": only the second half
    shuffled, so that early tiles are sorted and later ones not."""
    n = 65536
    k1, rng = _runs(n, 2 * depth + 3, seed=depth)
    w = rng.integers(0, max(2, depth // 2), n).astype(np.int32)
    if order != "sorted":
        local = np.argsort(np.arange(n) // 96 + rng.random(n) * 0.5, kind="stable")
        if order == "sorted-then-unsorted":
            local = np.where(np.arange(n) < n // 2, np.arange(n), local)
        k1, w = k1[local], w[local]
    got = dupwin.first_occurrence_flags(
        torch.from_numpy(k1.astype(np.int64)), torch.from_numpy(w), depth
    ).numpy()
    assert got.dtype == bool
    ref = np.asarray(jax_first_occurrence_flags(jnp.asarray(k1), jnp.asarray(w),
                                                depth=depth, interpret=True))
    np.testing.assert_array_equal(got, ref.astype(bool))
    np.testing.assert_array_equal(got, first_occurrence_flags_reference(k1, w, depth).astype(bool))
    assert 0 < (~got).sum() < n


def _winsort_make(n, max_run, seed):
    """tests/test_winsort.py's inputs: k1 runs of 1..max_run rows, 15-bit w."""
    k1, rng = _runs(n, max_run, seed)
    return k1, rng.integers(0, 1 << 15, n).astype(np.uint16)


@pytest.mark.parametrize("max_run", [1, 3, 17, 129])
def test_winsort_plain_matches_jax_kernel(max_run):
    n = 65536
    k1, w = _winsort_make(n, max_run, seed=max_run)
    got = winsort.window_sort_w(
        torch.from_numpy(k1.astype(np.int64)), torch.from_numpy(w.astype(np.int32)), 256
    ).numpy()
    ref = np.asarray(jax_window_sort_w(jnp.asarray(k1), jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(got, ref)


def _jax_window_path(k1, w16, window):
    """The JAX package's window sorts off the TPU (ops/frontend_fused.py,
    sort_mode "hier"): pad, sort [-1, W] rows by (k1, w), again at W/2."""
    n = k1.shape[0]
    pad = (-n) % window
    k1 = jnp.concatenate([k1, jnp.full(pad, 0xFFFFFFFF, jnp.uint32)])
    w16 = jnp.concatenate([w16, jnp.full(pad, 0x7FFF, jnp.uint16)])

    def winsort(a, b):
        a2, b2 = lax.sort((a.reshape(-1, window), b.reshape(-1, window)),
                          dimension=1, num_keys=2)
        return a2.reshape(-1), b2.reshape(-1)

    k1, w16 = winsort(k1, w16)
    half = window // 2
    if k1.shape[0] > window:
        mid_k, mid_w = winsort(k1[half:-half], w16[half:-half])
        k1 = lax.dynamic_update_slice(k1, mid_k, (half,))
        w16 = lax.dynamic_update_slice(w16, mid_w, (half,))
    return np.asarray(k1[:n]), np.asarray(w16[:n])


@pytest.mark.parametrize("n,window,max_run", [(40_000 - 37, 512, 257), (20_011, 256, 300),
                                               (1000, 1024, 40), (50_001, 2048, 1100),
                                               (40_000, 4096, 2100), (9_000, 3000, 1600),
                                               (20_003, 258, 130), (30_001, 4098, 2100),
                                               (70_001, 32_770, 17_000)])
def test_winsort_plain_matches_reference_window_path(n, window, max_run):
    k1, w = _winsort_make(n, max_run, seed=window)
    ref_k1, ref_w = _jax_window_path(jnp.asarray(k1), jnp.asarray(w), window)
    np.testing.assert_array_equal(ref_k1, k1)  # k1 is invariant
    got = winsort.window_sort_w(
        torch.from_numpy(k1.astype(np.int64)), torch.from_numpy(w.astype(np.int32)), window
    ).numpy()
    np.testing.assert_array_equal(got, ref_w.astype(np.int32))


def _merge_cases():
    rng = np.random.default_rng(0)

    def rand(n, hi_max, lo_max):
        return (rng.integers(0, hi_max, n).astype(np.int32),
                rng.integers(0, lo_max, n).astype(np.int32))

    cases = {}
    cases["random-2048"] = (*rand(16384, 1 << 30, 1 << 30), 2048)
    cases["random-4096"] = (*rand(16384, 1 << 30, 1 << 30), 4096)
    cases["heavy-duplicates"] = (*rand(8192, 7, 1 << 30), 2048)
    cases["all-equal"] = (np.full(8192, 5, np.int32), np.full(8192, 9, np.int32), 2048)
    ar = np.arange(8192, dtype=np.int32)
    cases["presorted"] = (ar, np.zeros(8192, np.int32), 2048)
    cases["reversed"] = (ar[::-1].copy(), np.zeros(8192, np.int32), 2048)
    hi, lo = rand(16384, 1 << 30, 1 << 30)
    hi[rng.random(16384) < 0.8] = 0x7FFFFFFF
    cases["sentinel-heavy"] = (hi, lo, 2048)
    base = np.repeat(rng.integers(0, 1 << 20, 64), 16384 // 64)
    cases["morton-clustered"] = ((base + rng.integers(0, 3, 16384)).astype(np.int32),
                                 rng.integers(0, 1 << 10, 16384).astype(np.int32), 2048)
    cases["single-round"] = (*rand(4096, 1 << 30, 1 << 30), 2048)
    skew = np.concatenate([np.arange(4096), 1000000 + np.arange(4096)]).astype(np.int32)
    cases["skewed-coranks"] = (skew, np.zeros(8192, np.int32), 2048)
    cases["skewed-coranks-reversed"] = (skew[::-1].copy(), np.zeros(8192, np.int32), 2048)
    return cases


MERGE_CASES = _merge_cases()


@pytest.mark.parametrize("window", [0, 3, 2049])
def test_winsort_refuses_an_odd_window(window):
    k1 = torch.arange(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="even"):
        winsort.window_sort_w(k1, torch.zeros(10, dtype=torch.int32), window)


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_mergesort_plain_matches_jax_kernel(case):
    hi, lo, block = MERGE_CASES[case]
    got = mergesort.merge_sort_2key(torch.from_numpy(hi), torch.from_numpy(lo), block=block)
    ref = jax_merge_sort_2key(jnp.asarray(hi), jnp.asarray(lo), block=block, interpret=True)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_mergesort_eligibility_and_signed_pairs():
    assert mergesort.merge_sort_eligible(4 * 1024 * 1024)
    assert not mergesort.merge_sort_eligible(3_000_000)
    assert not mergesort.merge_sort_eligible(8192, block=8192)
    with pytest.raises(ValueError):
        mergesort.merge_sort_2key(torch.zeros(3000, dtype=torch.int32),
                                  torch.zeros(3000, dtype=torch.int32))
    # the packed key orders every int32 pair, negative words included
    rng = np.random.default_rng(1)
    hi = rng.integers(-2**31, 2**31, 16384).astype(np.int32)
    lo = rng.integers(-2**31, 2**31, 16384).astype(np.int32)
    hi[::7] = hi[0]
    got = mergesort.merge_sort_2key(torch.from_numpy(hi), torch.from_numpy(lo))
    ref = lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


SPANS = {
    "bench": (4000.0, 4000.0, 36.2),
    "400m": (400.0, 400.0, 120.0),
    "6km": (6000.0, 6000.0, 2000.0),
    "too-long": (200000.0, 100.0, 10.0),
    "60m": (60.0, 60.0, 40.0),
}


@pytest.mark.parametrize("span", list(SPANS))
def test_host_plans_match_jax(span):
    s = SPANS[span]
    assert tff.hier_sort_eligible(s) == jff.hier_sort_eligible(s)
    assert tff.cell_sort_plan(s, eps=8.0) == jff.cell_sort_plan(s, eps=8.0)
    if span == "bench":
        assert tff.cell_sort_plan(s) == (16, 16, 9, 6, 16) and tff.hier_sort_eligible(s)
    if span == "60m":
        assert tff.cell_sort_plan(s)[4] == 0


# ------------------------------------------------------------------ tiles


def _corridor(n, extent, seed=3):
    """tests/test_cell_sort.py's corridor: 80 % ground, 10 % vegetation,
    three towers, centred, n - 37 rows (off every power of two)."""
    towers = ((-120.0, 0.0), (0.0, 40.0), (140.0, -30.0))
    pts, centers = synthetic_corridor(
        np.random.default_rng(seed), n_ground=int(n * 0.8), n_veg=int(n * 0.1),
        towers=towers, pts_per_tower=(n - int(n * 0.9)) // 3, extent=extent,
    )
    xyz = (pts - pts.mean(axis=0)).astype(np.float32)[:-37]
    return xyz, np.ones(len(xyz), bool), centers


JPARAMS = ExtractParams(cluster=ClusterParams(), max_clusters=32)
TPARAMS = state.extract_params_from_dict(dataclasses.asdict(JPARAMS))
CODES = dict(max_cells=8192, min_cell_points=2, geometric_voxels=True, emit="codes",
             return_cells_overflow=True)


@pytest.fixture(scope="module")
def tiles():
    """sparse: every cell run <= 65 rows (both hier windows' guarantee and
    the untight dup window's); small: a 60 m tile whose packed cell key
    holds the whole voxel code (depth 0); dense: runs beyond W/2 + 1."""
    return {"sparse": _corridor(40_000, 1000.0), "small": _corridor(30_000, 60.0),
            "dense": _corridor(120_000, 400.0)}


def _jax_down(xyz, mask, **kw):
    return [np.asarray(r) for r in jff.fused_downsample_ground_cluster(
        jnp.asarray(xyz), jnp.asarray(mask), JPARAMS, **kw)]


def _port_down(xyz, mask, **kw):
    return [r.numpy() for r in tff.fused_downsample_ground_cluster(
        torch.from_numpy(xyz), torch.from_numpy(mask), TPARAMS, **kw)]


@pytest.fixture(scope="module")
def jax_full(tiles):
    return {name: _jax_down(*tiles[name][:2], **CODES) for name in ("sparse", "small")}


def _assert_outputs_equal(got, ref, what):
    assert len(got) == len(ref), what
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, (what, i)
        np.testing.assert_array_equal(g, r, err_msg=f"{what}: output {i}")


def _max_cell_run(xyz):
    v = np.floor((xyz - xyz.min(axis=0)) / 0.1).astype(np.int64) >> 5
    return np.unique((v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2], return_counts=True)[1].max()


@pytest.mark.parametrize("window", [256, 512, 2048])
def test_hier_matches_jax_hier_and_full(tiles, jax_full, window):
    xyz, mask, _ = tiles["sparse"]
    assert _max_cell_run(xyz) <= window // 2 + 1
    ref = _jax_down(xyz, mask, sort_mode="hier", hier_window=window, **CODES)
    got = _port_down(xyz, mask, sort_mode="hier", hier_window=window, **CODES)
    _assert_outputs_equal(got, ref, "hier vs JAX hier")
    _assert_outputs_equal(got, jax_full["sparse"], "hier vs JAX full")


def _step(pkg, xyz, mask, **kw):
    """fused_extract_step of either package; the port takes the sort-based
    OBB, which the JAX package takes on the CPU."""
    if pkg == "jax":
        out = jff.fused_extract_step(jnp.asarray(xyz), jnp.asarray(mask), JPARAMS, **kw)
        return {key: np.asarray(v) for key, v in out.items()}
    return state.to_numpy(tff.fused_extract_step(
        torch.from_numpy(xyz), torch.from_numpy(mask), TPARAMS, obb="sort", **kw))


def _towers(out):
    acc = out["accepted"].astype(bool)
    c = out["center"][acc]
    return c[np.argsort(c[:, 0])]


def test_hier_dense_tile_same_towers(tiles):
    xyz, mask, centers = tiles["dense"]
    assert _max_cell_run(xyz) > 129
    kw = dict(geometric_voxels=True, sort_mode="hier", per_cluster_cap=4096)
    ref = _step("jax", xyz, mask, **kw)
    got = _step("port", xyz, mask, **kw)
    assert float(got["hier_runs_over"]) == float(ref["hier_runs_over"]) > 0
    assert int(got["accepted"].sum()) == int(ref["accepted"].sum()) == len(centers)
    np.testing.assert_allclose(_towers(got), _towers(ref), rtol=0, atol=1e-3)


def _assert_stats_close(got, ref, exact=("count", "alive", "accepted", "aabb_min", "aabb_max")):
    for key in exact:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    alive = ref["alive"]
    bound = 2 * ref["count"][alive, None] * U * np.abs(ref["centroid"][alive]) + 1e-5
    assert (np.abs(got["centroid"][alive] - ref["centroid"][alive]) <= bound).all()
    np.testing.assert_array_equal(got["angle"][alive], ref["angle"][alive], err_msg="angle")
    d_north = np.abs(got["north_angle"][alive] - ref["north_angle"][alive])
    assert (np.minimum(d_north, 360.0 - d_north) <= 1e-3).all()
    coord = np.abs(ref["center"][alive, :2]).max() + ref["extent"][alive, :2].max()
    tol = 4 * float(np.spacing(np.float32(coord)))
    for key in ("center", "extent"):
        np.testing.assert_allclose(got[key][alive], ref[key][alive], rtol=0, atol=tol,
                                   err_msg=key)


CELL_CASES = {"tight-depth16": ("sparse", True), "tight-depth0": ("small", True),
              "untight-depth64": ("sparse", False)}


STEP = dict(geometric_voxels=True, per_cluster_cap=4096)


@pytest.fixture(scope="module")
def jax_full_step(tiles):
    return {name: _step("jax", *tiles[name][:2], **STEP) for name in ("sparse", "small")}


@pytest.mark.parametrize("case", list(CELL_CASES))
def test_cell_matches_jax_cell_and_full(tiles, jax_full, jax_full_step, case):
    name, tight = CELL_CASES[case]
    xyz, mask, centers = tiles[name]
    plan = tff.cell_sort_plan(xyz.max(axis=0) - xyz.min(axis=0)) if tight else None
    assert plan == (jff.cell_sort_plan(xyz.max(axis=0) - xyz.min(axis=0)) if tight else None)
    assert plan is None or plan[4] == (16 if name == "sparse" else 0)
    kw = dict(STEP, sort_mode="cell", cell_plan=plan)
    ref_full = jax_full_step[name]
    ref = _step("jax", xyz, mask, **kw)
    got = _step("port", xyz, mask, **kw)
    assert int(got["accepted"].sum()) == len(centers)
    for other in (ref, ref_full):
        _assert_stats_close(got, other)
        np.testing.assert_allclose(got["center"], other["center"], rtol=0, atol=1e-3)
        for key in ("cells_overflow", "hier_runs_over"):
            assert float(got[key]) == float(other[key]), key
        assert int(got["ground_keep"].sum()) == int(other["ground_keep"].sum())
    # the front-end rows: the same multiset of Morton codes as "full"
    down = _port_down(xyz, mask, sort_mode="cell", cell_plan=plan, **CODES)
    full = jax_full[name]
    rows = np.sort((down[0].astype(np.int64) << 30) | down[1])
    np.testing.assert_array_equal(rows, (full[0].astype(np.int64) << 30) | full[1])


def test_merge_matches_jax(monkeypatch):
    xyz, mask, _ = _corridor(20_000, 300.0, seed=4)
    xyz, mask = xyz[:16384], mask[:16384]
    assert mergesort.merge_sort_eligible(16384)
    ref = _jax_down(xyz, mask, sort_mode="merge", **CODES)
    calls = []
    merge = tff.merge_sort_2key
    monkeypatch.setattr(tff, "merge_sort_2key", lambda *a, **k: calls.append(1) or merge(*a, **k))
    got = _port_down(xyz, mask, sort_mode="merge", **CODES)
    assert calls  # an eligible N goes through the merge sort
    _assert_outputs_equal(got, ref, "merge vs JAX merge")
    # an ineligible N takes the full sort, as the reference routes it
    _assert_outputs_equal(_port_down(xyz[:-5], mask[:-5], sort_mode="merge", **CODES),
                          _jax_down(xyz[:-5], mask[:-5], **CODES), "merge, N off 2**k")


@pytest.mark.parametrize("points_cap", [None, 1024], ids=["no-cap", "cap-spills"])
def test_fused_extract_step_sort_obb_matches_jax(tiles, jax_full_step, points_cap):
    """The JAX package takes the sort-based OBB on the CPU: the port's
    obb="sort" is compared with the JAX function itself."""
    xyz, mask, centers = tiles["sparse"]
    kw = dict(STEP, points_cap=points_cap)
    ref = _step("jax", xyz, mask, **kw) if points_cap else jax_full_step["sparse"]
    got = _step("port", xyz, mask, **kw)
    for key in ("labels", "ground_keep", "base_height", "cells_overflow",
                "hier_runs_over", "overflow"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    _assert_stats_close(got, ref)
    if points_cap:
        assert float(got["overflow"]) > 0
    else:
        assert int(got["accepted"].sum()) == len(centers)


def test_fused_extract_step_centroid_voxels_matches_jax(tiles):
    xyz, mask, centers = tiles["sparse"]
    kw = dict(geometric_voxels=False, per_cluster_cap=4096)
    ref = _step("jax", xyz, mask, **kw)
    got = _step("port", xyz, mask, **kw)
    for key in ("labels", "ground_keep", "base_height", "cells_overflow", "hier_runs_over"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # voxel centroids: the sums of at most c points (c the largest voxel
    # population) in two orders, over c
    v = np.floor((xyz - xyz.min(axis=0)) / 0.1).astype(np.int64)
    c = np.unique((v[:, 0] << 42) | (v[:, 1] << 21) | v[:, 2], return_counts=True)[1].max()
    bound = 2 * c * U * np.abs(xyz).max()
    assert np.abs(got["ds_xyz"] - ref["ds_xyz"]).max() <= bound
    _assert_stats_close(got, ref)
    assert int(got["accepted"].sum()) == len(centers)


def test_emit_xyz_geometric_matches_jax(tiles):
    xyz, mask, _ = tiles["small"]
    kw = dict(max_cells=8192, min_cell_points=2, geometric_voxels=True, emit="xyz")
    _assert_outputs_equal(_port_down(xyz, mask, **kw), _jax_down(xyz, mask, **kw),
                          "emit xyz")


@pytest.mark.parametrize("mode", ["cell", "hier", "merge"])
def test_precut_only_in_full_mode(mode):
    """The reference pre-cuts only in sort_mode "full": another mode keeps
    all N rows whatever precut_div says."""
    n = 131072
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-200, 200, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.normal(0, 0.3, n).astype(np.float32)
    mask = np.ones(n, bool)
    kw = dict(geometric_voxels=True, emit="codes", precut_div=4, _cut=1)
    hi, _ = _port_down(xyz, mask, sort_mode=mode, **kw)
    assert hi.shape == (n,)
    assert _port_down(xyz, mask, sort_mode="full", **kw)[0].shape == (n // 4,)
