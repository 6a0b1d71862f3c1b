"""The port's clustering functions (ops/cluster.py, ops/cluster_grid.py,
ops/cluster_adaptive.py) and ground cuts (ops/ground.py) against the JAX
package's on the same numpy inputs, on the CPU (the plain versions of the
kernels).

Partitions, core masks, keep sets and counts must be identical; labels are
compared as they are (both sides number clusters by min core index); the
eps estimate bit for bit.  Both JAX branches are held: the XLA passes (d2
in the |a|^2 + |b|^2 - 2ab form) and the Pallas neighbor_reduce (d2 from
differences, as the port computes it), run in interpret mode through a
patch of the JAX module's attribute inside the test only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.config import GroundParams
from pointcloudhookup_tpu.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu.ops import cluster as jcluster
from pointcloudhookup_tpu.ops import cluster_adaptive as jadaptive
from pointcloudhookup_tpu.ops import cluster_grid as jgrid
from pointcloudhookup_tpu.ops import ground as jground
from pointcloudhookup_tpu.ops.pallas import neighbor as jneighbor
from pointcloudhookup_tpu_torch.ops import cluster as tcluster
from pointcloudhookup_tpu_torch.ops import cluster_adaptive as tadaptive
from pointcloudhookup_tpu_torch.ops import cluster_grid as tgrid
from pointcloudhookup_tpu_torch.ops import ground as tground
from pointcloudhookup_tpu_torch.ops import segments as tsegments

torch.set_num_threads(2)

CAP = 8192


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, ref):
    """Integer / bool outputs identical."""
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@functools.cache
def _corridor():
    """The ~6.2k-point corridor of tests/conftest.py (seed 42), centred and
    padded to CAP rows, and the JAX ground filter's keep set (eps 5,
    min_points 30 cluster the three towers and some vegetation)."""
    pts, _ = synthetic_corridor(
        np.random.default_rng(42), n_ground=4000, n_veg=800, pts_per_tower=400,
        extent=250.0,
    )
    xyz = np.zeros((CAP, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    mask = np.arange(CAP) < len(pts)
    keep, _ = jground.ground_filter(jnp.asarray(xyz), jnp.asarray(mask),
                                    GroundParams(min_points_after=100))
    return xyz, mask, np.asarray(keep)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's neighbor_reduce in interpret mode (its Pallas
    branch on the CPU), for the duration of one test."""
    monkeypatch.setattr(jneighbor, "neighbor_reduce",
                        functools.partial(jneighbor.neighbor_reduce, interpret=True))


# ------------------------------------------------------------------
# The cell index of grid_dbscan rounds as XLA:CPU does in each context


def _placed_tile(eps):
    """The corridor tile with two groups of 20 rows placed in one cell as
    XLA:CPU assigns it under a constant eps -- it rewrites the division by
    the constant cell = eps / 2 into a product with its f32 reciprocal --
    where the first group's x lies one ulp below a cell edge, so that the
    true quotient (a traced eps) floors it into the cell before (found
    with numpy: such rows exist at eps 6 and 3, not at 5 or 8)."""
    xyz, mask, _ = _corridor()
    mn = xyz[mask].min(axis=0)
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
    z = np.float32(xyz[mask, 2].max() - np.float32(0.5))
    free = np.where(~mask)[0][:40]
    out, m = xyz.copy(), mask.copy()
    out[free] = np.stack([np.r_[np.full(20, x), np.full(20, inside)],
                          np.full(40, y), np.full(40, z)], 1)
    m[free] = True
    return out, m, free


@pytest.mark.parametrize("eps", [6.0, 3.0])
def test_cell_index_rounds_as_xla(eps):
    """grid_dbscan divides by cell = eps / 2.  Under a constant eps (a
    jitted caller closing over it, as extract_step's static params are)
    XLA:CPU multiplies by the f32 reciprocal; under a traced eps
    (adaptive_cluster's, or a jnp scalar) it divides.  At eps 6 and 3 the
    two put the placed group in different cells; with a density floor of
    25 the 40 placed rows form a dense cell, hence a cluster, only if they
    share it.  The port follows a Python eps with the reciprocal and a
    tensor eps with the division."""
    xyz, mask, free = _placed_tile(eps)
    kw = dict(max_cells=4096, min_cell_points=25)
    xj, mj = jnp.asarray(xyz), jnp.asarray(mask)
    recip = jax.jit(lambda x, m: jgrid.grid_dbscan(x, m, eps, 30, **kw))(xj, mj)
    div = jgrid.grid_dbscan(xj, mj, jnp.float32(eps), 30, **kw)
    lab_recip, lab_div = np.asarray(recip[0])[free], np.asarray(div[0])[free]
    assert (lab_recip >= 0).all() and len(set(lab_recip)) == 1
    assert (lab_div == -1).all()  # the two contexts really differ here
    _same(tgrid.grid_dbscan(_t(xyz), _t(mask), eps, 30, **kw), recip)
    _same(tgrid.grid_dbscan(_t(xyz), _t(mask), torch.tensor(eps), 30, **kw), div)


# ------------------------------------------------------------------
# grid_dbscan


def _cells_at_eps(xyz, mask, eps, rows, divide=False):
    """For each given row, whether its eps/2 cell (as a constant eps rounds
    it, or a traced one with divide) has an occupied cell two cells away
    along one axis: a cell pair at exactly eps in exact arithmetic, which
    the two d2 forms may decide differently once the centres are rounded
    to f32."""
    mn = xyz[mask].min(axis=0)
    cell = np.float32(eps) / np.float32(2.0)
    q = (xyz - mn) / cell if divide else (xyz - mn) * (np.float32(1.0) / cell)
    ijk = np.floor(q).astype(np.int64)
    occupied = {tuple(c) for c in ijk[mask]}
    near = []
    for r in rows:
        offs = [np.eye(3, dtype=np.int64)[a] * s for a in range(3) for s in (2, -2)]
        near.append(any(tuple(ijk[r] + o) in occupied for o in offs))
    return np.array(near)


@pytest.mark.parametrize("branch", ["xla", "pallas"])
@pytest.mark.parametrize("eps", [5.0, 8.0, 7.3])
def test_grid_dbscan_matches_both_jax_branches(request, branch, eps):
    """Labels identical to the JAX function's XLA branch and its Pallas
    branch (interpret mode), with a constant eps as extract_step passes
    it; the overflow count too.  Core masks are identical to the Pallas
    branch, which computes d2 from differences as the port does.  The XLA
    branch's |a|^2 + |b|^2 - 2ab form decides cell pairs at exactly eps
    (two cells apart on one axis) differently where eps / 2 is not exact
    in f32: at eps 7.3 two rows of this tile lose their core flag there
    (labels unchanged).  That is the standing deviation of ROADMAP.md
    section 3; the test pins it to such rows."""
    if branch == "pallas":
        request.getfixturevalue("pallas_interpret")
    xyz, _, keep = _corridor()
    ref = jax.jit(lambda x, m: jgrid.grid_dbscan(
        x, m, eps, 30, max_cells=4096, use_pallas=branch == "pallas",
        return_overflow=True))(jnp.asarray(xyz), jnp.asarray(keep))
    got = tgrid.grid_dbscan(_t(xyz), _t(keep), eps, 30, max_cells=4096)
    _same(got[:1], ref[:1])
    assert float(got[2]) == float(ref[2]) == 0.0
    assert len(set(np.asarray(ref[0]).tolist()) - {-1}) >= 3
    differ = np.nonzero(got[1].numpy() != np.asarray(ref[1]))[0]
    if branch == "pallas" or eps in (5.0, 8.0):
        assert differ.size == 0
    else:
        assert 0 < differ.size <= 4, differ
        assert _cells_at_eps(xyz, keep, eps, differ).all()


@pytest.mark.parametrize("max_cells,floor", [(1024, 1), (1024, 2), (2048, 1)])
def test_grid_dbscan_cells_overflow(max_cells, floor):
    """A table too small for the dense cells drops the cells past it in
    cell order: labels, core and the overflow count as the JAX function's."""
    xyz, mask, _ = _corridor()
    kw = dict(max_cells=max_cells, min_cell_points=floor)
    ref = jax.jit(lambda x, m: jgrid.grid_dbscan(x, m, 5.0, 30, return_overflow=True,
                                                 **kw))(jnp.asarray(xyz), jnp.asarray(mask))
    got = tgrid.grid_dbscan(_t(xyz), _t(mask), 5.0, 30, **kw)
    _same(got[:2], ref[:2])
    assert float(got[2]) == float(ref[2])
    if (max_cells, floor) == (1024, 1):
        assert float(ref[2]) > 0


def test_boundary_flags_matches_jax():
    from pointcloudhookup_tpu.ops.segments import boundary_flags

    rng = np.random.default_rng(4)
    keys = [np.sort(rng.integers(0, 5, 3000)).astype(np.int32) for _ in range(3)]
    ref = boundary_flags(*map(jnp.asarray, keys))
    got = tsegments.boundary_flags(*map(_t, keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------------
# dbscan, dbscan_chunked, merge_cluster_fragments


@pytest.mark.parametrize("branch", ["xla", "pallas"])
def test_dbscan_matches_both_jax_branches(request, branch):
    if branch == "pallas":
        request.getfixturevalue("pallas_interpret")
    xyz, _, keep = _corridor()
    ref = jcluster.dbscan(jnp.asarray(xyz), jnp.asarray(keep), 5.0, 30,
                          use_pallas=branch == "pallas")
    got = tcluster.dbscan(_t(xyz), _t(keep), 5.0, 30)
    _same(got, ref)
    assert len(set(np.asarray(ref[0]).tolist()) - {-1}) >= 3


def test_dbscan_all_noise():
    rng = np.random.default_rng(42)
    xyz = np.zeros((256, 3), np.float32)
    xyz[:100] = rng.uniform(-500, 500, size=(100, 3))
    mask = np.arange(256) < 100
    ref = jcluster.dbscan(jnp.asarray(xyz), jnp.asarray(mask), 1.0, 10, tile=256)
    got = tcluster.dbscan(_t(xyz), _t(mask), 1.0, 10)
    _same(got, ref)
    assert (got[0] == -1).all() and not got[1].any()


def _chunk_split_case():
    """tests/test_cluster.py's case: one spatial cluster whose points are
    split across two 256-row chunks."""
    rng = np.random.default_rng(42)
    cluster = rng.normal(0, 1.0, size=(200, 3)).astype(np.float32)
    xyz = np.zeros((512, 3), np.float32)
    mask = np.zeros(512, bool)
    xyz[:100] = cluster[:100]
    mask[:100] = True
    xyz[256:356] = cluster[100:]
    mask[256:356] = True
    return xyz, mask


def test_dbscan_chunked_and_merge_match_jax():
    """Chunked clustering fragments the cluster (labels offset by the chunk
    start), the merge heals it: both as the JAX functions; the merged
    partition identical, its centroids within f32 summation order."""
    xyz, mask = _chunk_split_case()
    ref_l, ref_c = jcluster.dbscan_chunked(jnp.asarray(xyz), jnp.asarray(mask), 4.0, 10,
                                           chunk_size=256, tile=256)
    got_l, got_c = tcluster.dbscan_chunked(_t(xyz), _t(mask), 4.0, 10, chunk_size=256)
    _same((got_l, got_c), (ref_l, ref_c))
    assert set(got_l[256:356].tolist()) == {256}
    ref_m = jcluster.merge_cluster_fragments(ref_l, jnp.asarray(xyz), jnp.asarray(mask),
                                             6.0, max_clusters=512)
    got_m = tcluster.merge_cluster_fragments(got_l, _t(xyz), _t(mask), 6.0,
                                             max_clusters=512)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    assert set(got_m[:100].tolist()) == set(got_m[256:356].tolist()) == {0}


def test_dbscan_chunked_on_the_corridor():
    """The reference-parity mode at 4,096-row chunks of the corridor tile
    (chunks split the towers' rows): identical to the JAX function."""
    xyz, _, keep = _corridor()
    ref = jcluster.dbscan_chunked(jnp.asarray(xyz), jnp.asarray(keep), 5.0, 30,
                                  chunk_size=4096)
    got = tcluster.dbscan_chunked(_t(xyz), _t(keep), 5.0, 30, chunk_size=4096)
    _same(got, ref)


def test_merge_cluster_fragments_many_clusters():
    """Fragments of 12 blobs (ids up to 200, some near each other) merge as
    the JAX function merges them."""
    rng = np.random.default_rng(8)
    centres = rng.uniform(-60, 60, size=(12, 3)).astype(np.float32)
    lab = rng.integers(-1, 200, 3000).astype(np.int32)
    xyz = (centres[np.abs(lab) % 12] + rng.normal(0, 1.0, (3000, 3))).astype(np.float32)
    mask = rng.random(3000) < 0.9
    ref = jcluster.merge_cluster_fragments(jnp.asarray(lab), jnp.asarray(xyz),
                                           jnp.asarray(mask), 20.0, max_clusters=256)
    got = tcluster.merge_cluster_fragments(_t(lab), _t(xyz), _t(mask), 20.0,
                                           max_clusters=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_reference_rounds_have_converged():
    """The JAX loops stop after max_iters=64 rounds; the port computes the
    converged fixpoint.  On the tiles these tests cluster (dbscan on the
    ground-cut corridor; grid_dbscan there at every eps used, on the whole
    tile, on the placed tiles and at adaptive_cluster's eps), the JAX
    functions give the same result at 64 rounds and at 10,000, so the
    parity does not lean on an unconverged reference."""
    xyz, mask, keep = _corridor()
    eps_adaptive = jadaptive.adaptive_cluster(jnp.asarray(xyz), jnp.asarray(keep), 12,
                                              max_cells=4096)[2]
    grid = functools.partial(jgrid.grid_dbscan, max_cells=4096)
    cases = [(jcluster.dbscan, xyz, keep, 5.0, 30)]
    cases += [(grid, xyz, keep, e, 30) for e in (5.0, 8.0, 7.3)]
    cases += [(grid, xyz, keep, eps_adaptive, 12), (grid, xyz, mask, 5.0, 30)]
    cases += [(grid, *_placed_tile(e)[:2], e, 30) for e in (6.0, 3.0)]
    for fn, x, m, eps, min_points in cases:
        xj, mj = jnp.asarray(x), jnp.asarray(m)
        a = fn(xj, mj, eps, min_points, max_iters=64)
        b = fn(xj, mj, eps, min_points, max_iters=10_000)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("name", ["dbscan", "dbscan_chunked", "grid_dbscan"])
def test_max_iters_64_matches_jax(pallas_interpret, name):
    """The port's max_iters on the CPU bounds the plain version's rounds;
    at the JAX default of 64 it gives the unbounded fixpoint and the JAX
    function's result at max_iters=64 on the corridor tile (dbscan and
    grid_dbscan on their Pallas branch, dbscan_chunked on the XLA passes it
    always takes).  On the card a bound below the rows of one
    cluster_cells call raises:
    tests/test_torch_cuda.py::test_modular_clustering_max_iters_cuda."""
    xyz, _, keep = _corridor()
    xj, kj = jnp.asarray(xyz), jnp.asarray(keep)
    if name == "dbscan":
        tfn = functools.partial(tcluster.dbscan, eps=5.0, min_points=30)
        ref = jcluster.dbscan(xj, kj, 5.0, 30, max_iters=64, use_pallas=True)
    elif name == "dbscan_chunked":
        tfn = functools.partial(tcluster.dbscan_chunked, eps=5.0, min_points=30,
                                chunk_size=4096)
        ref = jcluster.dbscan_chunked(xj, kj, 5.0, 30, chunk_size=4096, max_iters=64)
    else:  # a constant eps, as extract_step passes it
        tfn = functools.partial(tgrid.grid_dbscan, eps=7.3, min_points=30, max_cells=4096)
        ref = jax.jit(lambda x, m: jgrid.grid_dbscan(
            x, m, 7.3, 30, max_cells=4096, max_iters=64, use_pallas=True))(xj, kj)
    got = tfn(_t(xyz), _t(keep), max_iters=64)
    for g, u in zip(got, tfn(_t(xyz), _t(keep))):
        assert torch.equal(g, u)
    _same(got[:2], ref[:2])
    assert len(set(np.asarray(ref[0]).tolist()) - {-1}) >= 3


# ------------------------------------------------------------------
# adaptive clustering


@pytest.mark.parametrize("min_points,fallback", [(30, 5.0), (80, None), (12, None)])
def test_adaptive_cluster_matches_jax(min_points, fallback):
    """eps bit for bit (k-th-NN d2 and the quantile's lerp with fused
    multiply-adds, as XLA:CPU rounds them).  The JAX function's grid_dbscan
    takes its XLA branch on the CPU: at a data-derived eps the cell pairs
    at exactly eps (two cells apart on one axis) may be decided otherwise
    there (ROADMAP.md section 3).  At min_points 30 and 80 that moves core
    flags only; at 12 (vegetation-level clusters) also 4 border rows'
    labels.  Every row that differs lies in such a cell;
    test_adaptive_cluster_matches_pallas_branch holds labels and core
    exactly against the branch that computes d2 as the port does."""
    xyz, _, keep = _corridor()
    ref = jadaptive.adaptive_cluster(jnp.asarray(xyz), jnp.asarray(keep), min_points,
                                     max_cells=4096, eps_fallback=fallback)
    got = tadaptive.adaptive_cluster(_t(xyz), _t(keep), min_points, max_cells=4096,
                                     eps_fallback=fallback)
    assert got[2].dtype == torch.float32 and got[2].dim() == 0
    assert np.float32(got[2]).view(np.uint32) == np.asarray(ref[2]).view(np.uint32)
    lab_differ = np.nonzero(got[0].numpy() != np.asarray(ref[0]))[0]
    assert lab_differ.size <= (4 if min_points == 12 else 0), lab_differ
    differ = np.nonzero(got[1].numpy() != np.asarray(ref[1]))[0]
    assert differ.size <= 32, differ
    rows = np.union1d(differ, lab_differ)
    assert _cells_at_eps(xyz, keep, float(got[2]), rows, divide=True).all()


def test_adaptive_cluster_matches_pallas_branch(monkeypatch, pallas_interpret):
    """The JAX function with its grid_dbscan on the Pallas branch (d2 from
    differences, as the port computes it) at min_points 12, where the XLA
    branch moves labels: labels, core and eps identical."""
    monkeypatch.setattr(jgrid, "grid_dbscan",
                        functools.partial(jgrid.grid_dbscan, use_pallas=True))
    xyz, _, keep = _corridor()
    ref = jadaptive.adaptive_cluster(jnp.asarray(xyz), jnp.asarray(keep), 12,
                                     max_cells=4096)
    got = tadaptive.adaptive_cluster(_t(xyz), _t(keep), 12, max_cells=4096)
    assert np.float32(got[2]).view(np.uint32) == np.asarray(ref[2]).view(np.uint32)
    _same(got[:2], ref[:2])


@pytest.mark.parametrize("seed", range(6))
def test_estimate_eps_bit_equal(seed):
    """The eps estimate on random clouds, sample sizes and quantiles."""
    rng = np.random.default_rng(seed)
    n, s = 1024, int(rng.choice([256, 300, 1024]))
    xyz = (rng.normal(size=(n, 3)) * rng.uniform(1, 300, 3)).astype(np.float32)
    mask = rng.random(n) < 0.8
    k, q = int(rng.integers(1, 30)), float(rng.choice([60.0, 25.0, 33.3, 90.0]))
    ref = jadaptive.estimate_eps(jnp.asarray(xyz), jnp.asarray(mask), k=k, sample=s,
                                 quantile=q)
    got = tadaptive.estimate_eps(_t(xyz), _t(mask), k=k, sample=s, quantile=q)
    assert np.float32(got).view(np.uint32) == np.asarray(ref).view(np.uint32)


def test_filter_small_clusters_matches_jax():
    rng = np.random.default_rng(2)
    lab = np.where(rng.random(5000) < 0.2, -1,
                   rng.zipf(1.5, 5000).clip(0, 4095)).astype(np.int32)
    ref = jadaptive._filter_small_clusters(jnp.asarray(lab), 7, max_labels=4096)
    got = tadaptive._filter_small_clusters(_t(lab), 7, max_labels=4096)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------------
# ground cuts


@pytest.mark.parametrize("min_after", [100, 10**6], ids=["offset", "retry-offset"])
def test_ground_filter_matches_jax(min_after):
    """Base bit for bit and the keep set identical, with the first offset
    and with the retry offset (too few survivors)."""
    xyz, mask, _ = _corridor()
    gp = GroundParams(min_points_after=min_after)
    ref_k, ref_b = jground.ground_filter(jnp.asarray(xyz), jnp.asarray(mask), gp)
    got_k, got_b = tground.ground_filter(_t(xyz), _t(mask), gp)
    assert np.float32(got_b).view(np.uint32) == np.asarray(ref_b).view(np.uint32)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(ref_k))


@pytest.mark.parametrize("percentile,offset", [(10.0, 4.0), (37.5, 0.5)])
def test_percentile_cut_matches_jax(percentile, offset):
    xyz, mask, _ = _corridor()
    ref = jground.percentile_cut(jnp.asarray(xyz), jnp.asarray(mask), percentile, offset)
    got = tground.percentile_cut(_t(xyz), _t(mask), percentile, offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
