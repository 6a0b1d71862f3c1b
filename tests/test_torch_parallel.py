"""The port's sharded extraction (``parallel/``) on gloo ranks on the CPU
against the JAX package's ``make_sharded_extract`` on the virtual
8-device mesh (tests/conftest.py), from the same seeded numpy inputs: one
test for each of tests/test_parallel.py's ten, and the pieces the step is
built from.  The ranks are spawned processes (``parallel.launch.
run_ranks``, which imports no JAX); the module's four-rank work runs in one
launch.

Tolerances and why:
  * ``base_height``, the histogram, the bisection percentile, the merge
    of gathered accumulators and the fragment union are bit-equal to the
    jitted JAX functions: integers, min/max and the same f32 operations in
    the same order (the histogram's fused multiply-adds as XLA:CPU
    contracts them);
  * accepted towers, per-cluster counts and (raw coordinates: the modular
    and exact steps) z extents are equal: the partitions are the JAX
    package's (the modular step's d^2 from
    differences is the standing deviation of ROADMAP section 3; it moves no
    partition here);
  * centres and extents within 1e-3 m: the OBB projections' cos/sin
    tables differ by one ulp at some angles and XLA:CPU contracts the
    projections, so u/v extremes differ in the last bits (test_torch_
    kernels.py), centroid sums are added in another order, and the fast
    step's voxel centres round once as on the TPU (ix * vs + (mn + vs/2)),
    where the JAX CPU oracle adds twice (one ulp);
  * the multi-rank run against one rank: the same accepted towers and
    centres within 1 cm, the gate of ``dryrun_multichip``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pointcloudhookup_tpu.config import ClusterParams, ExtractParams, GroundParams
from pointcloudhookup_tpu.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu.ops import frontend_exact as jfe
from pointcloudhookup_tpu.ops import obb as jobb
from pointcloudhookup_tpu.ops import percentile as jpct
from pointcloudhookup_tpu.ops.pallas.obb_accum import obb_accumulate_xyz_reference
from pointcloudhookup_tpu.parallel import sharded as jsh
from pointcloudhookup_tpu_torch import entry, state
from pointcloudhookup_tpu_torch.ops import frontend_exact as tfe
from pointcloudhookup_tpu_torch.ops import obb as tobb
from pointcloudhookup_tpu_torch.ops import percentile as tpct
from pointcloudhookup_tpu_torch.parallel import launch, sharded as tsh
from test_torch_cuda import assert_acc_close

torch.set_num_threads(2)

N_DEV = 4
CENTRE_TOL = 1e-3
SEEDS = (0, 1, 2, 3, 4, 5)


def _jparams():
    return ExtractParams(
        ground=GroundParams(min_points_after=64),
        cluster=ClusterParams(eps=5.0, min_points=16),
        max_clusters=16,
        obb_angles=32,
    )


def _tparams(p=None):
    return state.extract_params_from_dict(dataclasses.asdict(p or _jparams()))


def _make_inputs(rng, n_dev, per_shard=1024):
    """tests/test_parallel.py's corridor: one spatial tile with one tower
    a shard."""
    total = per_shard * n_dev
    xyz = np.zeros((total, 3), np.float32)
    mask = np.zeros(total, bool)
    centers = []
    for d in range(n_dev):
        pts, c = synthetic_corridor(
            rng, n_ground=per_shard - 300, n_veg=0, towers=((0.0, 0.0),),
            pts_per_tower=280, extent=120.0, origin=(d * 300.0, 0.0, 0.0),
        )
        pts = pts[:per_shard]
        xyz[d * per_shard : d * per_shard + len(pts)] = pts
        mask[d * per_shard : d * per_shard + len(pts)] = True
        centers.append(c[0])
    return xyz, mask, np.array(centers)


def _boundary_merge_inputs(rng):
    """test_sharded_merge_unifies_boundary_tower's corridor: shard 0's
    tower copied over 280 of shard 1's ground rows."""
    xyz, mask, centers = _make_inputs(rng, N_DEV)
    xyz[1024:1304] = xyz[724:1004]
    mask[1024:1304] = mask[724:1004]
    return xyz, mask, centers


def _ground_inputs(seed):
    rng = np.random.default_rng(seed)
    n = N_DEV * 1024
    xyz = rng.normal(0.0, 20.0, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.gamma(2.0, rng.uniform(0.5, 8.0), n) - rng.uniform(0, 30)
    mask = rng.random(n) < rng.uniform(0.3, 1.0)
    mask[:: 1024] = True  # every shard holds a valid row
    return xyz, mask


def _p11_params(port=False):
    """chip_smoke.py phase 11's parameters (method grid, floor 3) with the
    tables cut to what the JAX CPU oracles hold: its raw accumulators are
    dense [N, K, A] (17 GB a temporary at the default K 128, A 256 and
    131,072 rows) and its grid neighbour passes O(max_cells^2); no cell,
    cluster or halo table overflows here (asserted)."""
    p = ExtractParams(cluster=ClusterParams(method="grid", min_cell_points=3, max_cells=4096),
                      max_clusters=64, obb_angles=16)
    return _tparams(p) if port else p


def _p11_inputs():
    """Phase 11's small corridor (4 x 32,768 rows, sorted by x, towers on
    the slab edges), centred as the phase centres it."""
    from chip_smoke import SHARDED_SMALL, SEED, sharded_corridor

    pts, _ = sharded_corridor(N_DEV * SHARDED_SMALL, SEED + 1)
    xyz = (pts - pts.mean(axis=0)).astype(np.float32)
    bits = jfe.exact_cell_plan(pts.max(axis=0) - pts.min(axis=0), _p11_params().cluster.eps)
    assert bits is not None
    return xyz, np.ones(len(xyz), bool), bits


def _exact_inputs():
    xyz, mask, planted = entry._boundary_corridor(8192, n_towers=4, seed=5)
    span = xyz[mask].max(axis=0) - xyz[mask].min(axis=0)
    bits = jfe.exact_cell_plan(span, _jparams().cluster.eps)
    assert bits is not None and bits == tfe.exact_cell_plan(span, 5.0)
    return xyz, mask, planted, bits


def _shards(a, n):
    return np.split(a, n)


def _rank_part(values, r):
    """Rank r's part of each array among values (rows split N_DEV ways)."""
    return tuple(_shards(a, N_DEV)[r] if isinstance(a, np.ndarray) else a for a in values)


def _step(xyz_mask, params, **options):
    """A ``launch.call_on_rank`` call that builds this rank's sharded step
    with these options and runs it once on (xyz, mask)."""
    return (tsh.make_sharded_extract, (), dict(params=params, **options), tuple(xyz_mask))


# ------------------------------------------------------------------
# The JAX side


def _jax_sharded(xyz, mask, n_dev, params=None, **kw):
    """make_sharded_extract on an n-device mesh: (labels, merged) as numpy."""
    step, sh = jsh.make_sharded_extract(jsh.tile_mesh(n_dev), params or _jparams(), **kw)
    labels, merged = step(jax.device_put(jnp.asarray(xyz), sh), jax.device_put(jnp.asarray(mask), sh))
    return np.asarray(labels), {k: np.asarray(v) for k, v in merged.items()}


def _jax_on_mesh(fn, n_dev, *args, out_specs=P()):
    """fn(*shards) under shard_map over n devices (rows split on axis 0)."""
    f = jax.jit(jax.shard_map(fn, mesh=jsh.tile_mesh(n_dev), in_specs=(P(jsh.AXIS),) * len(args),
                              out_specs=out_specs, check_vma=False))
    return jax.tree.map(np.asarray, f(*map(jnp.asarray, args)))


# ------------------------------------------------------------------
# The port's side: one launch of N_DEV gloo ranks for the whole module


@pytest.fixture(scope="module")
def port4():
    """Every four-rank computation of this module, in one launch: a dict
    name -> [per-rank results]."""
    tp = _tparams()
    rng = np.random.default_rng(42)
    towers = _make_inputs(rng, N_DEV)
    merge = _boundary_merge_inputs(np.random.default_rng(42))
    xe, me, _, bits = _exact_inputs()
    jobs = {}
    for seed in SEEDS:
        x, m = _ground_inputs(seed)
        jobs[f"ground{seed}"] = (tsh._global_ground_base, (x, m, tp), {})
        jobs[f"bisect{seed}"] = (tpct.masked_percentile_bisect, (x[:, 2], m, 25.0 + seed), {})
    jobs["modular"] = _step(towers[:2], tp)
    jobs["fast"] = _step(towers[:2], tp, mode="fast")
    jobs["merge"] = _step(merge[:2], tp, merge_radius=6.0)
    jobs["exact"] = _step((xe, me), tp, mode="exact", exact_cell_bits=bits)
    xp, mp, bp = _p11_inputs()
    for mode in ("modular", "fast", "exact"):
        jobs[f"p11_{mode}"] = _step((xp, mp), _p11_params(True), mode=mode, exact_cell_bits=bp)
    jobs["exact_graph"] = (tfe.exact_extract_graph, (xe, me, tp),
                           dict(cell_bits=bits, compact_cap=1024, max_cells=1024,
                                local_rows=1536, return_acc=True))
    names = list(jobs)
    rank_calls = []
    for r in range(N_DEV):
        calls = []
        for name in names:
            fn, args, kw, *step_args = jobs[name]
            calls.append((fn, _rank_part(args, r), kw, *(_rank_part(a, r) for a in step_args)))
        rank_calls.append((calls,))
    out = launch.run_ranks(launch.call_on_rank, rank_calls, backend="gloo", devices="cpu",
                           timeout=600)
    return {name: [out[r][i] for r in range(N_DEV)] for i, name in enumerate(names)}


def _replicated(per_rank):
    """The merged dict, after checking every rank's is bit-identical."""
    merged = per_rank[0][1]
    for r in range(1, len(per_rank)):
        for key, val in merged.items():
            np.testing.assert_array_equal(per_rank[r][1][key], val, err_msg=(r, key))
    return merged


def _same_towers(got, ref, tol=CENTRE_TOL, exact_z=True):
    """Accepted rows and counts equal, z extents too where the rows are raw
    coordinates (exact_z); centres and extents within tol."""
    np.testing.assert_array_equal(got["accepted"], ref["accepted"])
    np.testing.assert_array_equal(got["count"], ref["count"])
    acc = ref["accepted"]
    if exact_z:
        np.testing.assert_array_equal(got["extent"][acc, 2], ref["extent"][acc, 2])
    np.testing.assert_allclose(got["center"][acc], ref["center"][acc], atol=tol)
    np.testing.assert_allclose(got["extent"][acc], ref["extent"][acc], atol=tol)
    assert got["base_height"].tobytes() == ref["base_height"].tobytes()
    # the merge test's copied tower overlaps two slabs: its halo overflows,
    # in both packages alike
    assert float(got["cells_overflow"]) == float(ref["cells_overflow"])
    assert float(got["halo_overflow"]) == float(ref["halo_overflow"])


# ------------------------------------------------------------------
# tests/test_parallel.py's ten


def test_sharded_extract_runs_and_finds_towers(port4):
    xyz, mask, centers = _make_inputs(np.random.default_rng(42), N_DEV)
    merged = _replicated(port4["modular"])
    _, ref = _jax_sharded(xyz, mask, N_DEV)
    _same_towers(merged, ref)
    got = np.sort(merged["center"][merged["accepted"]][:, 0])
    np.testing.assert_allclose(got, np.sort(centers[:, 0]), atol=2.5)
    # labels of each rank's rows: the JAX partition, up to cluster ids
    labels = np.concatenate([port4["modular"][r][0] for r in range(N_DEV)])
    jlabels, _ = _jax_sharded(xyz, mask, N_DEV)
    np.testing.assert_array_equal(labels >= 0, jlabels >= 0)


def test_sharded_extract_fast_path(port4):
    xyz, mask, centers = _make_inputs(np.random.default_rng(42), N_DEV)
    merged = _replicated(port4["fast"])
    _, ref = _jax_sharded(xyz, mask, N_DEV, fast=True)
    # voxel centres: the port decodes ix * vs + (mn + vs / 2) as the TPU
    # kernel does, the JAX CPU oracle adds mn and vs / 2 apart (one ulp)
    _same_towers(merged, ref, exact_z=False)
    got = np.sort(merged["center"][merged["accepted"]][:, 0])
    np.testing.assert_allclose(got, np.sort(centers[:, 0]), atol=2.5)


def test_sharded_merge_unifies_boundary_tower(port4):
    xyz, mask, centers = _boundary_merge_inputs(np.random.default_rng(42))
    merged = _replicated(port4["merge"])
    assert int(merged["accepted"].sum()) == len(centers)
    _, ref = _jax_sharded(xyz, mask, N_DEV, merge_radius=6.0)
    _same_towers(merged, ref)


def test_graft_entry_single_chip():
    """entry() on the CPU: the modular step finds the example batch's three
    towers (synthetic_corridor's defaults), each within 2 m (xy) of its
    centroid."""
    fn, (xyz, mask) = entry.entry("cpu")
    out = fn(xyz, mask)
    assert "accepted" in out
    acc = out["accepted"].numpy()
    rng = np.random.default_rng(0)
    pts, centers = synthetic_corridor(rng, n_ground=45000, n_veg=6000, pts_per_tower=3000,
                                      extent=400.0)
    want = (centers - pts[:60000].mean(axis=0))[:, :2]
    got = out["centroid"].numpy()[acc][:, :2]
    assert len(got) == len(want)
    assert np.linalg.norm(want[:, None] - got[None], axis=2).min(axis=1).max() < 2.0


def test_graft_dryrun_multichip():
    """dryrun_multichip(8) on gloo ranks (it raises unless 8 ranks and one
    agree), against the JAX fast step on the 8-device mesh."""
    got = entry.dryrun_multichip(8, backend="gloo", device="cpu")
    xyz, mask, _ = entry._boundary_corridor(16384, 6)
    p = dataclasses.replace(
        _jparams(), cluster=dataclasses.replace(_jparams().cluster, method="grid"),
        filters=dataclasses.replace(_jparams().filters, min_width=5.0), max_clusters=32,
        obb_angles=16,
    )
    _, ref = _jax_sharded(xyz, mask, 8, params=p, fast=True)
    want = ref["center"][ref["accepted"]]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=CENTRE_TOL)


def test_sharded_exact_mode_matches_single_device(port4):
    """4 ranks against one rank and against the JAX exact step on the
    4-device mesh; the planted towers are found."""
    xyz, mask, planted, bits = _exact_inputs()
    merged = _replicated(port4["exact"])
    _, ref = _jax_sharded(xyz, mask, N_DEV, mode="exact", exact_cell_bits=bits)
    _same_towers(merged, ref)
    assert float(merged["halo_overflow"]) == 0.0
    one = launch.run_ranks(
        launch.call_on_rank,
        [([_step((xyz, mask), _tparams(), mode="exact", exact_cell_bits=bits)],)],
        backend="gloo", devices="cpu", timeout=300,
    )[0][0][1]
    c_multi = merged["center"][merged["accepted"]]
    c_single = one["center"][one["accepted"]]
    assert len(c_multi) == len(c_single) == 4
    for c in c_multi:
        assert np.linalg.norm(c_single - c[None], axis=1).min() < 0.01
    for tc in planted:
        assert np.linalg.norm(c_multi[:, :2] - tc[None, :2], axis=1).min() < 3.0


@pytest.fixture(scope="module")
def p11_one():
    """The phase-11 corridor's step on one rank, each mode."""
    xyz, mask, bits = _p11_inputs()
    calls = [_step((xyz, mask), _p11_params(True), mode=m, exact_cell_bits=bits)
             for m in ("modular", "fast", "exact")]
    out = launch.run_ranks(launch.call_on_rank, [(calls,)], backend="gloo", devices="cpu",
                           timeout=300)[0]
    return {m: out[i][1] for i, m in enumerate(("modular", "fast", "exact"))}


def _pair_towers(a, b):
    """Accepted towers of two runs paired by nearest member centroid:
    (a's rows, b's rows) of the accepted entries."""
    ia, ib = np.nonzero(a["accepted"])[0], np.nonzero(b["accepted"])[0]
    assert len(ia) == len(ib)
    j = [ib[np.argmin(np.linalg.norm(b["centroid"][ib] - a["centroid"][i], axis=1))] for i in ia]
    assert len(set(j)) == len(j)
    return ia, np.array(j)


@pytest.mark.parametrize("mode", ["modular", "fast", "exact"])
def test_phase11_corridor_matches_jax(port4, p11_one, mode):
    """chip_smoke.py phase 11's small corridor: the port's 4 ranks hold the
    JAX package's 4-device run, and its 1 rank the 1-device run (the same
    accepted towers and member counts, box centres, extents and member
    centroids within 1e-3 m, base_height bit-equal).  So where 4 ranks and 1 differ (box
    centres, counts: the per-rank grid anchors of the modular and fast
    steps, the fast step's ghosts counted twice, the exact step's ghost
    cells beyond eps from the slab unsure of their core state), the JAX
    package's 4 devices and 1 differ alike, tower by tower, within 2e-3 m."""
    xyz, mask, bits = _p11_inputs()
    p = _p11_params()
    got4, got1 = _replicated(port4[f"p11_{mode}"]), p11_one[mode]
    _, ref4 = _jax_sharded(xyz, mask, N_DEV, params=p, mode=mode, exact_cell_bits=bits)
    _, ref1 = _jax_sharded(xyz, mask, 1, params=p, mode=mode, exact_cell_bits=bits)
    for got, ref in ((got4, ref4), (got1, ref1)):
        # every planted tower, so no cluster was lost past max_clusters
        assert ref["accepted"].sum() == 23
        assert float(ref["cells_overflow"]) == float(ref["halo_overflow"]) == 0.0
        _same_towers(got, ref, exact_z=mode != "fast")
        acc = ref["accepted"]
        np.testing.assert_allclose(got["centroid"][acc], ref["centroid"][acc], atol=CENTRE_TOL)
    a, b = _pair_towers(ref4, ref1)
    assert (_pair_towers(got4, got1)[1] == b).all()
    np.testing.assert_allclose(got4["center"][a] - got1["center"][b],
                               ref4["center"][a] - ref1["center"][b], atol=2 * CENTRE_TOL)
    np.testing.assert_array_equal(got4["count"][a] - got1["count"][b],
                                  ref4["count"][a] - ref1["count"][b])


def test_sharded_exact_mode_requires_plan():
    with pytest.raises(ValueError, match="exact_cell_bits"):
        tsh.make_sharded_extract(None, _tparams(), mode="exact")
    with pytest.raises(ValueError, match="modular/fast/exact"):
        tsh.make_sharded_extract(None, _tparams(), mode="dense")


def _split_accumulators(rng, k, a):
    pts = rng.normal(0.0, 5.0, (400, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.0, 40.0, 400).astype(np.float32)
    lab_split = np.where(np.arange(400) < 250, 1, 5).astype(np.int32)
    return pts, lab_split


def test_merge_accumulators_exact(rng):
    """Two fragments of one cluster merge into the accumulators of the
    whole (sums to f32 order, extremes exactly), bit-equal to the jitted
    JAX merge on the same gathered input."""
    k, a = 8, 16
    pts, lab_split = _split_accumulators(rng, k, a)
    cols = [jnp.asarray(pts[:, i]) for i in range(3)]
    whole = obb_accumulate_xyz_reference(*cols, jnp.zeros(400, jnp.int32), max_clusters=k,
                                         num_angles=a)
    frag = obb_accumulate_xyz_reference(*cols, jnp.asarray(lab_split), max_clusters=k,
                                        num_angles=a)
    ref = jax.jit(lambda s: jsh._merge_accumulators(s, 1e9))(frag)
    got = tsh._merge_accumulators(state.to_torch({key: np.asarray(v) for key, v in frag.items()}),
                                  1e9)
    for key, val in got.items():
        assert val.numpy().tobytes() == np.asarray(ref[key]).tobytes(), key
    cnt = got["cnt"].numpy()
    assert cnt[1] == 400.0 and cnt[5] == 0.0
    for key in ("sx", "sy", "sz"):
        np.testing.assert_allclose(float(got[key][1]), float(whole[key][0]), rtol=1e-5)
    for key in ("zlo", "zhi", "ulo", "uhi", "vlo", "vhi"):
        np.testing.assert_array_equal(got[key][1].numpy(), np.asarray(whole[key])[0])


@pytest.mark.parametrize("seed", range(4))
def test_merge_accumulators_bit_equal_jax(seed):
    """Many fragments (sums of many magnitudes, chains that need several
    union rounds, dead rows): the port's merge is the jitted JAX merge bit
    for bit, on the gathered [D*K] rows of 4 ranks."""
    rng = np.random.default_rng(seed)
    k, a, d = 16, 8, 4
    accs = []
    for r in range(d):
        pts = rng.uniform(-60, 60, (600, 3)).astype(np.float32)
        pts[:, 0] += r * 100.0  # fragments along x, touching across ranks
        lab = rng.integers(-1, k, 600).astype(np.int32)
        lab[pts[:, 0] % 40 < 20] = -1
        accs.append(obb_accumulate_xyz_reference(
            *(jnp.asarray(pts[:, i]) for i in range(3)), jnp.asarray(lab),
            max_clusters=k, num_angles=a,
        ))
    gathered = {key: np.concatenate([np.asarray(acc[key]) for acc in accs]) for key in accs[0]}
    for radius in (6.0, 25.0):
        ref = jax.jit(lambda s, rad=radius: jsh._merge_accumulators(s, rad))(gathered)
        got = tsh._merge_accumulators(state.to_torch(gathered), radius)
        for key, val in got.items():
            assert val.numpy().tobytes() == np.asarray(ref[key]).tobytes(), (radius, key)


def test_merge_accumulators_equal_count_tiebreak():
    """Two equal-count fragments in one group leave one row, the lower
    index, holding the combined count (and the JAX merge's bits)."""
    k, a = 8, 4
    big = np.float32(3.0e38)
    acc = {
        "cnt": np.zeros(k, np.float32), "sx": np.zeros(k, np.float32),
        "sy": np.zeros(k, np.float32), "sz": np.zeros(k, np.float32),
        "zlo": np.full(k, big, np.float32), "zhi": np.full(k, -big, np.float32),
        "ulo": np.full((k, a), big, np.float32), "uhi": np.full((k, a), -big, np.float32),
        "vlo": np.full((k, a), big, np.float32), "vhi": np.full((k, a), -big, np.float32),
    }
    for i in (2, 5):
        acc["cnt"][i] = 4097.0
        acc["zlo"][i], acc["zhi"][i] = 0.0, 40.0
        acc["ulo"][i], acc["uhi"][i] = 0.0, 10.0
        acc["vlo"][i], acc["vhi"][i] = 0.0, 10.0
        acc["sx"][i] = acc["sy"][i] = 5.0 * 4097.0
        acc["sz"][i] = 20.0 * 4097.0
    got = tsh._merge_accumulators(state.to_torch(acc), 6.0)
    counts = got["cnt"].numpy()
    assert (counts > 0).sum() == 1 and counts[2] == 8194.0
    ref = jax.jit(lambda s: jsh._merge_accumulators(s, 6.0))(acc)
    for key, val in got.items():
        assert val.numpy().tobytes() == np.asarray(ref[key]).tobytes(), key


def test_sharded_fast_precut_engages():
    """Two ranks of 131,072 rows engage the pre-cut against the global
    base: the JAX step's towers, no overflow."""
    n_dev, per_shard = 2, 131072
    xyz, mask, centers = _make_inputs(np.random.default_rng(42), n_dev, per_shard)
    out = launch.run_ranks(
        launch.call_on_rank,
        [([_step((xyz[r * per_shard:(r + 1) * per_shard],
                  mask[r * per_shard:(r + 1) * per_shard]), _tparams(), mode="fast")],)
         for r in range(n_dev)],
        backend="gloo", devices="cpu", timeout=300,
    )
    merged = _replicated([o[0] for o in out])
    _, ref = _jax_sharded(xyz, mask, n_dev, fast=True)
    _same_towers(merged, ref, exact_z=False)
    got = np.sort(merged["center"][merged["accepted"]][:, 0])
    np.testing.assert_allclose(got, np.sort(centers[:, 0]), atol=2.5)
    assert float(merged["cells_overflow"]) == 0.0


# ------------------------------------------------------------------
# The pieces


@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_functions_bit_equal_jax(seed):
    """histogram_counts, percentile_from_histogram and histogram_percentile
    against the jitted JAX functions (q constant, as the sharded step
    compiles it), at 4,096 bins and at 1,000 (whose edges and width take
    the f32 reciprocal, as XLA:CPU does)."""
    x, mask = _ground_inputs(seed)
    z = x[:, 2]
    lo = np.float32(z[mask].min())
    hi = np.float32(z[mask].max())
    for nb in (4096, 1000):
        for q in (25.0, 10.0 + 7.3 * seed):
            ref = jax.jit(functools.partial(jpct.histogram_percentile, q=q, num_bins=nb))(z, mask)
            got = tpct.histogram_percentile(torch.from_numpy(z), torch.from_numpy(mask), q, nb)
            assert got.numpy().tobytes() == np.asarray(ref).tobytes(), (nb, q)
        counts = jax.jit(functools.partial(jpct.histogram_counts, num_bins=nb))(z, mask, lo, hi)
        tcounts = tpct.histogram_counts(torch.from_numpy(z), torch.from_numpy(mask),
                                        torch.tensor(lo), torch.tensor(hi), nb)
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(counts))
        ref = jax.jit(functools.partial(jpct.percentile_from_histogram, q=25.0))(counts, lo, hi)
        got = tpct.percentile_from_histogram(tcounts, torch.tensor(lo), torch.tensor(hi), 25.0)
        assert got.numpy().tobytes() == np.asarray(ref).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_global_ground_base_bit_equal_jax(port4, seed):
    x, mask = _ground_inputs(seed)
    params = _jparams()
    ref_base, ref_retry = _jax_on_mesh(
        lambda a, b: jsh._global_ground_base(a, b, params), N_DEV, x, mask, out_specs=(P(), P())
    )
    for base, retry in port4[f"ground{seed}"]:
        assert base.tobytes() == ref_base.tobytes()
        assert bool(retry) == bool(ref_retry)


@pytest.mark.parametrize("seed", SEEDS)
def test_masked_percentile_bisect_over_ranks(port4, seed):
    """4 ranks' percentile of the union: the jitted JAX bisection over the
    4-device mesh and on one device, bit for bit; np.percentile within one
    f32 ulp (its lerp a + (b - a) t may round differently from the
    reference's a (1 - t) + b t; the order statistics are the same)."""
    x, mask = _ground_inputs(seed)
    z, q = x[:, 2], 25.0 + seed
    mesh_ref = _jax_on_mesh(
        lambda a, b: jpct.masked_percentile_bisect(a, b, q, axis_name=jsh.AXIS), N_DEV, z, mask
    )
    one_ref = jax.jit(functools.partial(jpct.masked_percentile_bisect, q=q))(z, mask)
    want = np.percentile(z[mask], q)
    for got in port4[f"bisect{seed}"]:
        assert got.tobytes() == mesh_ref.tobytes() == np.asarray(one_ref).tobytes()
        assert abs(float(got) - want) <= np.spacing(np.float32(abs(want)))


def test_exact_extract_graph_group_matches_axis_name(port4):
    """exact_extract_graph(group=) on 4 ranks against the JAX function
    with axis_name on the 4-device mesh: the same base, retry decision,
    survivor counts, per-rank partition and accumulators."""
    xyz, mask, _, bits = _exact_inputs()
    params = _jparams()
    kw = dict(params=params, cell_bits=bits, compact_cap=1024, max_cells=1024,
              local_rows=1536, return_acc=True, axis_name=jsh.AXIS)
    keys = ("base_height", "used_retry", "compact_count", "cells_overflow", "core_overflow")

    def fn(a, b):
        out = jfe.exact_extract_graph(a, b, **kw)
        return ({key: out[key][None] for key in keys},
                {key: v[None] for key, v in out["acc"].items()},
                out["labels_sorted"], out["rows_sorted"])

    scalars, accs, labels, rows = _jax_on_mesh(fn, N_DEV, xyz, mask,
                                               out_specs=(P(jsh.AXIS),) * 4)
    for r, got in enumerate(port4["exact_graph"]):
        for key in keys:
            assert np.asarray(got[key]).tobytes() == scalars[key][r].tobytes(), (r, key)
        # labels by original row: the partition, with the same ids
        c = 1024
        sl = slice(r * c, (r + 1) * c)
        n = int(min(scalars["compact_count"][r], c))
        want = dict(zip(rows[sl][:n], labels[sl][:n]))
        have = dict(zip(got["rows_sorted"][:n], got["labels_sorted"][:n]))
        assert want == have, r
        ref_acc = {key: v[r] for key, v in accs.items()}
        rows_ok = (got["rows_sorted"] < 1536) & (np.arange(c) < n)
        lab = np.where(rows_ok, got["labels_sorted"], -1)
        xs = xyz[r * 2048:(r + 1) * 2048]
        pts = np.zeros((c, 3), np.float32)
        pts[rows_ok] = xs[got["rows_sorted"][rows_ok]]
        # u/v extremes: 2 ulp of the coordinates (the cos/sin tables)
        ulp2 = 2.0 * float(np.spacing(np.abs(xyz[:, :2]).max()))
        assert_acc_close(got["acc"], ref_acc, pts, lab, params.max_clusters, ulp2)


def test_cluster_obb_accumulators_xyz_matches_jax():
    """Against the JAX function's reference branch (N not a multiple of its
    block); labels outside [0, K) and masked rows skipped.  Counts and z
    extremes exact, sums to f32 order, u/v extremes within 2e-5 m (one ulp
    of the cos/sin tables, tests/test_torch_kernels.py)."""
    rng = np.random.default_rng(9)
    n, k, a = 3000, 8, 16
    xyz = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    lab = rng.integers(-2, k + 3, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    ref = jobb.cluster_obb_accumulators_xyz(jnp.asarray(xyz), jnp.asarray(lab),
                                            jnp.asarray(mask), max_clusters=k, num_angles=a)
    got = tobb.cluster_obb_accumulators_xyz(torch.from_numpy(xyz), torch.from_numpy(lab),
                                            torch.from_numpy(mask), max_clusters=k,
                                            num_angles=a)
    eff = np.where(mask & (lab >= 0) & (lab < k), lab, -1)
    assert_acc_close(state.to_numpy(got), {key: np.asarray(v) for key, v in ref.items()},
                     xyz, eff, k, 2e-5)


def test_launcher_refuses_nccl_without_cards():
    """NCCL needs a card a rank: never a silent switch to gloo or the CPU."""
    with pytest.raises((RuntimeError, ValueError)):
        launch.run_ranks(launch.call_on_rank, [([],)] * 2, backend="nccl")
    with pytest.raises(ValueError, match="card of its own"):
        launch._check("nccl", ["cuda:0", "cuda:0"])
