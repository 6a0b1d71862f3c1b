"""The port's seven kernels: their plain PyTorch versions (what CPU tensors
run) against the JAX package's Pallas kernels in interpret mode or its XLA
oracles on the same numpy inputs.  The hand-written CUDA kernels are held
against these plain versions on the card by test_torch_cuda.py.

Tolerances: integer outputs, pop (integer weights), counts and min/max
extremes must match exactly; float sums only up to f32 summation order
(1e-6 of each cluster's summed magnitude).  The OBB projection extremes
u/v agree to 2 ulp of the coordinates: XLA's float32 cos/sin are not
correctly rounded and differ from torch's by one ulp at some angles (7 of
256), and XLA:CPU contracts the projection into a fused multiply-add."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloudhookup_tpu.ops.pallas.cluster_converge import cluster_cells_reference
from pointcloudhookup_tpu.ops.pallas.compactidx import (
    compact_indices as jax_compact_indices,
    compact_indices_reference,
)
from pointcloudhookup_tpu.ops.pallas.compactrows import (
    compact_rows_multi_reference,
    compact_rows_reference,
)
from pointcloudhookup_tpu.ops.pallas.neighbor import neighbor_reduce_reference
from pointcloudhookup_tpu.ops.pallas.obb_accum import (
    obb_accumulate as jax_obb_accumulate,
    obb_accumulate_reference,
    obb_accumulate_xyz_reference,
)
from pointcloudhookup_tpu.ops.pallas.segscan import segmented_scan_pallas
from pointcloudhookup_tpu.ops.segments import segmented_scan as jax_segmented_scan
from pointcloudhookup_tpu_torch.ops.kernels import (
    cluster_converge,
    compactidx,
    compactrows,
    neighbor,
    obb_accum,
    segscan,
)
from test_torch_cuda import (
    BIG,
    assert_acc_close,
    cells,
    chain_cells,
    compact_inputs,
    flag_inputs,
    morton_cells,
    morton_inputs,
    n,
    obb_inputs,
    scan_inputs,
    t,
)

torch.set_num_threads(2)


@pytest.mark.parametrize(
    "size,density,cap,fills",
    [(5000, 0.3, 2048, None), (5000, 0.8, 2048, None), (4096, 0.0, 1024, None),
     (3000, 0.5, 4096, None), (3000, 0.5, 4096, (2999, -1, 2**31 - 1)),
     (4096, 0.0, 1024, (7, 8, 9)), (5000, 0.8, 2048, (-2**31, 0, 1))],
    ids=["fits", "count>cap", "none-kept", "cap>n", "cap>n-fills", "none-kept-fills",
         "count>cap-fills"],
)
def test_compactrows_plain_matches_reference(size, density, cap, fills):
    """With fills, the rows past the count hold each channel's fill, where
    the reference holds zeros (the m-table pack's n - 1 and the Morton
    sentinel are such fills)."""
    keep, chans = compact_inputs(1, size, density)
    ref, ref_cnt = compact_rows_multi_reference(
        jnp.asarray(keep), tuple(jnp.asarray(c) for c in chans), cap
    )
    got, cnt = compactrows.compact_rows_multi(t(keep), tuple(t(c) for c in chans), cap, fills)
    assert int(cnt) == int(ref_cnt) == int(keep.sum())
    live = np.arange(cap) < min(int(keep.sum()), cap)
    for q, (r, g) in enumerate(zip(ref, got)):
        want = np.asarray(r) if fills is None else np.where(live, np.asarray(r), fills[q])
        assert g.dtype == torch.int32 and g.shape == (cap,)
        np.testing.assert_array_equal(n(g), want)


_JNP_OPS = {"add": jnp.add, "max": jnp.maximum, "min": jnp.minimum}


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_segscan_plain_matches_reference(op, dtype, reverse):
    # the plain version is the reference's own doubling scan, so even
    # float sums agree bit for bit
    vals, flags = scan_inputs(3, 3001, dtype)
    ref = jax_segmented_scan(
        _JNP_OPS[op], jnp.asarray(vals), jnp.asarray(flags), reverse=reverse
    )
    got = segscan.segmented_scan(t(vals), t(flags), op, reverse)
    np.testing.assert_array_equal(n(got), np.asarray(ref))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_segscan_plain_matches_pallas_kernel(op, dtype, reverse):
    """Against the Pallas kernel the JAX package runs on its accelerator, in
    interpret mode, with four grid steps so the carry crosses blocks.
    Integer sums, max and min are bit-identical; float32 sums agree to the
    tolerance of tests/test_segscan_pallas.py (the kernel adds lanes, then
    sublanes, in another order than the doubling scan)."""
    vals, flags = scan_inputs(11, 4096, dtype)
    ref = np.asarray(segmented_scan_pallas(
        jnp.asarray(vals), jnp.asarray(flags), op=op, reverse=reverse, block=1024,
        interpret=True,
    ))
    got = n(segscan.segmented_scan(t(vals), t(flags), op, reverse))
    if dtype == np.float32 and op == "add":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_segscan_plain_columns_match_reference(reverse):
    """The centroid-voxel call: one scan of the stacked [N, 4] columns, bit
    for bit the JAX package's segmented_scan of the same [N, 4] input."""
    rng = np.random.default_rng(12)
    size = 3001
    xyz = rng.normal(0, 30, (size, 3)).astype(np.float32)
    w = (rng.random(size) < 0.8).astype(np.float32)
    vals = np.concatenate([xyz * w[:, None], w[:, None]], axis=1)
    flags = rng.random(size) < 0.2
    ref = jax_segmented_scan(jnp.add, jnp.asarray(vals), jnp.asarray(flags), reverse=reverse)
    got = segscan.segmented_scan(t(vals), t(flags), "add", reverse)
    assert got.shape == (size, 4)
    np.testing.assert_array_equal(n(got), np.asarray(ref))


@pytest.mark.parametrize("mode", ["both", "pop", "lmin"])
def test_neighbor_plain_matches_reference(mode):
    m = 2048
    centers, ccount, alive = cells(5, m, 1500, dead_allowed=True)
    labels = np.random.default_rng(6).permutation(m).astype(np.int32)
    eps2 = np.float32(25.0)
    ref_pop, ref_lmin = neighbor_reduce_reference(
        jnp.asarray(centers), jnp.asarray(labels), jnp.asarray(ccount),
        jnp.asarray(alive), eps2, sentinel=m,
    )
    pop, lmin = neighbor.neighbor_reduce(
        t(centers), t(labels), t(ccount), t(alive), eps2, sentinel=m, mode=mode,
    )
    want_pop = np.asarray(ref_pop) if mode != "lmin" else np.zeros(m, np.float32)
    want_lmin = np.asarray(ref_lmin) if mode != "pop" else np.full(m, m, np.int32)
    np.testing.assert_array_equal(n(pop), want_pop)
    np.testing.assert_array_equal(n(lmin), want_lmin)


@pytest.mark.parametrize(
    "min_points,n_alive",
    [(0.0, 700), (30.0, 700), (1e9, 700), (12.0, 1024)],
    ids=["flood-all", "core-rule", "all-noise", "full-table"],
)
def test_cluster_cells_plain_matches_reference(min_points, n_alive):
    m = 1024
    centers, ccount, alive = cells(9, m, n_alive)
    labels0 = np.random.default_rng(10).permutation(m).astype(np.int32)
    eps2 = np.float32(25.0)
    ref_lab, ref_pop = cluster_cells_reference(
        jnp.asarray(centers), jnp.asarray(ccount), jnp.asarray(alive),
        jnp.asarray(labels0), eps2, min_points,
    )
    lab, pop = cluster_converge.cluster_cells(
        t(centers), t(ccount), t(alive), t(labels0), eps2, min_points
    )
    np.testing.assert_array_equal(n(pop), np.asarray(ref_pop))
    np.testing.assert_array_equal(n(lab), np.asarray(ref_lab))
    if min_points > 1e8:
        assert (n(lab) == m).all()


@pytest.mark.parametrize("mode", ["both", "pop", "lmin"])
def test_neighbor_plain_matches_reference_on_a_morton_table(mode):
    """The cell-ordered table the card tests cull on (a Morton-sorted
    lattice, dead rows at +3e38 and three of them allowed)."""
    m = 2048
    centers, ccount, alive = morton_cells(30, m, 0.6, dead_allowed=True)
    labels = np.random.default_rng(31).permutation(m).astype(np.int32)
    eps2 = np.float32(25.0)
    ref_pop, ref_lmin = neighbor_reduce_reference(
        jnp.asarray(centers), jnp.asarray(labels), jnp.asarray(ccount),
        jnp.asarray(alive), eps2, sentinel=m,
    )
    pop, lmin = neighbor.neighbor_reduce_plain(
        t(centers), t(labels), t(ccount), t(alive), eps2, sentinel=m, mode=mode,
    )
    want_pop = np.asarray(ref_pop) if mode != "lmin" else np.zeros(m, np.float32)
    want_lmin = np.asarray(ref_lmin) if mode != "pop" else np.full(m, m, np.int32)
    np.testing.assert_array_equal(n(pop), want_pop)
    np.testing.assert_array_equal(n(lmin), want_lmin)


def test_cluster_cells_plain_matches_reference_on_a_chain():
    """A chain of 1,000 cells one cell wide with a random labels0: one
    component whose min-label rounds run ~500 deep, the card tests'
    yardstick for the union-find."""
    m = 1000
    centers, ccount, alive = chain_cells(m)
    labels0 = np.random.default_rng(32).permutation(m).astype(np.int32)
    eps2 = np.float32(25.0)
    ref_lab, ref_pop = cluster_cells_reference(
        jnp.asarray(centers), jnp.asarray(ccount), jnp.asarray(alive),
        jnp.asarray(labels0), eps2, 0.0,
    )
    lab, pop = cluster_converge.cluster_cells_plain(
        t(centers), t(ccount), t(alive), t(labels0), eps2, 0.0
    )
    np.testing.assert_array_equal(n(pop), np.asarray(ref_pop))
    np.testing.assert_array_equal(n(lab), np.asarray(ref_lab))
    assert (n(lab) == labels0.min()).all()


@pytest.mark.parametrize("all_noise", [False, True], ids=["mixed", "all-noise"])
def test_obb_accum_plain_matches_reference(all_noise):
    k, a = 8, 16
    xyz, lab = obb_inputs(12, 3000, k)
    if all_noise:
        lab[:] = -1
    ref = obb_accumulate_xyz_reference(
        jnp.asarray(xyz[:, 0]), jnp.asarray(xyz[:, 1]), jnp.asarray(xyz[:, 2]),
        jnp.asarray(lab), max_clusters=k, num_angles=a,
    )
    got = obb_accum.obb_accumulate_xyz(
        t(xyz[:, 0]), t(xyz[:, 1]), t(xyz[:, 2]), t(lab),
        max_clusters=k, num_angles=a,
    )
    # the angle tables may differ by one ULP of cos/sin between XLA and
    # torch: u/v extremes of |coords| <= 87 m to 2e-5 m
    assert_acc_close({key: n(v) for key, v in got.items()}, ref, xyz, lab, k, 2e-5)
    if all_noise:
        assert (n(got["cnt"]) == 0).all() and (n(got["ulo"]) == BIG).all()


@pytest.mark.parametrize("density,cap", [(0.3, 2048), (0.8, 2048)], ids=["fits", "count>cap"])
def test_compact_rows_morton_plain_matches_reference(density, cap):
    keep, (hi, lo, _) = compact_inputs(16, 5000, density)
    ref = compact_rows_reference(jnp.asarray(keep), jnp.asarray(hi), jnp.asarray(lo), cap)
    got = compactrows.compact_rows(t(keep), t(hi), t(lo), cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(n(g), np.asarray(r))


@pytest.mark.parametrize("n_set", [3000, 4096, 9000], ids=["fewer", "exactly-m", "more"])
def test_compact_indices_plain_matches_kernel_interpret(n_set):
    """Against the Pallas kernel in interpret mode and the XLA oracle (the
    cumsum + searchsorted it replaced): dead slots hold N - 1."""
    m = 4096
    flag = flag_inputs(17, 32768, n_set)
    got = n(compactidx.compact_indices(t(flag), m))
    ref = np.asarray(jax_compact_indices(jnp.asarray(flag), m, interpret=True))
    oracle = np.asarray(compact_indices_reference(jnp.asarray(flag), m))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, oracle)
    assert got.dtype == np.int32 and (got[n_set:] == 32767).all()


@pytest.mark.parametrize(
    "size,n_set,m",
    [(5000, 700, 0), (5000, 0, 64), (5000, 5000, 4096), (3000, 1200, 5000)],
    ids=["m0", "none-set", "all-set", "m>n"],
)
def test_compact_indices_plain_edge_cases(size, n_set, m):
    """Against the XLA oracle: no slot, no set flag (every slot n - 1),
    every flag set with m < n, and more slots than rows."""
    flag = flag_inputs(18, size, n_set)
    got = n(compactidx.compact_indices(t(flag), m))
    ref = np.asarray(compact_indices_reference(jnp.asarray(flag), m))
    assert got.dtype == np.int32 and got.shape == (m,)
    np.testing.assert_array_equal(got, ref)


def test_obb_accumulate_plain_matches_kernel_interpret():
    """The Morton variant against the Pallas kernel in interpret mode, which
    decodes x = ix * vs + (mn + vs/2) with one rounding (XLA:CPU fuses the
    multiply-add): counts and z extremes identical, sums to the f32
    summation bound (2 n u sum|x|), u/v extremes to 2 ulp of the
    coordinates (module docstring)."""
    k, a = 8, 16
    hi, lo, lab, mn, xyz = morton_inputs(18, 8192, k)
    ref = jax_obb_accumulate(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(lab), jnp.asarray(mn),
        max_clusters=k, num_angles=a, interpret=True,
    )
    got = obb_accum.obb_accumulate(t(hi), t(lo), t(lab), t(mn), max_clusters=k, num_angles=a)
    ulp2 = 2 * float(np.spacing(np.abs(xyz).max()))
    assert_acc_close({key: n(v) for key, v in got.items()}, ref, xyz, lab, k, ulp2,
                     summation_bound=True)


def test_obb_accumulate_plain_within_an_ulp_of_the_oracle():
    """The XLA oracle decodes ((ix * vs) + mn) + vs/2 and rounds the
    coordinates otherwise: every extreme within one ulp of the coordinates
    (two for the projections), counts identical."""
    k, a = 8, 16
    hi, lo, lab, mn, xyz = morton_inputs(19, 4096, k)
    ref = obb_accumulate_reference(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(lab), jnp.asarray(mn),
        max_clusters=k, num_angles=a,
    )
    got = obb_accum.obb_accumulate(t(hi), t(lo), t(lab), t(mn), max_clusters=k, num_angles=a)
    ulp = float(np.spacing(np.abs(xyz).max()))
    np.testing.assert_array_equal(n(got["cnt"]), np.asarray(ref["cnt"]))
    for key in ("zlo", "zhi"):
        np.testing.assert_allclose(n(got[key]), np.asarray(ref[key]), rtol=0, atol=ulp)
    for key in ("ulo", "uhi", "vlo", "vhi"):
        np.testing.assert_allclose(n(got[key]), np.asarray(ref[key]), rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("a", [7, 64, 256])
def test_cached_angle_table_equals_angle_table(a):
    """The wrappers' per-(A, device) table holds angle_table's values, and a
    second call reuses the same tensors (no copy per call)."""
    cos_c, sin_c = obb_accum.cached_angle_table(a, "cpu")
    cos_r, sin_r = obb_accum.angle_table(a, "cpu")
    assert torch.equal(cos_c, cos_r) and torch.equal(sin_c, sin_r)
    again = obb_accum.cached_angle_table(a, torch.device("cpu"))
    assert again[0] is cos_c and again[1] is sin_c


@pytest.mark.parametrize("voxel_size", [0.1, 0.05, 0.3, 1.0 / 3.0])
def test_morton_offset_matches_tensor_arithmetic(voxel_size):
    """mn + vs/2 added as a number gives the bits of the float32 tensor
    arithmetic it replaced (vs as a float32 tensor, halved, added)."""
    rng = np.random.default_rng(20)
    mn = t(rng.uniform(-3000, 3000, (64, 3)).astype(np.float32))
    vs, off = obb_accum._morton_offset(mn, voxel_size)
    vs_t = torch.tensor(voxel_size, dtype=torch.float32)
    assert vs == float(vs_t)
    assert off.dtype == torch.float32 and torch.equal(off, mn + vs_t * 0.5)
