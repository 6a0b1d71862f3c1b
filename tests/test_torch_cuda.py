"""The hand-written CUDA kernels against their plain PyTorch versions on
the same inputs, on the card.  Every test is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false.  This file imports no jax,
so it also runs on a GPU machine without it (tests/conftest.py does
import jax; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs, pop and the OBB counts and extremes must be identical
(one angle table, the same per-row rounding); OBB sums agree to f32
summation order (atomics add in run order)."""

import numpy as np
import pytest
import torch

from pointcloudhookup_tpu_torch.ops.kernels import (
    cluster_converge,
    compactidx,
    compactrows,
    dupwin,
    mergesort,
    neighbor,
    obb_accum,
    segscan,
    winsort,
)

# ------------------------------------------------------------------
# Seeded numpy inputs and comparisons, shared with test_torch_kernels.py
# (which holds the plain versions against the JAX oracles).

BIG = np.float32(3.0e38)


def t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def n(x):
    return x.detach().cpu().numpy()


def compact_inputs(seed, size, density, nchan=3, stretch=0):
    """keep bool[size] and nchan int32 channels.  With stretch > 0 the
    density changes every stretch rows (none, sparse, half or all kept), so
    a scan crosses long runs of empty and of full tiles."""
    rng = np.random.default_rng(seed)
    if stretch:
        density = np.repeat(rng.choice([0.0, 0.002, 0.5, 1.0], size // stretch + 1),
                            stretch)[:size]
    keep = rng.random(size) < density
    chans = [
        rng.integers(-2**31, 2**31 - 1, size, dtype=np.int64).astype(np.int32)
        for _ in range(nchan)
    ]
    return keep, chans


def scan_inputs(seed, size, dtype):
    rng = np.random.default_rng(seed)
    flags = rng.random(size) < 0.05
    if dtype == np.int32:
        vals = rng.integers(-1000, 1000, size).astype(np.int32)
    else:
        vals = rng.normal(0, 10, size).astype(np.float32)
    return vals, flags


def cells(seed, m, n_alive, dead_allowed=False):
    """Cell centers on an eps/2 = 2.5 lattice (exact f32 distances), dead
    rows at +3e38 like the dense-cell table's capacity."""
    rng = np.random.default_rng(seed)
    ij = rng.integers(0, 12, size=(m, 3)).astype(np.float32)
    centers = ((ij + np.float32(0.5)) * np.float32(2.5)).astype(np.float32)
    alive = np.arange(m) < n_alive
    centers[~alive] = BIG
    ccount = np.where(alive, rng.integers(1, 20, m), 0).astype(np.float32)
    if dead_allowed:
        alive = alive.copy()
        alive[-3:] = True  # allowed rows AT the sentinel coordinate
    return centers, ccount, alive


def morton_cells(seed, m, live_frac, dead_allowed=False):
    """Cell centers on cells()'s 2.5 lattice over a cube of about 2 m
    lattice points, in the order of an interleaved (Morton) cell key as the
    dense-cell tables are, so a 32-row subtile is spatially compact and the
    kernels' culling culls.  The first live_frac * m rows are live, the rest
    dead at +3e38 (dead_allowed: the last three allowed all the same)."""
    rng = np.random.default_rng(seed)
    n_alive = int(round(live_frac * m))
    side = max(2, int(np.ceil((2 * m) ** (1 / 3))))
    ij = rng.integers(0, side, size=(n_alive, 3))
    key = np.zeros(n_alive, np.int64)
    for b in range(int(side).bit_length()):
        for a in range(3):
            key |= ((ij[:, a] >> b) & 1) << (3 * b + a)
    ij = ij[np.argsort(key, kind="stable")]
    centers = np.full((m, 3), BIG, np.float32)
    centers[:n_alive] = (ij.astype(np.float32) + np.float32(0.5)) * np.float32(2.5)
    alive = np.arange(m) < n_alive
    ccount = np.where(alive, rng.integers(1, 20, m), 0).astype(np.float32)
    if dead_allowed:
        alive[-3:] = True
    return centers, ccount, alive


def chain_cells(m):
    """m live cells in a line one cell wide, 2.5 apart: with eps 5 each
    meets the two on either side, so one component spans the chain and the
    min-label rounds need ~m / 2 of them."""
    centers = np.full((m, 3), np.float32(1.25), np.float32)
    centers[:, 0] = (np.arange(m, dtype=np.float32) + np.float32(0.5)) * np.float32(2.5)
    return centers, np.ones(m, np.float32), np.ones(m, bool)


def shared_tile_cells(seed, m):
    """Rows that take turns between four clusters 100 apart (and a few
    isolated cells): every 32-row subtile holds rows of several components."""
    rng = np.random.default_rng(seed)
    base = np.array([[0, 0, 0], [100, 0, 0], [0, 100, 0], [100, 100, 50]], np.float32)
    centers = base[np.arange(m) % 4] + rng.integers(0, 4, (m, 3)).astype(np.float32) * 2.5
    centers[::97] += np.float32(1000.0) * np.arange(1, len(centers[::97]) + 1)[:, None]
    return centers.astype(np.float32), np.ones(m, np.float32), np.ones(m, bool)


def obb_inputs(seed, size, k):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-50, 50, size=(size, 3)).astype(np.float32)
    # runs of constant labels (cell-sorted rows), with noise, ids >= K
    # and negative ids mixed in
    lab = np.repeat(rng.integers(-1, k + 4, size // 16 + 1), 16)[:size]
    return xyz, lab.astype(np.int32)


def morton_inputs(seed, size, k, span=3000):
    """Morton-coded voxel rows (int32 hi, lo) of random voxel indices below
    span per axis, labels in runs as in obb_inputs, and a grid origin."""
    from pointcloudhookup_tpu_torch.ops.morton import morton_decode, morton_encode

    rng = np.random.default_rng(seed)
    ijk = torch.from_numpy(rng.integers(0, span, (size, 3)).astype(np.int32))
    hi, lo = morton_encode(ijk[:, 0], ijk[:, 1], ijk[:, 2])
    lab = np.repeat(rng.integers(-1, k + 4, size // 16 + 1), 16)[:size]
    mn = np.array([-246.1, -246.0, -5.1], np.float32)
    vs = np.float32(0.1)
    # the voxel centres, for the summation bound of assert_acc_close
    xyz = np.stack([v.numpy() for v in morton_decode(hi, lo)], 1) * vs + mn + vs / 2
    return n(hi), n(lo), lab.astype(np.int32), mn, xyz.astype(np.float32)


def key_runs(seed, size, max_run):
    """Sorted u32 keys (int64) in runs of 1..max_run rows, and the rng."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_run + 1, size)
    lens = lens[: np.searchsorted(np.cumsum(lens), size) + 1]
    k1 = np.repeat(np.cumsum(rng.integers(1, 5, len(lens))), lens)[:size]
    return k1.astype(np.int64), rng


def merge_inputs(seed, size, kind):
    """(hi, lo) int32 pairs: random, all equal, reversed, 80 % sentinel
    rows, or two runs wholly below / above each other (skewed co-ranks)."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 1 << 30, size).astype(np.int32)
    lo = rng.integers(0, 1 << 30, size).astype(np.int32)
    if kind == "all-equal":
        hi[:], lo[:] = 5, 9
    elif kind == "reversed":
        hi, lo = np.arange(size, 0, -1, dtype=np.int32), np.zeros(size, np.int32)
    elif kind == "sentinel-heavy":
        hi[rng.random(size) < 0.8] = 0x7FFFFFFF
    elif kind == "skewed":
        half = np.arange(size // 2)
        hi = np.concatenate([1000000 + half, half]).astype(np.int32)
        lo = np.zeros(size, np.int32)
    elif kind == "negative":
        hi = rng.integers(-2**31, 2**31, size).astype(np.int32)
        lo = rng.integers(-2**31, 2**31, size).astype(np.int32)
        hi[::3] = hi[0]
    elif kind == "extremes":  # INT32_MIN and INT32_MAX in either word
        words = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int64)
        hi = rng.choice(words, size).astype(np.int32)
        lo = rng.choice(words, size).astype(np.int32)
    elif kind == "sorted":
        order = np.lexsort((lo, hi))
        hi, lo = hi[order], lo[order]
    return hi, lo


def flag_inputs(seed, size, n_set):
    """bool[size] with n_set True entries at random positions."""
    rng = np.random.default_rng(seed)
    flag = np.zeros(size, bool)
    flag[rng.choice(size, n_set, replace=False)] = True
    return flag


def assert_acc_close(got, ref, xyz, lab, k, extremes_atol, summation_bound=False):
    """Counts and z extremes exactly; sums to 1e-6 of each cluster's
    summed magnitude (f32 summation order), or with summation_bound to
    2 n u sum|x| (u = 2**-24: the recursive summation bound of n terms
    for each of two orders); u/v extremes to extremes_atol."""
    sel = (lab >= 0) & (lab < k)
    cnt = np.bincount(lab[sel], minlength=k)
    for key in obb_accum.NAMES:
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.shape == r.shape, key
        if key in ("sx", "sy", "sz"):
            col = "xyz".index(key[1])
            mag = np.bincount(lab[sel], weights=np.abs(xyz[sel, col]), minlength=k)
            rel = 2.0 * cnt * 2.0**-24 if summation_bound else 1e-6
            assert (np.abs(g.astype(np.float64) - r) <= rel * mag + 1e-6).all(), key
        elif key in ("cnt", "zlo", "zhi"):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=extremes_atol, err_msg=key)


# ------------------------------------------------------------------
# Kernel vs plain version, on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


COMPACT_CASES = {  # id: (size, density, cap (None: the kept count), channels, stretch, fills)
    "fits": (1 << 20, 0.15, 1 << 18, 3, 0, None),
    "count>cap": (100_003, 0.9, 50_000, 3, 0, None),
    "tiny": (7, 1.0, 9, 3, 0, None),
    "none-kept": (5000, 0.0, 64, 3, 0, None),
    "one-channel-fill": (720_896, 0.01, 4096, 1, 0, (720_895,)),
    "two-channels": (1 << 20, 0.3, 1 << 19, 2, 0, (2**31 - 1, 0)),
    "five-channels": (1 << 20, 0.06, 65_536, 5, 0, None),
    "eight-channels": (300_000, 0.5, 200_000, 8, 0, (-1, 1, -2**31, 2**31 - 1, 5, 6, 7, 8)),
    "cap0": (100_003, 0.5, 0, 3, 0, None),
    "no-rows": (0, 0.5, 16, 2, 0, (3, 4)),
    "count==cap": (1 << 20, 0.2, None, 3, 0, None),
    "ragged-n": (4096 * 37 + 13, 0.4, 70_000, 3, 0, None),
    "16M-stretches": (16 << 20, None, 3 << 20, 2, 65_536, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(COMPACT_CASES), ids=list(COMPACT_CASES))
def test_compactrows_kernel_matches_plain(cuda, case):
    size, density, cap, nchan, stretch, fills = COMPACT_CASES[case]
    keep, chans = compact_inputs(2, size, density, nchan, stretch)
    cap = int(keep.sum()) if cap is None else cap
    args = (t(keep, cuda), tuple(t(c, cuda) for c in chans), cap, fills)
    got, cnt = compactrows.compact_rows_multi(*args)
    ref, ref_cnt = compactrows.compact_rows_multi_plain(*args)
    torch.cuda.synchronize()
    assert int(cnt) == int(ref_cnt) == int(keep.sum())
    assert len(got) == nchan
    for r, g in zip(ref, got):
        assert g.dtype == torch.int32 and torch.equal(r, g)


@pytest.mark.cuda
@pytest.mark.parametrize("density,cap", [(0.17, 720_896), (0.9, 32_768)], ids=["fits", "count>cap"])
def test_compact_rows_morton_kernel_matches_plain(cuda, density, cap):
    """The Morton wrapper: SENTINEL_HI past the count in hi, zeros in lo."""
    keep, (hi, lo) = compact_inputs(3, 4 << 20, density, nchan=2)
    args = (t(keep, cuda), t(hi, cuda), t(lo, cuda), cap)
    got = compactrows.compact_rows(*args)
    ref = compactrows.compact_rows_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


SCAN_OPS = [(op, reverse) for op in ("add", "max", "min") for reverse in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("size", [1, 15, 16, 17, 4095, 4097, 1 << 20, 4 << 20])
def test_segscan_kernel_matches_plain(cuda, size):
    for dtype in (np.int32, np.float32):
        vals, flags = scan_inputs(4, size, dtype)
        if dtype == np.float32:
            vals = np.round(vals)  # integer-valued: sums exact in any order
        for op, reverse in SCAN_OPS:
            args = (t(vals, cuda), t(flags, cuda), op, reverse)
            got = segscan.segmented_scan(*args)
            ref = segscan.segmented_scan_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (dtype, op, reverse)


SCAN_EDGE_CASES = {  # id: (size, flags: "one-segment" | "all" | random density)
    "one-segment-4M": (4 << 20, "one-segment"),  # the longest look-back
    "one-segment-ragged": (33 * 4096 + 5, "one-segment"),
    "all-flagged": (100_003, "all"),
    "sparse-flags": (1 << 20, 1e-5),  # spans of several tiles without a flag
}


def edge_flags(rng, size, kind):
    if kind == "one-segment":
        flags = np.zeros(size, bool)
        flags[0] = True
        return flags
    if kind == "all":
        return np.ones(size, bool)
    return rng.random(size) < kind


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SCAN_EDGE_CASES), ids=list(SCAN_EDGE_CASES))
def test_segscan_kernel_edge_cases(cuda, case):
    """Integer scans bit-identical to the plain version: one segment over
    every row (for a reverse scan, the one segment ends at the last row),
    every row its own segment, and spans of many tiles with no flag."""
    size, kind = SCAN_EDGE_CASES[case]
    rng = np.random.default_rng(41)
    flags = t(edge_flags(rng, size, kind), cuda)
    vals = t(rng.integers(-3, 4, size).astype(np.int32), cuda)
    for op, reverse in SCAN_OPS:
        got = segscan.segmented_scan(vals, flags, op, reverse)
        ref = segscan.segmented_scan_plain(vals, flags, op, reverse)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (op, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", ["values", "flags", "both"])
def test_segscan_kernel_unaligned_views(cuda, shift):
    """Views that do not start on a 16-byte boundary (v[1:], flags[1:])
    take the kernel's scalar-load variant: still bit-identical."""
    size = 3 * 4096 + 100
    vals, flags = scan_inputs(42, size + 1, np.int32)
    vt, ft = t(vals, cuda), t(flags, cuda)
    v = vt[1:] if shift in ("values", "both") else vt[:-1]
    f = ft[1:] if shift in ("flags", "both") else ft[:-1]
    before = segscan.launches
    for op, reverse in SCAN_OPS:
        got = segscan.segmented_scan(v, f, op, reverse)
        ref = segscan.segmented_scan_plain(v, f, op, reverse)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (op, reverse)
    assert segscan.launches == before + len(SCAN_OPS)  # the kernel, not the plain version


def assert_sums_close(got, ref, vals, flags, reverse):
    """float32 add: each output sums k rows of its segment, in the kernel's
    order and in the doubling scan's; each order is within (k - 1) u
    sum|v| of the exact sum (u = 2**-24), so the two differ by at most
    k 2**-23 sum|v| over those rows."""
    ones = torch.ones_like(vals)
    k = segscan.segmented_scan_plain(ones, flags, "add", reverse).double()
    mag = segscan.segmented_scan_plain(vals.double().abs(), flags, "add", reverse)
    bound = k * 2.0**-23 * mag
    diff = (got.double() - ref.double()).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("size,density", [(1 << 20, 0.05), (4 << 20, 0.3), (1 << 20, 1e-5)])
def test_segscan_kernel_float_sums(cuda, size, density):
    """Non-integer float32 sums: within the summation bound of the plain
    version, and two calls give the same bits (the carry between tiles is
    a fixed fold, not whatever happens to be published)."""
    rng = np.random.default_rng(43)
    vals = t(rng.normal(0, 10, size).astype(np.float32), cuda)
    flags = t(rng.random(size) < density, cuda)
    for reverse in (False, True):
        got = segscan.segmented_scan(vals, flags, "add", reverse)
        again = segscan.segmented_scan(vals, flags, "add", reverse)
        ref = segscan.segmented_scan_plain(vals, flags, "add", reverse)
        torch.cuda.synchronize()
        assert torch.equal(got, again), reverse
        assert_sums_close(got, ref, vals, flags, reverse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32], ids=["i32", "f32"])
@pytest.mark.parametrize("cols", [2, 3, 4])
def test_segscan_kernel_columns(cuda, dtype, cols):
    """[N, C] under one flag array, one launch: each column equals its own
    1-D plain scan (float32 values integer-valued, so sums are exact)."""
    size = 4096 * 37 + 11
    rng = np.random.default_rng(44 + cols)
    vals = t(np.round(rng.normal(0, 50, (size, cols))).astype(dtype), cuda)
    flags = t(rng.random(size) < 0.1, cuda)
    for op, reverse in SCAN_OPS:
        before = segscan.launches
        got = segscan.segmented_scan(vals, flags, op, reverse)
        assert segscan.launches == before + 1
        torch.cuda.synchronize()
        assert got.shape == (size, cols)
        for c in range(cols):
            ref = segscan.segmented_scan_plain(vals[:, c].contiguous(), flags, op, reverse)
            assert torch.equal(got[:, c], ref), (op, reverse, c)


@pytest.mark.cuda
def test_segscan_kernel_centroid_columns(cuda):
    """The centroid-voxel call: float32 add reverse over [4M, 4] of
    (x w, y w, z w, w); the weight column is exact, the others within the
    summation bound; two calls give the same bits."""
    size = 4 << 20
    rng = np.random.default_rng(45)
    xyz = rng.normal(0, 300, (size, 3)).astype(np.float32)
    w = (rng.random(size) < 0.9).astype(np.float32)
    vals = t(np.concatenate([xyz * w[:, None], w[:, None]], axis=1), cuda)
    flags = t(rng.random(size) < 0.3, cuda)
    got = segscan.segmented_scan(vals, flags, "add", True)
    again = segscan.segmented_scan(vals, flags, "add", True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for c in range(4):
        col = vals[:, c].contiguous()
        ref = segscan.segmented_scan_plain(col, flags, "add", True)
        if c == 3:
            assert torch.equal(got[:, c], ref)
        else:
            assert_sums_close(got[:, c], ref, col, flags, True)


def device_kernels(fn):
    """Names of the device kernels one call of fn ran, and its memsets."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    memsets = [k for k in names if "memset" in k.lower()]
    return [k for k in names if "memset" not in k.lower()], memsets


@pytest.mark.cuda
def test_scans_launch_one_kernel(cuda):
    """segscan ([N] and [N, 4]) and compact_indices each run as one kernel
    launch per call, besides at most one memset."""
    rng = np.random.default_rng(46)
    size = 1 << 20
    flags = t(rng.random(size) < 0.05, cuda)
    v1 = t(rng.integers(0, 9, size).astype(np.int32), cuda)
    v4 = t(rng.normal(0, 1, (size, 4)).astype(np.float32), cuda)
    dense = t(flag_inputs(47, 4 << 20, 3585), cuda)
    calls = {
        "segscan_kernel": (lambda: segscan.segmented_scan(v1, flags, "add", True),
                           lambda: segscan.segmented_scan(v4, flags, "add", True)),
        "compact_indices_kernel": (lambda: compactidx.compact_indices(dense, 4096),),
    }
    for name, fns in calls.items():
        for fn in fns:
            kernels, memsets = device_kernels(fn)
            assert len(kernels) == 1 and name in kernels[0], kernels
            assert len(memsets) <= 1, memsets


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["both", "pop", "lmin"])
def test_neighbor_kernel_matches_plain(cuda, mode):
    m = 16384
    centers, ccount, alive = cells(7, m, 9000, dead_allowed=True)
    labels = np.random.default_rng(8).permutation(m).astype(np.int32)
    args = (t(centers, cuda), t(labels, cuda), t(ccount, cuda), t(alive, cuda), 25.0)
    got = neighbor.neighbor_reduce(*args, sentinel=m, mode=mode)
    ref = neighbor.neighbor_reduce_plain(*args, sentinel=m, mode=mode)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("min_points", [0.0, 40.0, 1e9], ids=["flood-all", "core-rule", "all-noise"])
def test_cluster_cells_kernel_matches_plain(cuda, min_points):
    m = 8192
    centers, ccount, alive = cells(11, m, 6000)
    labels0 = np.random.default_rng(12).permutation(m).astype(np.int32)
    args = (t(centers, cuda), t(ccount, cuda), t(alive, cuda), t(labels0, cuda),
            25.0, min_points)
    got = cluster_converge.cluster_cells(*args)
    ref = cluster_converge.cluster_cells_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


TABLES = {  # id: () -> (centers, ccount, alive)
    **{f"morton-{m}-live{f}": (lambda m=m, f=f: morton_cells(19, m, f, dead_allowed=f < 1))
       for m in (2048, 4096, 65536) for f in (0.6, 1.0)},
    "all-dead": lambda: cells(20, 1000, 0),
    "all-dead-allowed": lambda: cells(20, 1000, 0, dead_allowed=True),
    "m7": lambda: cells(21, 7, 5, dead_allowed=True),
    "m1013": lambda: morton_cells(22, 1013, 0.7, dead_allowed=True),
    "m70001": lambda: morton_cells(33, 70001, 0.8, dead_allowed=True),
    "shared-tiles": lambda: shared_tile_cells(23, 3000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["both", "pop", "lmin"])
@pytest.mark.parametrize("table", list(TABLES), ids=list(TABLES))
def test_neighbor_kernel_culled_tables(cuda, table, mode):
    """Cell-ordered tables (the kernel culls), a table with every row dead,
    tables shorter than one 32-row subtile or not a multiple of it, one
    past the 65,536 columns the kernel lists at a time, and several
    components in each subtile; labels a permutation, and in lmin mode also
    a sparse allowed set (as the border pass's core cells)."""
    centers, ccount, alive = TABLES[table]()
    m = len(centers)
    rng = np.random.default_rng(24)
    labels = rng.permutation(m).astype(np.int32)
    allowed_sets = [alive]
    if mode == "lmin":
        allowed_sets.append(alive & (rng.random(m) < 0.1))
    for allowed in allowed_sets:
        args = (t(centers, cuda), t(labels, cuda), t(ccount, cuda), t(allowed, cuda))
        eps2 = torch.tensor(25.0, device=cuda)
        got = neighbor.neighbor_reduce(*args, eps2, sentinel=m, mode=mode)
        ref = neighbor.neighbor_reduce_plain(*args, 25.0, sentinel=m, mode=mode)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


@pytest.mark.cuda
def test_neighbor_kernel_fractional_weights(cuda):
    """Weights that are not integers: the kernel adds each row's terms in
    another order, so pop agrees to the f32 summation bound, 2 n u sum|w|
    (n terms, u = 2**-24, for each of the two orders); lmin exactly."""
    centers, _, alive = morton_cells(25, 4096, 0.8)
    m = len(centers)
    w = np.random.default_rng(26).random(m).astype(np.float32)
    labels = np.random.default_rng(27).permutation(m).astype(np.int32)
    args = (t(centers, cuda), t(labels, cuda), t(w, cuda), t(alive, cuda), 25.0)
    pop, lmin = neighbor.neighbor_reduce(*args, sentinel=m)
    ref_pop, ref_lmin = neighbor.neighbor_reduce_plain(*args, sentinel=m)
    cnt, _ = neighbor.neighbor_reduce_plain(
        t(centers, cuda), t(labels, cuda), torch.ones(m, device=cuda), t(alive, cuda),
        25.0, sentinel=m, mode="pop")
    bound = 2.0 * cnt.double() * 2.0**-24 * ref_pop.double()
    assert bool(((pop.double() - ref_pop.double()).abs() <= bound).all())
    assert torch.equal(lmin, ref_lmin)


CLUSTER_TABLES = {  # id: (table, min_points)
    **{f"{table}-mp{mp}": (table, mp) for table in TABLES if table.startswith("morton")
       for mp in (0.0, 120.0)},
    "chain3000": ("chain", 0.0),
    "shared-tiles": ("shared-tiles", 0.0),
    "all-dead": ("all-dead", 0.0),
    "all-dead-allowed": ("all-dead-allowed", 0.0),
    "m7": ("m7", 0.0),
    "m1013": ("m1013", 40.0),
    "m70001": ("m70001", 120.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CLUSTER_TABLES), ids=list(CLUSTER_TABLES))
def test_cluster_cells_kernel_culled_tables(cuda, case):
    """The union-find against the plain min-label rounds: cell-ordered
    tables with and without the core rule, a chain of 3,000 cells one cell
    wide (one component whose rounds run ~1,500 deep) with a random
    labels0, several components in each subtile, every row dead, and
    tables off the 32-row subtile."""
    table, min_points = CLUSTER_TABLES[case]
    centers, ccount, alive = chain_cells(3000) if table == "chain" else TABLES[table]()
    m = len(centers)
    labels0 = np.random.default_rng(28).permutation(m).astype(np.int32)
    args = (t(centers, cuda), t(ccount, cuda), t(alive, cuda), t(labels0, cuda))
    got = cluster_converge.cluster_cells(*args, torch.tensor(25.0, device=cuda), min_points)
    ref = cluster_converge.cluster_cells_plain(*args, 25.0, min_points)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if table == "chain":
        assert int(got[0].unique().numel()) == 1


@pytest.mark.cuda
def test_pair_kernels_make_no_host_sync(cuda):
    """cluster_cells and neighbor_reduce read eps2 on the card and launch
    with no device-to-host read, whether eps2 is a device tensor or a
    number."""
    centers, ccount, alive = morton_cells(29, 4096, 0.9)
    m = len(centers)
    xyz, w, al = t(centers, cuda), t(ccount, cuda), t(alive, cuda)
    iota = torch.arange(m, dtype=torch.int32, device=cuda)
    eps2 = torch.tensor(25.0, device=cuda)
    cluster_converge.cluster_cells(xyz, w, al, iota, eps2, 40.0)  # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for e2 in (eps2, 25.0):
            labels, _ = cluster_converge.cluster_cells(xyz, w, al, iota, e2, 40.0)
            pop, _ = neighbor.neighbor_reduce(xyz, iota, w, al, e2, mode="pop")
            neighbor.neighbor_reduce(xyz, labels, w, al, e2, sentinel=m, mode="lmin")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = cluster_converge.cluster_cells_plain(xyz, w, al, iota, 25.0, 40.0)
    assert torch.equal(labels, ref[0]) and torch.equal(pop, ref[1])


@pytest.mark.cuda
def test_cluster_cells_kernel_refuses_truncated_rounds(cuda):
    centers, ccount, alive = chain_cells(100)
    args = (t(centers, cuda), t(ccount, cuda), t(alive, cuda),
            torch.arange(100, dtype=torch.int32, device=cuda), 25.0, 0.0)
    with pytest.raises(ValueError, match="max_iter"):
        cluster_converge.cluster_cells(*args, max_iter=10)
    labels, _ = cluster_converge.cluster_cells(*args, max_iter=100)
    assert int(labels.max()) == 0


@pytest.mark.cuda
def test_obb_accum_kernel_matches_plain(cuda):
    k, a = 128, 256
    xyz, lab = obb_inputs(13, 300_001, k)
    args = tuple(t(v, cuda) for v in (xyz[:, 0], xyz[:, 1], xyz[:, 2], lab))
    got = obb_accum.obb_accumulate_xyz(*args, max_clusters=k, num_angles=a)
    ref = obb_accum.obb_accumulate_xyz_plain(*args, max_clusters=k, num_angles=a)
    torch.cuda.synchronize()
    assert_acc_close({key: n(v) for key, v in got.items()},
                     {key: n(v) for key, v in ref.items()}, xyz, lab, k, 0.0)


@pytest.mark.cuda
def test_obb_accumulate_morton_kernel_matches_plain(cuda):
    k, a = 128, 256
    hi, lo, lab, mn, xyz = morton_inputs(14, 300_001, k)
    args = tuple(t(v, cuda) for v in (hi, lo, lab, mn))
    got = obb_accum.obb_accumulate(*args, max_clusters=k, num_angles=a)
    ref = obb_accum.obb_accumulate_plain(*args, max_clusters=k, num_angles=a)
    torch.cuda.synchronize()
    assert_acc_close({key: n(v) for key, v in got.items()},
                     {key: n(v) for key, v in ref.items()}, xyz, lab, k, 0.0,
                     summation_bound=True)


OBB_EDGE_CASES = {  # id: (rows, K, A, label layout)
    "one-labelled-row": (100_000, 128, 256, "one"),
    "runs-beyond-a-span": (300_001, 16, 256, "long-runs"),
    "one-run": (200_000, 128, 256, "one-run"),
    "none-labelled": (50_000, 128, 256, "none"),
    "k1": (70_000, 1, 256, "runs"),
    "a7": (70_000, 32, 7, "runs"),
    "a64": (70_000, 32, 64, "runs"),
    "a300-two-angle-blocks": (70_000, 32, 300, "runs"),
    "outside-labels": (90_000, 8, 64, "outside"),
    "ragged-n": (128 * 37 + 5, 32, 64, "runs"),
    "tiny": (3, 4, 33, "one-run"),
}


def obb_edge_labels(rng, size, k, layout):
    """Labels of an OBB edge case: one labelled row; runs of 20,000 rows
    (longer than a warp's span at these sizes) with a sprinkle of noise;
    one run over every row; none; runs of 16 (obb_inputs); or only labels
    >= K and negative but for one run."""
    lab = np.full(size, -1, np.int64)
    if layout == "one":
        lab[size // 3] = 5
    elif layout == "long-runs":
        lab = np.repeat(rng.integers(0, k, size // 20_000 + 1), 20_000)[:size]
        lab[rng.random(size) < 0.2] = -1
    elif layout == "one-run":
        lab[:] = k - 1
    elif layout == "runs":
        lab = np.repeat(rng.integers(-1, k + 4, size // 16 + 1), 16)[:size]
    elif layout == "outside":
        lab = np.where(rng.random(size) < 0.5, k + rng.integers(0, 9, size),
                       -rng.integers(1, 1 << 30, size))
        lab[1000:1100] = 3
    return lab.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["xyz", "morton"])
@pytest.mark.parametrize("case", list(OBB_EDGE_CASES), ids=list(OBB_EDGE_CASES))
def test_obb_accum_kernel_edge_cases(cuda, case, variant):
    """The tile walk's edges against the plain version: counts and extremes
    identical, sums to the f32 summation bound."""
    size, k, a, layout = OBB_EDGE_CASES[case]
    hi, lo, _, mn, vox = morton_inputs(21, size, k)
    xyz, _ = obb_inputs(21, size, k)
    lab = obb_edge_labels(np.random.default_rng(22), size, k, layout)
    if variant == "xyz":
        args = tuple(t(v, cuda) for v in (xyz[:, 0], xyz[:, 1], xyz[:, 2], lab))
        kernel, plain, counter = (obb_accum.obb_accumulate_xyz,
                                  obb_accum.obb_accumulate_xyz_plain, "launches")
    else:
        xyz = vox
        args = tuple(t(v, cuda) for v in (hi, lo, lab, mn))
        kernel, plain, counter = (obb_accum.obb_accumulate, obb_accum.obb_accumulate_plain,
                                  "launches_morton")
    before = getattr(obb_accum, counter)
    got = kernel(*args, max_clusters=k, num_angles=a)
    assert getattr(obb_accum, counter) == before + 1
    ref = plain(*args, max_clusters=k, num_angles=a)
    torch.cuda.synchronize()
    assert_acc_close({key: n(v) for key, v in got.items()},
                     {key: n(v) for key, v in ref.items()}, xyz, lab, k, 0.0,
                     summation_bound=True)
    if layout == "none":
        assert (n(got["cnt"]) == 0).all() and (n(got["ulo"]) == BIG).all()


@pytest.mark.cuda
def test_obb_wrappers_make_no_host_sync(cuda):
    """Both OBB wrappers launch with no host round trip: the angle table is
    cached on the card, the Morton offset is computed there."""
    k, a = 32, 64
    xyz, lab = obb_inputs(23, 50_000, k)
    hi, lo, mlab, mn, _ = morton_inputs(23, 50_000, k)
    xargs = tuple(t(v, cuda) for v in (xyz[:, 0], xyz[:, 1], xyz[:, 2], lab))
    margs = tuple(t(v, cuda) for v in (hi, lo, mlab, mn))
    # the first calls build the library and copy the angle table
    obb_accum.obb_accumulate_xyz(*xargs, max_clusters=k, num_angles=a)
    obb_accum.obb_accumulate(*margs, max_clusters=k, num_angles=a)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_x = obb_accum.obb_accumulate_xyz(*xargs, max_clusters=k, num_angles=a)
        got_m = obb_accum.obb_accumulate(*margs, max_clusters=k, num_angles=a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got, ref in ((got_x, obb_accum.obb_accumulate_xyz_plain(*xargs, max_clusters=k,
                                                                num_angles=a)),
                     (got_m, obb_accum.obb_accumulate_plain(*margs, max_clusters=k,
                                                            num_angles=a))):
        for key in ("cnt", "zlo", "zhi", "ulo", "uhi", "vlo", "vhi"):
            assert torch.equal(got[key], ref[key]), key


COMPACT_INDEX_CASES = {  # id: (size, n_set, m, offset (a view flag[offset:]), set only in the last tile)
    "fewer": (4 << 20, 3500, 4096, 0, False),
    "exactly-m": (100_003, 4096, 4096, 0, False),
    "more": (100_003, 9000, 4096, 0, False),
    "none-set": (7, 0, 3, 0, False),
    "n1-set": (1, 1, 4, 0, False),
    "n1-unset": (1, 0, 4, 0, False),
    "last-tile": (4096 * 300 + 3000, 500, 4096, 0, True),
    "unaligned": (100_003, 2000, 4096, 1, False),
    "m>n": (3000, 1500, 5000, 0, False),
    "all-set": (50_000, 50_000, 4096, 0, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(COMPACT_INDEX_CASES), ids=list(COMPACT_INDEX_CASES))
def test_compact_indices_kernel_matches_plain(cuda, case):
    size, n_set, m, offset, last_tile = COMPACT_INDEX_CASES[case]
    if last_tile:
        flag = np.zeros(size, bool)
        tail = size % 4096  # the last rows, in the last (ragged) tile
        flag[size - tail:] = flag_inputs(15, tail, n_set)
    else:
        flag = flag_inputs(15, size + offset, n_set)
    flag = t(flag, cuda)[offset:]
    before = compactidx.launches
    got = compactidx.compact_indices(flag, m)
    ref = compactidx.compact_indices_plain(flag, m)
    torch.cuda.synchronize()
    assert compactidx.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref)


def dupwin_inputs(seed, size, max_run, kind):
    """k1 and w for dupwin: sorted key runs (the callers' keys), the same
    rows shuffled inside groups of 96 ("unsorted"), sorted up to the
    middle and shuffled after ("mixed": early tiles sorted, later ones
    not), or every row equal."""
    k1, rng = key_runs(seed, size, max_run)
    w = rng.integers(0, max(2, max_run // 4), size).astype(np.int32)
    # shuffled inside groups of 96 rows, so that equal rows stay near
    local = np.argsort(np.arange(size) // 96 + rng.random(size) * 0.5, kind="stable")
    if kind == "unsorted":
        k1, w = k1[local], w[local]
    elif kind == "mixed":
        perm = np.where(np.arange(size) < size // 2, np.arange(size), local)
        k1, w = k1[perm], w[perm]
    elif kind == "equal":
        k1[:], w[:] = 7, 3
    return k1, w


DUPWIN_CASES = {
    "tight": (4 << 20, 33, 16, "sorted"),
    "untight": (4 << 20, 200, 64, "sorted"),
    "depth1": (100_003, 3, 1, "sorted"),
    "tiny": (5, 9, 64, "sorted"),
    "deep-halo": (70_000, 20_000, 20_000, "sorted"),
    "unsorted": (300_001, 40, 64, "unsorted"),
    "unsorted-depth16": (300_001, 40, 16, "unsorted"),
    "sorted-then-unsorted": (1 << 20, 90, 64, "mixed"),
    "runs-beyond-depth": (1 << 20, 1000, 64, "sorted"),
    "runs-beyond-depth16": (1 << 20, 300, 16, "sorted"),
    "all-equal": (100_003, 1, 64, "equal"),
    "all-equal-depth17": (100_003, 1, 17, "equal"),
    **{f"depth{d}": (200_003, 2 * d + 5, d, "sorted") for d in (1, 15, 16, 17, 63, 64, 65, 127)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DUPWIN_CASES), ids=list(DUPWIN_CASES))
def test_dupwin_kernel_matches_plain(cuda, case):
    """Sorted tiles compare w back to the run start, other tiles (k1, w)
    in full: either way the flags equal the plain version's."""
    size, max_run, depth, kind = DUPWIN_CASES[case]
    k1, w = dupwin_inputs(16, size, max_run, kind)
    args = (t(k1, cuda), t(w, cuda), depth)
    got = dupwin.first_occurrence_flags(*args)
    ref = dupwin.first_occurrence_flags_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and torch.equal(got, ref)


def winsort_inputs(seed, size, max_run, kind):
    """Sorted k1 in runs and 15-bit w; "one-run": every row one k1;
    "distinct": a new k1 every row; "pad": the last run holds k1
    0xFFFFFFFF, the padding's key, with w at 0x7FFF and above, beside the
    pad rows."""
    k1, rng = key_runs(seed, size, max_run)
    w = rng.integers(0, 1 << 15, size).astype(np.int32)
    if kind == "one-run":
        k1[:] = 12345
    elif kind == "distinct":
        k1 = np.arange(size, dtype=np.int64) * 3
    elif kind == "pad":
        tail = min(size, max_run)
        k1[-tail:] = 0xFFFFFFFF
        w[-tail:] = rng.choice(np.array([0x7FFE, 0x7FFF, 0x8000, 0xFFFF], np.int32), tail)
    return k1, w


WINSORT_CASES = {
    "bench": (4 << 20, 256, 129, "runs"),
    "dense": (4 << 20, 256, 700, "runs"),
    "w512-pad": (100_003, 512, 257, "runs"),
    "one-window": (1000, 1024, 40, "runs"),
    "w2": (777, 2, 3, "runs"),
    "w6-not-pow2": (3000, 6, 5, "runs"),
    "w2048": (1 << 20, 2048, 1100, "runs"),
    "w4096-pad": (100_003, 4096, 2100, "runs"),
    "w16384-chunks": (1 << 20, 16384, 9000, "runs"),
    "w32768-chunks": (131_072, 32_768, 17_000, "runs"),
    "w20002-chunks-not-pow2": (100_003, 20_002, 11_000, "runs"),
    "w131072-chunks": (300_000, 131_072, 70_000, "runs"),
    "w-above-n": (5000, 40_000, 100, "runs"),
    # each boundary of the dispatch: a warp a window, a block a window,
    # ranked chunks, 64-bit chunks
    "w256": (1 << 18, 256, 129, "runs"),
    "w258": (100_003, 258, 130, "runs"),
    "w512": (1 << 18, 512, 257, "runs"),
    "w514": (100_003, 514, 258, "runs"),
    "w4096": (1 << 20, 4096, 2100, "runs"),
    "w4098": (100_003, 4098, 2100, "runs"),
    "w32768": (1 << 20, 32_768, 17_000, "runs"),
    "w32770": (200_000, 32_770, 17_000, "runs"),
    "w65536": (300_000, 65_536, 33_000, "runs"),
    # N against the block's windows (T = 15 at W 256, 3 at 2,048) and W/2
    "w256-ragged-blocks": (256 * 15 * 3 + 256 * 5 + 77, 256, 129, "runs"),
    "w2048-ragged-blocks": (2048 * 3 * 5 + 2048 + 1001, 2048, 1100, "runs"),
    "w256-n-below-half": (100, 256, 20, "runs"),
    "w4096-n-below-half": (1000, 4096, 300, "runs"),
    "w32768-n-below-half": (10_000, 32_768, 5000, "runs"),
    "w256-n-half-plus-1": (129, 256, 50, "runs"),
    "w4096-n-half-plus-1": (2049, 4096, 600, "runs"),
    "w32768-n-half-plus-1": (16_385, 32_768, 5000, "runs"),
    "w256-one-run": (1 << 16, 256, 1, "one-run"),
    "w4096-one-run": (20_000, 4096, 1, "one-run"),
    "w32768-one-run": (70_000, 32_768, 1, "one-run"),
    "w256-distinct": (1 << 16, 256, 1, "distinct"),
    "w2048-distinct": (20_000, 2048, 1, "distinct"),
    "w16384-distinct": (70_000, 16_384, 1, "distinct"),
    "w256-pad-7fff": (1037, 256, 100, "pad"),
    "w4096-pad-7fff": (5003, 4096, 1500, "pad"),
    "w32768-pad-7fff": (40_011, 32_768, 9000, "pad"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WINSORT_CASES), ids=list(WINSORT_CASES))
def test_winsort_kernel_matches_plain(cuda, case):
    """Windows up to 256 rows sort a warp a window, up to 4,096 a block a
    window (both passes in one launch), larger ones in 4,096-key chunks
    through the scratch buffer (ranked 32-bit keys up to 32,768 rows,
    64-bit above): the kernel runs (its launch counted) and equals the
    plain version."""
    size, window, max_run, kind = WINSORT_CASES[case]
    k1, w = winsort_inputs(17, size, max_run, kind)
    args = (t(k1, cuda), t(w, cuda), window)
    before = winsort.launches
    got = winsort.window_sort_w(*args)
    assert winsort.launches == before + 1
    ref = winsort.window_sort_w_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_sort_mode_wrappers_make_no_host_sync(cuda):
    """window_sort_w (one block a window, and chunked) and
    first_occurrence_flags launch with no device-to-host read."""
    k1, w = winsort_inputs(19, 100_003, 129, "runs")
    k1t, wt = t(k1, cuda), t(w, cuda)
    winsort.window_sort_w(k1t, wt, 256)  # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [winsort.window_sort_w(k1t, wt, ww) for ww in (256, 2048, 16384)]
        flags = [dupwin.first_occurrence_flags(k1t, wt, d) for d in (16, 64)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, ww in zip(got, (256, 2048, 16384)):
        assert torch.equal(g, winsort.window_sort_w_plain(k1t, wt, ww))
    for f, d in zip(flags, (16, 64)):
        assert torch.equal(f, dupwin.first_occurrence_flags_plain(k1t, wt, d))


MERGE_BLOCKS = [32 << i for i in range(9)]  # every power of two from 32 to 8192
MERGE_CASES = {
    "bench": (4 << 20, 8192, "random"),
    "all-equal": (1 << 18, 2048, "all-equal"),
    "reversed": (1 << 18, 2048, "reversed"),
    "sentinel-heavy": (1 << 18, 2048, "sentinel-heavy"),
    "skewed": (1 << 18, 2048, "skewed"),
    "one-round": (4096, 2048, "random"),
    "tile32": (1 << 16, 32, "negative"),
    "extremes": (1 << 20, 1024, "extremes"),
    "extremes-4M": (4 << 20, 8192, "extremes"),
    "sorted": (4 << 20, 8192, "sorted"),
    "offset-view": (1 << 16, 2048, "random"),
    **{f"2x-block{b}": (2 * b, b, "negative") for b in MERGE_BLOCKS},
    **{f"4M-block{b}": (4 << 20, b, "negative") for b in MERGE_BLOCKS},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MERGE_CASES), ids=list(MERGE_CASES))
def test_mergesort_kernel_matches_plain(cuda, case):
    size, block, kind = MERGE_CASES[case]
    hi, lo = merge_inputs(18, size, kind)
    args = (t(hi, cuda), t(lo, cuda))
    if case == "offset-view":  # views off the 16-byte alignment the block sort loads at
        args = tuple(t(np.concatenate([[0], a]).astype(np.int32), cuda)[1:] for a in (hi, lo))
    got = mergesort.merge_sort_2key(*args, block=block)
    ref = mergesort.merge_sort_2key_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and torch.equal(g, r)


@pytest.mark.cuda
def test_fused_extract_step_cuda_matches_cpu(cuda):
    """The fused fast path on the card equals the CPU run (the plain
    versions) on a small corridor tile: every _cut exit identical, and the
    whole step's labels, keep and counts identical (the OBB sums add in
    another order)."""
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
    from pointcloudhookup_tpu_torch.ops import frontend_fused

    pts, _ = synthetic_corridor(
        np.random.default_rng(42), n_ground=4000, n_veg=800, pts_per_tower=400,
        extent=250.0,
    )
    cap = 8192
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    mask = np.arange(cap) < len(pts)
    params = ExtractParams(
        ground=GroundParams(min_points_after=100),
        cluster=ClusterParams(eps=5.0, min_points=30), max_clusters=32, obb_angles=64,
    )
    kw = dict(max_cells=2048, min_cell_points=1, geometric_voxels=True, emit="codes",
              return_cells_overflow=True)
    for cut in (1, 2, 3, 4, 5, 0):
        got = frontend_fused.fused_downsample_ground_cluster(
            t(xyz, cuda), t(mask, cuda), params, _cut=cut, **kw)
        ref = frontend_fused.fused_downsample_ground_cluster(
            t(xyz), t(mask), params, _cut=cut, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g.cpu(), r), cut
    step_kw = dict(max_cells=2048, min_cell_points=1, geometric_voxels=True)
    got = frontend_fused.fused_extract_step(t(xyz, cuda), t(mask, cuda), params, **step_kw)
    ref = frontend_fused.fused_extract_step(t(xyz), t(mask), params, **step_kw)
    for key in ("labels", "ground_keep", "count", "alive", "accepted", "cells_overflow"):
        assert torch.equal(got[key].cpu(), ref[key]), key
    np.testing.assert_allclose(n(got["center"]), n(ref["center"]), atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw",
    [dict(sort_mode="cell", plan=True), dict(sort_mode="cell"), dict(sort_mode="hier"),
     dict(sort_mode="hier", hier_window=512), dict(sort_mode="merge"), dict(obb="sort"),
     dict(geometric_voxels=False)],
    ids=["cell-tight", "cell-untight", "hier", "hier-512", "merge", "obb-sort",
         "centroid-voxels"],
)
def test_fused_sort_modes_cuda_match_cpu(cuda, kw):
    """Each sort mode, the sort-based OBB and centroid voxels on the card
    equal the CPU run on a 32,768-row tile (a power of two: merge takes its
    kernel): labels, keep, counts and accepted identical, centres within
    1 mm (OBB sums and voxel centroids add in another order)."""
    from pointcloudhookup_tpu_torch.config import ExtractParams
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
    from pointcloudhookup_tpu_torch.ops import frontend_fused

    pts, _ = synthetic_corridor(
        np.random.default_rng(6), n_ground=26_000, n_veg=3_500,
        towers=((-60.0, 0.0), (60.0, 10.0)), pts_per_tower=1_500, extent=150.0,
    )
    cap = 32768
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)[:cap]
    mask = np.arange(cap) < len(pts)
    kw = dict(kw)
    if kw.pop("plan", False):
        kw["cell_plan"] = frontend_fused.cell_sort_plan(np.ptp(pts, axis=0))
    step_kw = dict(dict(max_cells=4096, min_cell_points=2, geometric_voxels=True), **kw)
    params = ExtractParams(max_clusters=32)
    got = frontend_fused.fused_extract_step(t(xyz, cuda), t(mask, cuda), params, **step_kw)
    ref = frontend_fused.fused_extract_step(t(xyz), t(mask), params, **step_kw)
    for key in ("labels", "ground_keep", "count", "alive", "accepted", "cells_overflow",
                "hier_runs_over"):
        assert torch.equal(got[key].cpu(), ref[key]), key
    assert int(ref["accepted"].sum()) == 2
    np.testing.assert_allclose(n(got["center"]), n(ref["center"]), atol=1e-3)


@pytest.mark.cuda
def test_exact_extract_graph_cuda_matches_cpu(cuda):
    """Every stage of the exact path on the card equals the CPU run (the
    plain versions, which the CPU suite holds against the JAX package):
    a small corridor tile, stage by stage through _cut and whole."""
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
    from pointcloudhookup_tpu_torch.ops import frontend_exact

    pts, _ = synthetic_corridor(
        np.random.default_rng(3), n_ground=20_000, n_veg=4_000,
        towers=((0.0, 0.0), (160.0, 60.0), (-170.0, -80.0)),
        pts_per_tower=1_500, extent=300.0,
    )
    cap = 32768
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    mask = np.arange(cap) < len(pts)
    params = ExtractParams(
        ground=GroundParams(min_points_after=100),
        cluster=ClusterParams(eps=5.0, min_points=30, method="grid", max_cells=4096),
        max_clusters=32, obb_angles=64,
    )
    kw = dict(
        cell_bits=frontend_exact.exact_cell_plan(np.ptp(pts, axis=0), 5.0),
        compact_cap=cap, max_cells=4096, core_cap=2048,
    )
    for cut in (1, 2, 4, 41, 42, 5, 6, 0):
        got = frontend_exact.exact_extract_graph(t(xyz, cuda), t(mask, cuda), params,
                                                 _cut=cut, **kw)
        ref = frontend_exact.exact_extract_graph(t(xyz), t(mask), params, _cut=cut, **kw)
        for key, r in ref.items():
            g = got[key].cpu()
            if cut == 0 and key in ("centroid", "center", "extent", "angle", "north_angle"):
                # f32 sums in another order (atomics); see test_torch_frontend_exact
                np.testing.assert_allclose(n(g), n(r), atol=1.0, err_msg=key)
            else:
                assert torch.equal(g, r), (cut, key)


@pytest.mark.cuda
def test_kernels_refuse_cpu_mix(cuda):
    keep = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        compactrows.compact_rows_multi(keep, (torch.zeros(8, dtype=torch.int32),), 8)
