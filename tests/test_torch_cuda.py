"""The hand-written CUDA kernels against their plain PyTorch versions on
the same inputs, on the card.  Every test is marked ``cuda`` and skips
where ``torch.cuda.is_available()`` is false.  This file imports no jax,
so it also runs on a GPU machine without it (tests/conftest.py does
import jax; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs, pop and the OBB counts and extremes must be identical
(one angle table, the same per-row rounding); OBB sums agree to f32
summation order (atomics add in run order)."""

import time

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
from pointcloudhookup_tpu_torch.utils import trace

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
    before = trace.counter("kernel.segmented_scan")
    for op, reverse in SCAN_OPS:
        got = segscan.segmented_scan(v, f, op, reverse)
        ref = segscan.segmented_scan_plain(v, f, op, reverse)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (op, reverse)
    # the kernel, not the plain version
    assert trace.counter("kernel.segmented_scan") == before + len(SCAN_OPS)


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
        before = trace.counter("kernel.segmented_scan")
        got = segscan.segmented_scan(vals, flags, op, reverse)
        assert trace.counter("kernel.segmented_scan") == before + 1
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
                                  obb_accum.obb_accumulate_xyz_plain,
                                  "kernel.obb_accumulate_xyz")
    else:
        xyz = vox
        args = tuple(t(v, cuda) for v in (hi, lo, lab, mn))
        kernel, plain, counter = (obb_accum.obb_accumulate, obb_accum.obb_accumulate_plain,
                                  "kernel.obb_accumulate")
    before = trace.counter(counter)
    got = kernel(*args, max_clusters=k, num_angles=a)
    assert trace.counter(counter) == before + 1
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
    before = trace.counter("kernel.compact_indices")
    got = compactidx.compact_indices(flag, m)
    ref = compactidx.compact_indices_plain(flag, m)
    torch.cuda.synchronize()
    assert trace.counter("kernel.compact_indices") == before + 1
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
    before = trace.counter("kernel.window_sort_w")
    got = winsort.window_sort_w(*args)
    assert trace.counter("kernel.window_sort_w") == before + 1
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


# ------------------------------------------------------------------
# The modular extraction path on the card


def corridor_rows(seed=42, cap=8192):
    """tests/conftest.py's ~6.2k-point corridor, centred and padded."""
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

    pts, _ = synthetic_corridor(
        np.random.default_rng(seed), n_ground=4000, n_veg=800, pts_per_tower=400,
        extent=250.0,
    )
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    return xyz, np.arange(cap) < len(pts)


def modular_calls():
    """name -> f(xyz, keep): the clustering functions of extract_step."""
    from pointcloudhookup_tpu_torch.ops import cluster, cluster_adaptive, cluster_grid

    return {
        "dbscan": lambda x, m: cluster.dbscan(x, m, 5.0, 30),
        "dbscan_chunked": lambda x, m: cluster.dbscan_chunked(x, m, 5.0, 30,
                                                              chunk_size=4096),
        "grid_dbscan": lambda x, m: cluster_grid.grid_dbscan(
            x, m, 7.3, 30, max_cells=4096),
        "grid_dbscan-tensor-eps": lambda x, m: cluster_grid.grid_dbscan(
            x, m, torch.tensor(6.0, device=x.device), 30, max_cells=1024,
            min_cell_points=2),
        "adaptive_cluster": lambda x, m: cluster_adaptive.adaptive_cluster(
            x, m, 12, max_cells=4096),
    }


def ground_keep(xyz, mask):
    from pointcloudhookup_tpu_torch.config import GroundParams
    from pointcloudhookup_tpu_torch.ops.ground import ground_filter

    return ground_filter(xyz, mask, GroundParams(min_points_after=100))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dbscan", "dbscan_chunked", "grid_dbscan",
                                  "grid_dbscan-tensor-eps", "adaptive_cluster"])
def test_modular_clustering_cuda_matches_cpu(cuda, name):
    """Each clustering function of the modular path on the card equals its
    run on the CPU (the kernels' plain versions): labels, core, the
    overflow count and the adaptive eps identical."""
    fn = modular_calls()[name]
    xyz, mask = corridor_rows()
    keep = ground_keep(t(xyz), t(mask))
    ref = fn(t(xyz), keep)
    got = fn(t(xyz, cuda), keep.to(cuda))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r)
    assert int(ref[0].max()) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("name,rows", [("dbscan", 8192), ("dbscan_chunked", 4096),
                                       ("grid_dbscan", 4096)])
def test_modular_clustering_max_iters_cuda(cuda, name, rows):
    """max_iters on the card: the kernels compute the fixpoint, so a bound
    at or above the rows of one cluster_cells call (the tile, the chunk,
    the cell table) gives the unbounded result, and a smaller one raises
    (no rounds to truncate)."""
    from pointcloudhookup_tpu_torch.ops import cluster, cluster_grid

    fn = {
        "dbscan": lambda x, m, **kw: cluster.dbscan(x, m, 5.0, 30, **kw),
        "dbscan_chunked": lambda x, m, **kw: cluster.dbscan_chunked(
            x, m, 5.0, 30, chunk_size=4096, **kw),
        "grid_dbscan": lambda x, m, **kw: cluster_grid.grid_dbscan(
            x, m, 7.3, 30, max_cells=4096, **kw),
    }[name]
    xyz, mask = corridor_rows()
    x, keep = t(xyz, cuda), ground_keep(t(xyz, cuda), t(mask, cuda))
    ref = fn(x, keep)
    for g, r in zip(fn(x, keep, max_iters=rows), ref):
        assert torch.equal(g, r)
    with pytest.raises(ValueError, match="max_iter"):
        fn(x, keep, max_iters=64)


@pytest.mark.cuda
def test_modular_clustering_makes_no_host_sync(cuda):
    """dbscan, grid_dbscan and adaptive_cluster issue their work with no
    device-to-host read: one cluster_cells call (its union-find kernels)
    where the JAX package loops over Jacobi rounds, grid_dbscan's two
    segscan calls and its compactrows table pack."""
    xyz, mask = corridor_rows()
    x, keep = t(xyz, cuda), ground_keep(t(xyz, cuda), t(mask, cuda))
    calls = modular_calls()
    for fn in calls.values():  # builds the library, warms the allocator
        fn(x, keep)
    torch.cuda.synchronize()
    counters = ("kernel.cluster_cells", "kernel.segmented_scan", "kernel.compact_rows_multi")
    for name in ("dbscan", "grid_dbscan", "adaptive_cluster"):
        before = [trace.counter(c) for c in counters]
        torch.cuda.set_sync_debug_mode("error")
        try:
            calls[name](x, keep)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ran = [trace.counter(c) - b for c, b in zip(counters, before)]
        assert ran == ([1, 0, 0] if name == "dbscan" else [1, 2, 1]), (name, ran)
    kernels, _ = device_kernels(lambda: calls["dbscan"](x, keep))
    for k in ("boxes_kernel", "pop_kernel", "union_kernel", "compress_kernel",
              "border_kernel"):
        assert any(k in name for name in kernels), (k, kernels)
    kernels, _ = device_kernels(lambda: calls["grid_dbscan"](x, keep))
    assert sum("segscan_kernel" in k for k in kernels) == 2, kernels
    assert sum("compact_kernel" in k for k in kernels) == 1, kernels
    assert any("union_kernel" in k for k in kernels), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["auto", "exact", "grid", "adaptive", "per-chunk",
                                    "entry"])
def test_extract_step_cuda_matches_cpu(cuda, method):
    """extract_step in each method on the card equals the CPU run: labels,
    keep, counts, alive, accepted and cells_overflow identical, centres
    within 1 mm (the OBB sums add in another order); "entry" is entry()'s
    60,000-point batch with default parameters."""
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams
    from pointcloudhookup_tpu_torch.entry import entry
    from pointcloudhookup_tpu_torch.models.towers import extract_step

    if method == "entry":
        fn, (x, m) = entry("cpu")
        ref = fn(x, m)
        got = fn(x.to(cuda), m.to(cuda))
    else:
        kw = dict(per_chunk=True, chunk_size=4096) if method == "per-chunk" else dict(
            method=method)
        params = ExtractParams(
            ground=GroundParams(min_points_after=100),
            cluster=ClusterParams(eps=5.0, min_points=30, max_cells=4096, **kw),
            max_clusters=32, obb_angles=64,
        )
        xyz, mask = corridor_rows()
        ref = extract_step(t(xyz), t(mask), params)
        got = extract_step(t(xyz, cuda), t(mask, cuda), params)
    for key in ("labels", "ground_keep", "count", "alive", "accepted", "cells_overflow",
                "base_height"):
        assert torch.equal(got[key].cpu(), ref[key]), key
    assert int(ref["accepted"].sum()) == 3
    acc = ref["accepted"]
    np.testing.assert_allclose(n(got["center"])[n(acc)], n(ref["center"])[n(acc)], atol=1e-3)


# ------------------------------------------------------------------
# Voxel downsampling (compress) on the card


def voxel_rows(seed=12, n=100_000, cap=131_072):
    """A corridor tile (towers, vegetation, ground), centred and padded."""
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

    pts, _ = synthetic_corridor(
        np.random.default_rng(seed), n_ground=int(n * 0.8), n_veg=int(n * 0.12),
        pts_per_tower=int(n * 0.08) // 3, extent=300.0,
    )
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    return xyz, np.arange(cap) < len(pts)


def voxel_call(chunk_size):
    from pointcloudhookup_tpu_torch.ops import voxel

    if chunk_size is None:
        return voxel.voxel_downsample
    return lambda x, m, vs: voxel.voxel_downsample_chunked(x, m, vs, chunk_size=chunk_size)


@pytest.mark.cuda
@pytest.mark.parametrize("voxel_size", [0.1, 0.5])
@pytest.mark.parametrize("chunk_size", [None, 16_384], ids=["global", "chunked"])
def test_voxel_downsample_cuda_matches_cpu(cuda, chunk_size, voxel_size):
    """voxel_downsample(_chunked) on the card against the CPU run (the
    plain segmented scan, which the CPU suite holds bit-equal to the JAX
    package): the same sort order and voxel keys, the same output rows, and
    centroids within the f32 summation bound (the kernel adds each voxel's
    rows in another fixed order: a sum of c rows within c 2**-23 sum|x|,
    then one rounding of the division on each side).  The card run makes
    no host sync and one segscan launch."""
    from pointcloudhookup_tpu_torch.ops import voxel

    fn = voxel_call(chunk_size)
    xyz, mask = voxel_rows()
    ref_xyz, ref_mask = fn(t(xyz), t(mask), voxel_size)
    x, m = t(xyz, cuda), t(mask, cuda)
    fn(x, m, voxel_size)  # builds the library, warms the allocator
    torch.cuda.synchronize()
    before = trace.counter("kernel.segmented_scan")
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_xyz, got_mask = fn(x, m, voxel_size)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert trace.counter("kernel.segmented_scan") == before + 1
    assert torch.equal(got_mask.cpu(), ref_mask)
    n_out = int(ref_mask.sum())
    assert 0 < n_out < int(mask.sum())

    # the order and keys, from the same sort on both devices
    big = np.float32(3.0e38)
    masked = np.where(mask[:, None], xyz, big)
    if chunk_size is None:
        mn = masked.min(axis=0)
        chunk = None
    else:
        mn = np.repeat(masked.reshape(-1, chunk_size, 3).min(axis=1), chunk_size, axis=0)
        chunk = torch.arange(len(mask), dtype=torch.int64) // chunk_size
    o_ref, k_ref = voxel.voxel_order(t(xyz), t(mask), t(mn), voxel_size, chunk)
    o_got, k_got = voxel.voxel_order(x, m, t(mn, cuda), voxel_size,
                                     None if chunk is None else chunk.to(cuda))
    assert torch.equal(o_got.cpu(), o_ref)
    assert all(torch.equal(g.cpu(), r) for g, r in zip(k_got, k_ref))

    # centroids: c rows of magnitude at most |centroid| + voxel_size each;
    # c from the sorted keys (valid rows of each voxel)
    pos = np.flatnonzero(n(ref_mask))
    start = np.arange(len(mask)) == 0
    for k in k_ref:
        start[1:] |= n(k)[1:] != n(k)[:-1]
    seg = np.cumsum(start) - 1
    counts = np.bincount(seg[mask[n(o_ref)]], minlength=int(seg[-1]) + 1)[seg[pos]]
    assert start[pos].all() and counts.min() >= 1 and counts.sum() == int(mask.sum())
    ref_c = n(ref_xyz)[pos].astype(np.float64)
    got_c = n(got_xyz)[pos].astype(np.float64)
    bound = ((counts[:, None] * 2.0**-23 + 2.0**-22) * (np.abs(ref_c) + voxel_size))
    assert (np.abs(got_c - ref_c) <= bound).all()
    assert (n(got_xyz)[~n(ref_mask)] == 0).all()


# ------------------------------------------------------------------
# Registration and tile streaming: the card against the CPU.

def _tower_cloud(rng, n):
    t_param = rng.uniform(0, 1, n)
    half = 6.0 * (1 - 0.7 * t_param)
    return np.column_stack([rng.uniform(-1, 1, n) * half, rng.uniform(-1, 1, n) * half,
                            t_param * 35.0]).astype(np.float32)


def _icp_batch(seed=0, b=6, n=512):
    rng = np.random.default_rng(seed)
    src = np.zeros((b, n, 3), np.float32)
    dst = np.zeros((b, n, 3), np.float32)
    sm = np.zeros((b, n), bool)
    dm = np.zeros((b, n), bool)
    for i in range(b):
        a, c = int(rng.integers(64, n + 1)), int(rng.integers(64, n + 1))
        cloud = _tower_cloud(rng, max(a, c))
        ang = rng.uniform(-0.15, 0.15)
        rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                        [0, 0, 1]])
        src[i, :a], sm[i, :a] = cloud[:a], True
        dst[i, :c], dm[i, :c] = cloud[:c] @ rot.T + rng.uniform(-1, 1, 3), True
    return src, sm, dst, dm


@pytest.mark.cuda
def test_nearest_cuda_bit_equal_to_cpu_and_tiled(cuda, monkeypatch):
    from pointcloudhookup_tpu_torch.ops.kernels import nearest

    src, sm, dst, dm = _icp_batch()
    ref_i, ref_d = nearest._nearest(t(src), t(sm), t(dst), t(dm))
    args = [t(a, cuda) for a in (src, sm, dst, dm)]
    row_elems = dst.shape[0] * dst.shape[1]
    for rows in (None, 7, 100):
        if rows is not None:  # tiles of that many source rows
            monkeypatch.setattr(nearest, "NEAREST_TILE_ELEMS", rows * row_elems)
        i, d = nearest._nearest(*args)
        assert torch.equal(i.cpu(), ref_i) and torch.equal(d.cpu(), ref_d)


@pytest.mark.cuda
def test_fma_f32_cuda_bit_equal_to_cpu(cuda):
    """fma_f32 on the card (torch.addcmul) gives the bits of its float64
    form on the CPU, also where a * b nearly cancels c."""
    from pointcloudhookup_tpu_torch.ops.morton import fma_f32

    rng = np.random.default_rng(3)
    a = (rng.standard_normal(1 << 20) * 100).astype(np.float32)
    b = rng.standard_normal(1 << 20).astype(np.float32)
    for c in ((rng.standard_normal(1 << 20) * 50).astype(np.float32),
              -(a.astype(np.float64) * b).astype(np.float32)):
        ref = fma_f32(t(a), t(b), t(c))
        assert torch.equal(fma_f32(t(a, cuda), t(b, cuda), t(c, cuda)).cpu(), ref)


@pytest.mark.cuda
def test_batched_icp_cuda_matches_cpu(cuda):
    """R within 1e-4, t within 1e-3 m, rmse within 1e-4 m of the CPU run
    (both below 0.03 m for an exact fit, whose rmse is rounding noise):
    d^2 and every correspondence are bit-equal, the Kabsch sums differ in
    order and torch.linalg.svd's U and V in sign."""
    from pointcloudhookup_tpu_torch.ops import registration as reg

    src, sm, dst, dm = _icp_batch(1)
    for radius in (float("inf"), 0.5):
        ref = reg.batched_icp(t(src), t(sm), t(dst), t(dm), iters=15, max_corr_dist=radius)
        got = reg.batched_icp(*(t(a, cuda) for a in (src, sm, dst, dm)), iters=15,
                              max_corr_dist=radius)
        np.testing.assert_allclose(n(got["R"]), n(ref["R"]), rtol=0, atol=1e-4)
        np.testing.assert_allclose(n(got["t"]), n(ref["t"]), rtol=0, atol=1e-3)
        # an exact fit's rmse is the root of rounding noise: below 0.03 m on both
        exact = n(ref["rmse"]) < 0.03
        assert (n(got["rmse"])[exact] < 0.03).all()
        np.testing.assert_allclose(n(got["rmse"])[~exact], n(ref["rmse"])[~exact], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(n(got["inlier_frac"]), n(ref["inlier_frac"]), rtol=0,
                                   atol=1.0 / 64)


# name: (B, N, M, what the masks and rows hold).  Frame rows are the
# 280-row tower frame where N is 280, tower-like clouds otherwise.
SWEEP_CASES = {
    "icp50": (50, 280, 14_000, "ragged"),      # the icp50.correct cell's batch
    "config4": (50, 2048, 2048, "full"),       # BASELINE config 4
    "register": (24, 14_000, 600, "ragged"),   # member clouds onto GIM pylons: N >> M
    "b1-n1-m1": (1, 1, 1, "full"),
    "m-not-chunk": (3, 100, 1537, "full"),     # M = 3 x 512 + 1 destination rows
    "m-chunk-plus-one": (2, 33, 513, "ragged"),
    "holes": (6, 300, 2000, "holes"),
    "ties": (4, 200, 3000, "ties"),
    "nan": (4, 150, 1200, "nan"),
}


def sweep_inputs(case, seed=0):
    """(src, src_mask, dst, dst_mask, r, t) numpy arrays of SWEEP_CASES[case].
    ragged: prefix masks of 85-100 % of the rows; holes: masks with holes,
    a tower with every frame row masked, one with every destination masked
    and one whose destinations are all +inf away (|e|^2 overflows); ties:
    copies of a frame row and rows 1/64 away from one along each axis, at
    scattered indices (the identity motion keeps them exact); nan: NaN and
    inf coordinates in frame rows, in valid and in masked destination
    rows."""
    from pointcloudhookup_tpu_torch.models.refine import tower_frame_template

    b, n, m, kind = SWEEP_CASES[case]
    rng = np.random.default_rng(seed)
    if n == 280:
        src = np.stack([tower_frame_template(rng.uniform(30, 45), rng.uniform(8, 14),
                                             yaw=rng.uniform(-0.3, 0.3)) for _ in range(b)])
    else:
        src = np.stack([_tower_cloud(rng, n) - [0, 0, 17.5] for _ in range(b)])
    dst = np.stack([_tower_cloud(rng, m) - [0, 0, 17.5] for _ in range(b)]).astype(np.float32)
    src = src.astype(np.float32)
    sm, dm = np.ones((b, n), bool), np.ones((b, m), bool)
    if kind == "ragged":
        for i in range(b):
            sm[i, int(rng.integers(int(0.85 * n), n + 1)):] = False
            dm[i, max(1, int(rng.integers(int(0.85 * m), m + 1))):] = False
    elif kind == "holes":
        sm = rng.random((b, n)) < 0.8
        dm = rng.random((b, m)) < 0.5
        sm[1] = False
        dm[2] = False
        dst[3] = np.float32(1e30) * rng.choice([-1.0, 1.0], (m, 3)).astype(np.float32)
    elif kind == "ties":
        for i in range(b):
            rows = rng.choice(n, 20, replace=False)
            src[i, rows] = np.round(src[i, rows] * 4) / 4  # so row +- 1/64 is exact
            for k, row in enumerate(rows):
                at = rng.choice(m, 4, replace=False)
                for q, j in enumerate(at):
                    off = np.zeros(3, np.float32)
                    if k % 2:  # equidistant: 1/64 along a signed axis
                        off[q % 3] = 1 / 64 if q < 3 else -1 / 64
                    dst[i, j] = src[i, row] + off
    elif kind == "nan":
        dm[:, ::7] = False
        src[0, 5, 1], src[0, 9, 0] = np.nan, np.inf  # frame rows only
        dst[1, 302, 2], dst[1, 100, 0] = np.nan, -np.inf  # valid destinations
        dst[2, 350, 1], src[2, 3, 2], dst[2, 500, 2] = np.nan, np.inf, np.inf  # 350 masked
        src[3, 7, 0], dst[3, 11, 0] = -np.inf, -np.inf
    ang = rng.uniform(-0.1, 0.1, b)
    r = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
                  for a in ang]).astype(np.float32)
    r += rng.normal(0, 1e-3, r.shape).astype(np.float32)
    tv = rng.uniform(-0.5, 0.5, (b, 3)).astype(np.float32)
    if kind == "ties":
        r[:] = np.eye(3, dtype=np.float32)
        tv[:] = 0.0
    return src, sm, dst, dm, r, tv


def same_bits(a, b):
    """Equal shapes, dtypes and bits (NaN payloads included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SWEEP_CASES), ids=list(SWEEP_CASES))
def test_nearest_kernel_bit_equal_to_plain(cuda, case):
    """csrc/nearest.cu against its plain version (_moved, _nearest and
    _gather_rows) on the card: every index, d^2 and matched row bit for
    bit."""
    from pointcloudhookup_tpu_torch.ops.kernels import nearest
    from pointcloudhookup_tpu_torch.utils import trace

    arrays = sweep_inputs(case)
    args = [t(a, cuda) for a in arrays]
    before = trace.counter("icp.nearest_kernel")
    got = nearest.nearest_moved(*args)
    ref = nearest.nearest_moved_plain(*args)
    torch.cuda.synchronize()
    assert trace.counter("icp.nearest_kernel") == before + 1
    for name, g, r in zip(("idx", "d2", "matched"), got, ref):
        assert same_bits(g, r), (case, name, int((g != r).sum()))
    if case == "holes":  # every candidate masked or +inf away: index 0, d^2 +inf
        assert (got[0][2:4] == 0).all() and torch.isinf(got[1][2:4]).all()
        assert torch.isinf(got[1][1]).all()
    if case == "nan":
        assert torch.isnan(got[1]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in SWEEP_CASES if c != "nan"],
                         ids=[c for c in SWEEP_CASES if c != "nan"])
def test_batched_icp_kernel_bit_equal_to_plain(cuda, case, monkeypatch):
    """batched_icp on the card with the kernel and with the plain sweep
    (nearest_moved_plain in its place): R, t, rmse and inlier_frac bit for
    bit, so the whole ICP is the plain version's."""
    from pointcloudhookup_tpu_torch.ops import registration as reg
    from pointcloudhookup_tpu_torch.ops.kernels import nearest

    src, sm, dst, dm, _, _ = sweep_inputs(case, seed=1)
    args = [t(a, cuda) for a in (src, sm, dst, dm)]
    got = reg.batched_icp(*args, iters=8, max_corr_dist=2.0)
    monkeypatch.setattr(nearest, "nearest_moved", nearest.nearest_moved_plain)
    ref = reg.batched_icp(*args, iters=8, max_corr_dist=2.0)
    for key in ("R", "t", "rmse", "inlier_frac"):
        assert same_bits(got[key], ref[key]), (case, key)


@pytest.mark.cuda
def test_nearest_kernel_makes_no_host_sync_and_refuses(cuda):
    """The wrapper launches with no device-to-host read, and raises on
    inputs the kernel does not take."""
    from pointcloudhookup_tpu_torch.ops.kernels import nearest

    args = [t(a, cuda) for a in sweep_inputs("m-chunk-plus-one")]
    ref = nearest.nearest_moved(*args)  # builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = nearest.nearest_moved(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(same_bits(g, r) for g, r in zip(got, ref))
    src, sm, dst, dm, r, tv = args
    for bad in ((src.double(), sm, dst, dm, r, tv), (src, sm, dst.cpu(), dm, r, tv),
                (src, sm, dst, dm, r.mT, tv), (src, sm.to(torch.uint8), dst, dm, r, tv),
                (src, sm, dst[:, :0], dm[:, :0], r, tv)):
        with pytest.raises(ValueError):
            nearest.nearest_moved(*bad)


def _stub_corridor(seed=11):
    """Three towers with a one-sided conductor stub each (config 4's
    gim_scenario corridor), in a local frame."""
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

    rng = np.random.default_rng(seed)
    pts, centers = synthetic_corridor(
        rng, n_ground=4000, n_veg=800, pts_per_tower=500,
        towers=((0.0, 0.0), (160.0, 60.0), (-170.0, -80.0)), tower_height=35.0,
        extent=300.0, origin=(500_000.0, 3_120_000.0, 80.0))
    stubs = []
    for c in centers:
        s = rng.uniform(0, 1, 120)
        stubs.append(np.column_stack([c[0] + 1.0 + s * 7.0, c[1] + rng.normal(0, 0.2, 120),
                                      c[2] + 35.0 / 2 - 2.0 - 3.0 * s]))
    return np.vstack([pts] + stubs), centers


@pytest.mark.cuda
def test_refine_tower_centers_cuda_matches_cpu(cuda):
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams
    from pointcloudhookup_tpu_torch.models import pipeline
    from pointcloudhookup_tpu_torch.models.refine import refine_tower_centers

    pts, centers = _stub_corridor()
    params = ExtractParams(ground=GroundParams(min_points_after=100),
                           cluster=ClusterParams(eps=5.0, min_points=30),
                           max_clusters=32, obb_angles=128)
    towers, stats, _ = pipeline.extract_from_points(pts, params, capacity=8192, device="cpu")
    lab = stats["labels"][: len(pts)]
    clouds = [pts[lab == tw.label] for tw in towers]
    idx = list(range(len(towers)))
    tmpl = {i: (35.0, None) for i in idx}
    ref = refine_tower_centers(towers, clouds, idx, template_params=tmpl, device="cpu")
    got = refine_tower_centers(towers, clouds, idx, template_params=tmpl, device=cuda)
    assert len(got) == len(ref) == len(centers)
    for i in ref:
        np.testing.assert_allclose(got[i]["center"], ref[i]["center"], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_refine_launches_nearest_kernel_each_sweep(cuda):
    """One refine_tower_centers call on the card (3 stages of 10 iterations
    and a final sweep): icp.nearest_kernel counts as many launches as
    icp.sweeps counts sweeps, 33."""
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams
    from pointcloudhookup_tpu_torch.models import pipeline
    from pointcloudhookup_tpu_torch.models.refine import refine_tower_centers

    pts, _ = _stub_corridor()
    params = ExtractParams(ground=GroundParams(min_points_after=100),
                           cluster=ClusterParams(eps=5.0, min_points=30),
                           max_clusters=32, obb_angles=128)
    towers, stats, _ = pipeline.extract_from_points(pts, params, capacity=8192, device="cpu")
    lab = stats["labels"][: len(pts)]
    clouds = [pts[lab == tw.label] for tw in towers]
    sweeps, launched = trace.counter("icp.sweeps"), trace.counter("icp.nearest_kernel")
    refine_tower_centers(towers, clouds, list(range(len(towers))), device=cuda)
    sweeps = trace.counter("icp.sweeps") - sweeps
    assert sweeps == 33 and trace.counter("icp.nearest_kernel") - launched == sweeps


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["u16", "f32"])
@pytest.mark.parametrize("fast", [False, True], ids=["modular", "fast"])
def test_stream_extract_cuda_matches_cpu(cuda, fast, wire):
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu_torch.core.streaming import TileStreamer, stream_extract

    pts, centers = _stub_corridor(5)
    tiles = [pts, pts + [400.0, 0.0, 1.0]]
    for (x, m, _), (rx, rm, _) in zip(
            TileStreamer(tiles, capacity=8192, wire=wire, device=cuda),
            TileStreamer(tiles, capacity=8192, wire=wire, device="cpu")):
        assert torch.equal(x.cpu(), rx) and torch.equal(m.cpu(), rm)
    params = ExtractParams(cluster=ClusterParams(eps=5.0, min_points=30))
    kw = dict(capacity=8192, params=params, wire=wire, fast=fast, fetch_labels=True)
    got = stream_extract(tiles, device=cuda, **kw)
    ref = stream_extract(tiles, device="cpu", **kw)
    for (g, _), (r, _) in zip(got, ref):
        acc = r["accepted"]
        assert acc.sum() == len(centers)
        for key in ("accepted", "labels", "count"):
            assert np.array_equal(n(g[key]) if torch.is_tensor(g[key]) else g[key],
                                  r[key]), key
        assert np.abs(g["center"][acc] - r["center"][acc]).max() <= 1e-3


@pytest.mark.cuda
def test_streamed_copy_overlaps_a_running_step(cuda):
    """The producer uploads the next chunk on its own CUDA stream while the
    consumer's stream is still busy: the chunk's upload event completes
    while a long kernel enqueued before it still runs on the consumer's
    stream, and the streamed data are the CPU's."""
    from pointcloudhookup_tpu_torch.core.streaming import TileStreamer

    rng = np.random.default_rng(3)
    tiles = [rng.uniform(0, 500, (200_000, 3)) for _ in range(3)]
    it = iter(TileStreamer(tiles, capacity=262_144, wire="u16", device=cuda, prefetch=1))
    x0, _, _ = next(it)
    busy_done = torch.cuda.Event()
    torch.cuda._sleep(int(3e9))  # ~1.5 s of spinning on the consumer's stream
    x0.sum()  # a step on the chunk in hand, queued behind the spin
    busy_done.record()
    _, _, meta1 = next(it)
    x2, m2, meta2 = next(it)  # prepared and uploaded while the stream spins
    deadline = time.perf_counter() + 1.0
    while not meta2["uploaded"].query() and time.perf_counter() < deadline:
        time.sleep(0.001)
    assert meta2["uploaded"].query(), "the upload did not finish within 1 s"
    assert not busy_done.query(), "the consumer's stream finished first: no overlap"
    torch.cuda.synchronize()
    ref = list(TileStreamer(tiles, capacity=262_144, wire="u16", device="cpu"))[2]
    assert torch.equal(x2.cpu(), ref[0]) and torch.equal(m2.cpu(), ref[1])
    assert list(it) == []


# ------------------------------------------------------------------
# The sharded step (parallel/): ranks on the card against the CPU


def _sharded_inputs(n_ranks, per_rank=8192, seed=4):
    """A corridor sorted by x (slabs along x), towers near the slab edges."""
    from pointcloudhookup_tpu_torch.entry import _boundary_corridor
    from pointcloudhookup_tpu_torch.ops.frontend_exact import exact_cell_plan

    xyz, mask, _ = _boundary_corridor(n_ranks * per_rank, n_towers=6, seed=seed)
    bits = exact_cell_plan(xyz[mask].max(axis=0) - xyz[mask].min(axis=0), 5.0)
    return xyz, mask, bits


def _sharded_params():
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams

    return ExtractParams(ground=GroundParams(min_points_after=64),
                         cluster=ClusterParams(eps=5.0, min_points=16, method="grid"),
                         max_clusters=32, obb_angles=32)


def _run_sharded(n_ranks, backend, devices, mode):
    """Every rank's merged dict of one sharded step (numpy)."""
    from pointcloudhookup_tpu_torch.parallel import launch, sharded

    xyz, mask, bits = _sharded_inputs(n_ranks)
    rows = xyz.shape[0] // n_ranks
    calls = [([(sharded.make_sharded_extract, (),
                dict(params=_sharded_params(), mode=mode, exact_cell_bits=bits),
                (xyz[r * rows:(r + 1) * rows], mask[r * rows:(r + 1) * rows]))],)
             for r in range(n_ranks)]
    out = launch.run_ranks(launch.call_on_rank, calls, backend=backend, devices=devices,
                           timeout=600)
    return [o[0][1] for o in out]


def _same_sharded(got, ref):
    """The same towers and counts; geometry within 1 mm (f32 summation
    order of the centroid sums)."""
    acc = ref["accepted"]
    assert acc.any()
    np.testing.assert_array_equal(got["accepted"], acc)
    np.testing.assert_array_equal(got["count"], ref["count"])
    for key in ("center", "centroid", "extent"):
        assert np.abs(got[key][acc] - ref[key][acc]).max() <= 1e-3, key
    for key in ("base_height", "cells_overflow", "halo_overflow"):
        assert got[key].tobytes() == ref[key].tobytes(), key


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["modular", "fast", "exact"])
def test_sharded_step_one_rank_nccl_matches_cpu(cuda, mode):
    """World size 1 over NCCL (its collectives' dtypes and shapes) against
    one gloo rank on the CPU."""
    (got,) = _run_sharded(1, "nccl", ["cuda:0"], mode)
    (ref,) = _run_sharded(1, "gloo", "cpu", mode)
    _same_sharded(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["modular", "fast", "exact"])
def test_sharded_step_two_ranks_gloo_on_one_card(cuda, mode):
    """Two gloo ranks sharing cuda:0 against two on the CPU; every rank's
    merged dict is rank 0's."""
    got = _run_sharded(2, "gloo", "cuda:0", mode)
    ref = _run_sharded(2, "gloo", "cpu", mode)
    for merged in got[1:]:
        for key, val in got[0].items():
            assert merged[key].tobytes() == val.tobytes(), key
    _same_sharded(got[0], ref[0])


def _gathered_accumulators(seed, d=4, k=32, a=16):
    rng = np.random.default_rng(seed)
    parts = []
    for r in range(d):
        xyz = rng.uniform(-60, 60, (4000, 3)).astype(np.float32)
        xyz[:, 0] += 100.0 * r
        lab = rng.integers(-1, k, 4000).astype(np.int32)
        acc = obb_accum.obb_accumulate_xyz_plain(*(t(xyz[:, i]) for i in range(3)), t(lab),
                                                 max_clusters=k, num_angles=a)
        parts.append({key: n(v) for key, v in acc.items()})
    return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}


@pytest.mark.cuda
def test_merge_accumulators_bit_identical_run_to_run(cuda):
    """The replicated merge on the card: bit-identical over runs and to the
    CPU's (each group summed in row order, one add a round: no order left
    to atomics)."""
    from pointcloudhookup_tpu_torch.parallel.sharded import _merge_accumulators

    acc = _gathered_accumulators(5)
    ref = _merge_accumulators({key: t(v) for key, v in acc.items()}, 25.0)
    runs = [_merge_accumulators({key: t(v, cuda) for key, v in acc.items()}, 25.0)
            for _ in range(3)]
    for got in runs:
        for key, val in ref.items():
            assert n(got[key]).tobytes() == n(val).tobytes(), key


class _TwoRanksLocal:
    """The collectives of rank 0 of two, answered locally (as if the other
    rank held the same rows): no process group, no host sync."""

    rank, size = 0, 2

    def all_reduce(self, x, op):
        return x.clone()

    def all_gather(self, x):
        return torch.stack([x, x + 1.0])

    def shift(self, x, offset):
        return x.clone()


@pytest.mark.cuda
def test_fragment_union_and_halo_make_no_host_sync(cuda):
    """_fragment_union (16 fixed rounds) and the halo exchange's selection
    and packing (one compactrows call a side) never wait for the device."""
    from pointcloudhookup_tpu_torch.parallel.sharded import _fragment_union, _halo_exchange

    acc = {key: t(v, cuda) for key, v in _gathered_accumulators(6).items()}
    alive = acc["cnt"] > 0
    lo = torch.stack([acc["ulo"][:, 0], acc["vlo"][:, 0], acc["zlo"]], dim=1)
    hi = torch.stack([acc["uhi"][:, 0], acc["vhi"][:, 0], acc["zhi"]], dim=1)
    xyz, mask, _ = _sharded_inputs(2)
    xyz_t, mask_t = t(xyz[:8192], cuda), t(mask[:8192], cuda)
    _fragment_union(lo, hi, alive, 6.0)  # warm-up: kernel load, allocator
    _halo_exchange(xyz_t, mask_t, _TwoRanksLocal(), 10.0, 2048)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rep = _fragment_union(lo, hi, alive, 6.0)
        ext, ext_mask, is_local, over = _halo_exchange(xyz_t, mask_t, _TwoRanksLocal(), 10.0,
                                                       2048)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = _fragment_union(lo.cpu(), hi.cpu(), alive.cpu(), 6.0)
    assert torch.equal(rep.cpu(), ref)
    ref_ext = _halo_exchange(xyz_t.cpu(), mask_t.cpu(), _TwoRanksLocal(), 10.0, 2048)
    for got, want in zip((ext, ext_mask, is_local, over), ref_ext):
        assert torch.equal(got.cpu(), want)


# ------------------------------------------------------------------
# The library functions and the renderer on the card against the CPU


@pytest.mark.cuda
def test_render_scene_cuda_pixel_identical_to_cpu(cuda):
    """The projection's f64 dot products are three products summed in one
    order and the divisions are true divisions, so the card's image is the
    CPU's, duplicate pixels and overlapping edges included."""
    from pointcloudhookup_tpu_torch.viz.boxes import tower_display_geometries
    from pointcloudhookup_tpu_torch.viz.render import render_scene

    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform([-200, -40, 0], [200, 40, 3], (60000, 3)),
                          np.repeat(rng.normal([0, 0, 20], 5, (500, 3)), 4, axis=0)])
    towers = [dict(center=rng.uniform([-150, -20, 10], [150, 20, 30]), extent=[8.0, 6.0, 40.0],
                   width=8.0, height=40.0, angle=0.4) for _ in range(5)]
    geoms = tower_display_geometries(towers)
    geoms[1] = (geoms[1][0], (0.0, 1.0, 0.0))
    for kw in (dict(), dict(display_cap=20000, seed=3)):
        got = render_scene(pts, geoms, width=640, height=480, device=cuda, **kw)
        ref = render_scene(pts, geoms, width=640, height=480, device="cpu", **kw)
        assert np.array_equal(got, ref), int((got != ref).any(axis=2).sum())


@pytest.mark.cuda
def test_random_downsample_from_bits_cuda_matches_cpu(cuda):
    from pointcloudhookup_tpu_torch.ops.sample import random_bits, random_downsample_from_bits

    rng = np.random.default_rng(1)
    n = 1 << 20
    xyz = rng.uniform(-500, 500, (n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.9
    bits = random_bits(n, torch.Generator().manual_seed(2))
    for cap in (1000, 500_000, n):
        got = random_downsample_from_bits(t(xyz, cuda), t(mask, cuda), bits.to(cuda), cap)
        ref = random_downsample_from_bits(t(xyz), t(mask), bits, cap)
        assert all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
        assert int(got[1].sum()) == min(cap, int(mask.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [64, 256])
def test_ransac_plane_from_indices_cuda_matches_cpu(cuda, h):
    """The same triples pick the same plane on the card (scores from a full
    float32 cuBLAS product, never TF32); normals within 1e-6."""
    from pointcloudhookup_tpu_torch.ops import ground

    rng = np.random.default_rng(h)
    n = 131_072
    xy = rng.uniform(-300, 300, (n, 2))
    z = 0.5 * np.sin(xy[:, 0] / 90.0) + rng.normal(0, 0.05, n)
    xyz = np.column_stack([xy, z]).astype(np.float32)
    xyz[-5000:, 2] += rng.uniform(3, 40, 5000).astype(np.float32)
    mask = np.ones(n, bool)
    idx = ground.draw_triples(t(mask), h, torch.Generator().manual_seed(5))
    got = ground._best_plane(t(xyz, cuda), t(mask, cuda), idx.to(cuda), 0.5)
    ref = ground._best_plane(t(xyz), t(mask), idx, 0.5)
    assert int(got[3]) == int(ref[3])
    assert float((got[0].cpu() - ref[0]).abs().max()) <= 1e-6
    assert int((got[4].cpu() - ref[4]).abs().max()) <= 2
    keep_g = ground.remove_ground_tiled_ransac_from_indices(
        t(xyz, cuda), t(mask, cuda), ground.draw_tile_triples(
            t(xyz), t(mask), 8, 64, torch.Generator().manual_seed(6)).to(cuda), 0.5, 8)
    keep_c = ground.remove_ground_tiled_ransac_from_indices(
        t(xyz), t(mask), ground.draw_tile_triples(
            t(xyz), t(mask), 8, 64, torch.Generator().manual_seed(6)), 0.5, 8)
    assert int((keep_g.cpu() != keep_c).sum()) <= 5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segment_rows_cuda_match_plain(cuda, dtype):
    """segment_{sum,max,min}_rows on the card (the segscan kernel) against
    the CPU's plain scans: integers, max and min identical, float sums
    within the f32 summation bound."""
    from pointcloudhookup_tpu_torch.ops import segments

    rng = np.random.default_rng(7)
    n = 1 << 20
    keys = np.sort(rng.integers(0, 40_000, n)).astype(np.int32)
    vals = (rng.integers(-1000, 1000, (n, 3)) if dtype == np.int32
            else rng.normal(0, 10, (n, 3))).astype(dtype)
    start_c = segments.boundary_flags(t(keys))
    start_g = segments.boundary_flags(t(keys, cuda))
    assert torch.equal(start_g.cpu(), start_c)
    spans_g, spans_c = segments.segment_spans(start_g), segments.segment_spans(start_c)
    assert all(torch.equal(g.cpu(), c) for g, c in zip(spans_g, spans_c))
    before = trace.counter("kernel.segmented_scan")
    sum_g = segments.segment_sum_rows(t(vals, cuda), start_g, spans_g[1])
    mx_g = segments.segment_max_rows(t(vals, cuda), start_g)
    mn_g = segments.segment_min_rows(t(vals, cuda), start_g)
    assert trace.counter("kernel.segmented_scan") - before == 5
    sum_c = segments.segment_sum_rows(t(vals), start_c, spans_c[1])
    assert torch.equal(mx_g.cpu(), segments.segment_max_rows(t(vals), start_c))
    assert torch.equal(mn_g.cpu(), segments.segment_min_rows(t(vals), start_c))
    if dtype == np.int32:
        assert torch.equal(sum_g.cpu(), sum_c)
    else:
        absum = segments.segment_sum_rows(t(np.abs(vals)), start_c, spans_c[1])
        bound = absum * (2.0 ** -23) * 64
        assert bool(((sum_g.cpu() - sum_c).abs() <= bound + 1e-30).all())
