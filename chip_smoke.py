"""Chip smoke test of the PyTorch + CUDA port (pointcloudhookup_tpu_torch):
the card's correctness gate.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from pointcloudhookup_tpu_torch/csrc
(one nvcc per source, in parallel), makes the 4,194,304-point synthetic
corridor tile of bench.py (seed 7, 80 % ground, 12 % vegetation, 24 towers,
2 km extent), and

  1. the exact path: extracts the towers twice through the user entry point
     ``extract(las, device="cuda")`` and requires 24/24 towers, the centroid
     of each tower's saved member points within 2 m (xy) of a generated
     centre, and every kernel of the path launched;
  2. checks that a small tile extracts identically on the GPU and through
     the plain PyTorch versions on the CPU (which the CPU test suite holds
     against the JAX reference), and that fma_f32 on the card is one
     rounding;
  4. the fast path through its user entry point
     ``extract_from_points_resolving(pts, fast=True, device="cuda")``:
     24/24 towers, each generated tower within 2 m (xy) of an accepted
     tower's centroid, every kernel of the path launched;
  5. bench.py's configuration (fused front-end + accumulator OBB +
     filters; 4,096 cells, density floor 3, pre-cut /6 settled toward /4
     on overflow): 24/24 accepted, no overflow; once more without the
     pre-cut, which packs the cell table with compact_indices;
  7. the fused front-end's other sort modes in bench.py's configuration
     without the pre-cut (the reference pre-cuts only in sort_mode
     "full"): "cell" with the tile's tight cell_sort_plan (dupwin, depth
     16), "cell" without a plan (dupwin, depth 64), "hier" (winsort,
     W 256) and "merge" (mergesort): 24/24 accepted, cells_over 0,
     hier_runs_over printed, the mode's kernel launched;
  6. checks that the fast path on a 131,072-row tile gives the same
     labels, keep, counts and accepted towers on the GPU as through the
     plain versions on the CPU, and tower centres within 1 mm: pre-cut
     "full", each sort mode of phase 7, the sort-based OBB and centroid
     voxels;
  8. the modular path (extract_step) through its user entry points, with
     every kernel's plain version made to raise: (a) extract() of a LAS
     file holding a 196,608-point corridor tile (auto routes it to dbscan),
     every tower found within 2 m; (b) the fast=False resolver on the 4M
     tile with max_clusters halved until the top tile saturates, its
     quadrants on dbscan, 24/24 and resolved; (c) the 4M tile with
     method "grid" at a capacity with no exact plan (grid_dbscan and the
     density-floor retry), towers, floor and cells_overflow printed; (d)
     entry()'s batch and a 100,000-row per-chunk tile on the GPU vs the
     plain versions on the CPU;
  9. the GIM workflow: (a) ``run-all`` through ``__main__.main`` with
     ``--device cuda`` on the bench tile written as a LAS at
     tm_forward(113.5, 28.2) (scale 0.01) and a synthetic GIM of its 24
     towers, with every kernel's plain version made to raise: exit 0, "24
     towers corrected", the 776-byte header kept, every BLHA rewritten within
     10 m (haversine) of its generated tower, segscan launched by compress;
     (b) voxel_downsample and voxel_downsample_chunked on a 131,072-row tile
     on the GPU vs the CPU: identical rows, order, keys and counts,
     centroids within the f32 summation bound; (c) ``reproject`` of (a)'s
     tile: the device deltas within 2e-8 deg of the host f64 inverse;
 10. registration and tile streaming: (a) ``correct --icp --save`` through
     ``__main__.main`` on 9 (a)'s files with no plain version allowed: 24
     refined pairs inside their boxes, the card within 1 mm of the CPU, the
     saved GIM reopens, one nearest-sweep kernel launch a sweep and none of
     the ten; (b) config 4's batched_icp (50 x 2,048, 20 iterations): the
     planted motions recovered, the card vs the CPU, host syncs an
     iteration; the nearest-sweep kernel (csrc/nearest.cu) at config 4's
     and icp50.correct's shapes: bit-equal to its plain version, one
     icp.nearest_kernel count a call, device ms beside its bound; (c)
     ``register``: 24 transforms, the ICP's peak memory within its bound;
     (d) stream_extract over 50 LAS tiles of 1,048,576 points with config
     5's parameters: 24 towers a tile, 1,200 after the cross-tile dedup,
     the native reader; the device bytes a point of one fused and one
     modular 4M step against the governor's constant; (e) the card vs the
     CPU on streamed chunks (both wires, fast and modular) and on config
     4's gim_scenario;
 11. the sharded step (parallel/sharded.py, modular with grid, fast and
     exact) through parallel.launch.run_ranks on a 4,194,304-point corridor
     sorted by x into four slabs with towers on the slab edges: 4 ranks
     sharing the card over gloo against 1 rank over NCCL (the same towers,
     centroids within 1 cm, exact-mode box centres too), every rank's merged
     dict rank 0's, planted towers found, no overflow, each rank's halo
     selections as the corridor gives them; 4 ranks on the CPU against the
     card at 4 x 32,768 rows; halo rows, member counts of 4 ranks and 1,
     collective calls a step (the tracer's collective.* counters); rank
     0's kernel calls of each mode go to phase 3;
 12. the viewers, the elevation report and the library functions on 9
     (a)'s files, no plain version allowed in the commands: (a) ``render
     --towers`` (24 boxes, a 1280 x 960 PNG read back with zlib, box-colour
     pixels; render_scene on the card pixel-identical to the CPU); (b)
     ``export-scene`` to .ply (500,000 + 24 x 24 vertices, 288 edges) and
     .laz (xyz to the LAS scale, RGB x 257); (c) ``viz-export`` (24 boxes,
     each the card's towers' geometry); (d) ``elevation-report`` with a
     save_gtx grid of a known plane (24 rows within 1e-4 m of h - N) and
     with the empirical N; (e) random_downsample to 2,000,000 rows and
     RANSAC (card == CPU on the same bits and triples; on the 4M tile
     ground removed, towers kept, peak bytes), and the segment rows on 8 m
     cell keys against segscan's plain version;
  3. runs each kernel and its plain PyTorch version on the same device
     tensors at the shapes the paths give it, requires agreement (integer
     outputs, pop, counts and extremes identical; OBB sums within the f32
     summation bound), profiles one call of the kernel (device_ms: the
     summed device time of what that call ran, with the names of its
     kernels) and one of its library call where there is one
     (library_device_ms), and computes each kernel's bound (the larger of
     its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s,
     counted from this run's inputs: for the pair kernels 9 operations for
     each pair within eps that the function needs, counted by the plain
     version's walk, beside the all-pairs count). Phase 3 also profiles one
     exact graph run (device ms by kernel), runs cluster_converge at the
     fast path's own call, the bench configuration's 4,096-row cell table,
     and winsort at W 2,048, 4,096 (the largest window one block sorts) and
     32,768 (chunked passes through a scratch buffer) besides W 256;
     segscan also at the fast path's own calls (the pre-cut bench run's
     and the sort-mode tile's cell populations, the centroid-voxel sums of
     four float32 columns, within the summation bound and bit-equal over
     two calls), and a check that a segscan or compact_indices call
     launches one kernel; and the modular path's calls of phase 8
     (cluster_converge on dbscan's cell-sorted rows, and the same rows in
     input order give the same result permuted, and on the grid table;
     segscan and compactrows at grid_dbscan's calls, segscan also with the
     cut rows as one segment, which gives the same outputs), segscan at
     compress's call of phase 9 (a) (f32 [N, 4], reverse), every kernel
     call of rank 0's sharded step in each mode (phase 11), and the
     segscan calls of phase 12 (e)'s segment rows.

Launch counts (the tracer's counters, utils/trace.py) are read just before
and just after each path's run (1, 4, 5, each mode of 7, 8 (a)-(c), 9 (a),
10 (a), a fast and a modular tile of 10 (d), in rank 0 one sharded step of
each mode of 11, and each command of 12 (a)-(c) and the segment rows of
12 (e)).  The only times it reads are device times by kernel (phase 3 and
10 (b)): what the paths cost end to end is the benchmark's to measure
(portbench/, BENCHMARK.json).  Prints the card's name and power limit, one
JSON line of per-kernel results, and as its last line {"ok": true,
"device": {...}}.  Any failure raises: the exit code is non-zero and the
last line is not printed.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

N_POINTS = 4 * 1024 * 1024
SEED = 7
TOWER_TOL_M = 2.0
N_SMALL = 196_608  # phase 8 (a): below auto_grid_threshold, so extract() runs dbscan
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# phase 10: config 4's ICP batch, the register bound, config 5's tiles
ICP_BATCH, ICP_POINTS, ICP_ITERS = 50, 2048, 20
ICP_CPU_TOWERS = 4  # (b) holds the card against the CPU on this many towers
SWEEP_PROFILE_CALLS = 5  # (b): nearest-sweep calls in one profile
# (a): the towers whose boxes adopted vegetation, whose refined centres the
# JAX refinement also leaves beyond TOWER_TOL_M of the member centroid on
# the same member clouds (tests/test_torch_registration.py::
# test_refine_widened_boxes_match_jax; scripts/torch_icp_widened_fixture.py)
ICP_WIDENED = (2, 10)
# (c): the bound of the plain sweep's tiles (a d2 tile holds at most 2**25
# float32 elements, 128 MiB; at most four tensors of its size alive at once,
# 512 MiB, and half that again for the clouds and the caching allocator's
# rounding); the card's sweep (csrc/nearest.cu) builds no tile, so its peak
# is the batch and Kabsch's [B, N, 3, 3] products, far below
REGISTER_PEAK_BOUND = 768 << 20
STREAM_TILES, STREAM_TILE_N, STREAM_SHIFT_M = 50, 1 << 20, 4500.0

# name -> (source, TPU kernel it replaces, its counter in utils/trace.py)
KERNELS = {
    "compactrows": ("compactrows.cu", "pointcloudhookup_tpu/ops/pallas/compactrows.py:320",
                    "kernel.compact_rows_multi"),
    "segscan": ("segscan.cu", "pointcloudhookup_tpu/ops/pallas/segscan.py:104",
                "kernel.segmented_scan"),
    "neighbor": ("neighbor.cu", "pointcloudhookup_tpu/ops/pallas/neighbor.py:133",
                 "kernel.neighbor_reduce"),
    "cluster_converge": ("cluster_converge.cu",
                         "pointcloudhookup_tpu/ops/pallas/cluster_converge.py:259",
                         "kernel.cluster_cells"),
    "obb_accum": ("obb_accum.cu", "pointcloudhookup_tpu/ops/pallas/obb_accum.py:301",
                  "kernel.obb_accumulate_xyz"),
    "obb_accumulate": ("obb_accum.cu", "pointcloudhookup_tpu/ops/pallas/obb_accum.py:168",
                       "kernel.obb_accumulate"),
    "compact_indices": ("compactidx.cu", "pointcloudhookup_tpu/ops/pallas/compactidx.py:122",
                        "kernel.compact_indices"),
    "dupwin": ("dupwin.cu", "pointcloudhookup_tpu/ops/pallas/dupwin.py:70",
               "kernel.first_occurrence_flags"),
    "winsort": ("winsort.cu", "pointcloudhookup_tpu/ops/pallas/winsort.py:169",
                "kernel.window_sort_w"),
    "mergesort": ("mergesort.cu", "pointcloudhookup_tpu/ops/pallas/mergesort.py:284",
                  "kernel.merge_sort_2key"),
}


def wrapper_modules():
    """The modules of ops/kernels that hold the KERNELS' wrappers."""
    return sorted({importlib.import_module(f"pointcloudhookup_tpu_torch.ops.kernels.{src[:-3]}")
                   for src, _, _ in KERNELS.values()}, key=lambda m: m.__name__)


EXACT_PATH = ("compactrows", "segscan", "neighbor", "cluster_converge", "obb_accum")
FAST_PATH = ("compactrows", "segscan", "cluster_converge", "obb_accumulate")
BENCH_PATH = FAST_PATH + ("compact_indices",)
# phase 7: the bench configuration without the pre-cut packs its cell table
# with compact_indices; each sort mode adds its own kernel
SORT_PATH = ("segscan", "cluster_converge", "obb_accumulate", "compact_indices")
# the modular step on a tile above auto_grid_threshold: grid_dbscan
MODULAR_GRID_PATH = ("compactrows", "segscan", "cluster_converge")
SORT_KERNEL = {"cell": "dupwin", "cell_untight": "dupwin", "hier": "winsort",
               "merge": "mergesort"}


def corridor_tile(n: int, seed: int):
    """bench.py's build_workload tile in world coordinates (f64)."""
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

    rng = np.random.default_rng(seed)
    n_towers = 24
    xs = np.linspace(-1800, 1800, n_towers)
    ys = 80.0 * np.sin(xs / 500.0)
    pts, centers = synthetic_corridor(
        rng,
        n_ground=int(n * 0.80),
        n_veg=int(n * 0.12),
        towers=tuple(zip(xs, ys)),
        pts_per_tower=max((n - int(n * 0.92)) // n_towers, 1),
        extent=2000.0,
        n_line=0,
    )
    return pts[:n], centers


def padded(pts, cap: int):
    """Centred float32 rows padded to cap, and their mask."""
    xyz = np.zeros((cap, 3), np.float32)
    xyz[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    return xyz, np.arange(cap) < len(pts)


def max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def flat(out):
    """The tensors of a kernel's result (nested tuples), in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [x for o in out for x in flat(o)]


def require_equal(name, got, ref):
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype or not torch.equal(g, r):
            raise AssertionError(
                f"{name}: kernel disagrees with its plain version "
                f"(max |diff| {max_abs(g, r)})"
            )


def profile_iteration(fn, top: int = 15):
    """One call of fn under torch.profiler, after one unprofiled call: the
    device ms it ran (device-side kernels and copies, summed), the top
    device ms by kernel name and the launches by name; device_ms is None
    when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: an aten op's row repeats its kernels' time
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = {e.key: e.self_device_time_total for e in device}
    device_ms = sum(device_us.values()) / 1e3
    ranked = sorted(device_us.items(), key=lambda kv: -kv[1])[:top]
    if device_ms == 0.0:
        return dict(device_ms=None, top=[], counts={})
    return dict(device_ms=device_ms, top=[(k, v / 1e3) for k, v in ranked],
                counts={e.key: e.count for e in device})


def nearest_xy(centers, xy) -> float:
    """The largest distance (xy) from a generated tower to the nearest of
    the given positions."""
    dist = np.linalg.norm(centers[:, None, :2] - np.asarray(xy)[None, :, :2], axis=2)
    return float(dist.min(axis=1).max())


def modular_tile(n: int, seed: int):
    """A corridor tile of exactly n points below auto_grid_threshold, with
    the bench tile's 24 towers and shares (80 % ground, 12 % vegetation),
    in world coordinates (f64)."""
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

    xs = np.linspace(-1800, 1800, 24)
    n_veg, per_tower = int(n * 0.12), int(n * 0.08) // 24
    pts, centers = synthetic_corridor(
        np.random.default_rng(seed), n_ground=n - n_veg - 24 * per_tower, n_veg=n_veg,
        towers=tuple(zip(xs, 80.0 * np.sin(xs / 500.0))), pts_per_tower=per_tower,
        extent=2000.0, n_line=0,
    )
    assert len(pts) == n
    return pts, centers


@contextlib.contextmanager
def recording(module, attr, calls):
    """Append the (args, kwargs) of every call of module.attr made while the
    block runs to calls; the calls go through."""
    fn = getattr(module, attr)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, attr, record)
    try:
        yield calls
    finally:
        setattr(module, attr, fn)


@contextlib.contextmanager
def kernel_calls(calls):
    """Append (wrapper name, args, kwargs) for every call of the wrappers of
    compactrows, segscan, neighbor, cluster_converge, obb_accum (raw
    coordinates) and obb_accumulate made while the block runs, under every
    name a module of the port binds them to (``from ... import`` makes
    copies of the binding); the calls go through.  A wrapper that calls
    another records both."""
    # the modules that bind them, imported first: a later import would bind
    # the unwrapped functions
    from pointcloudhookup_tpu_torch.core import streaming  # noqa: F401
    from pointcloudhookup_tpu_torch.models import pipeline, towers  # noqa: F401
    from pointcloudhookup_tpu_torch.ops import (  # noqa: F401
        cluster, cluster_grid, frontend_exact, frontend_fused, obb, segments, voxel,
    )
    from pointcloudhookup_tpu_torch.ops.kernels import (
        cluster_converge, compactrows, neighbor, obb_accum, segscan,
    )
    from pointcloudhookup_tpu_torch.parallel import sharded  # noqa: F401
    wrappers = {fn: name for name, fn in (
        ("compactrows", compactrows.compact_rows_multi),
        ("segscan", segscan.segmented_scan),
        ("neighbor", neighbor.neighbor_reduce),
        ("cluster_converge", cluster_converge.cluster_cells),
        ("obb_accum", obb_accum.obb_accumulate_xyz),
        ("obb_accumulate", obb_accum.obb_accumulate),
    )}

    def record(fn, name):
        def call(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return call

    saved = []
    for mod in [m for k, m in sys.modules.items()
                if k.startswith("pointcloudhookup_tpu_torch") and m is not None]:
        for attr, fn in list(vars(mod).items()):
            name = next((n for w, n in wrappers.items() if fn is w), None)
            if name is not None:
                saved.append((mod, attr, fn))
                setattr(mod, attr, record(fn, name))
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def no_plain_versions(modules):
    """Every ``*_plain`` function of the given kernel modules raises while
    the block runs: on the card no path may run a kernel's plain version."""
    saved = []

    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"{name} ran on a path on the card")
        return fn

    for mod in modules:
        for name in dir(mod):
            if name.endswith("_plain") and callable(getattr(mod, name)):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, refuse(f"{mod.__name__}.{name}"))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def fma_check(dev, n: int = 1 << 22):
    """ops/morton.py::fma_f32 on the card (torch.addcmul, float32) against
    its float64 form on the CPU, bit for bit: 2**22 random triples of
    spread magnitudes, products nearly cancelled by their sum (where a
    twice-rounded a * b + c differs almost everywhere), and the [K, P, 1] x
    [K, 1, A] + [K, P, A] broadcast of the OBB projections."""
    from pointcloudhookup_tpu_torch.ops.morton import fma_f32

    rng = np.random.default_rng(5)
    f32 = np.float32

    def spread(shape):
        return (rng.standard_normal(shape) * 2.0 ** rng.integers(-20, 20, shape)).astype(f32)

    x, y = spread(n), spread(n)
    triples = {
        "spread": (x, y, spread(n)),
        "cancelled": (x, y, -(x.astype(np.float64) * y).astype(f32)),
        "broadcast": (spread((64, 512, 1)), rng.random((64, 1, 17)).astype(f32),
                      spread((64, 512, 17))),
    }
    out = {}
    for label, abc in triples.items():
        ref = fma_f32(*(torch.from_numpy(v) for v in abc))
        got = fma_f32(*(torch.from_numpy(v).to(dev) for v in abc)).cpu()
        twice = int((torch.from_numpy(abc[0] * abc[1] + abc[2]) != ref).sum())
        out[label] = (int((got != ref).sum()), twice)
    print(f"fma_f32 on the card vs its float64 form on the CPU: (mismatches, and those "
          f"of a twice-rounded a * b + c) {out}")
    if any(bad for bad, _ in out.values()):
        raise AssertionError(f"fma_f32 on the card is not one rounding: {out}")


def modular_phase(dev, pts, centers, reset_counts, read_counts,
                  n_small: int = N_SMALL, n_chunked: int = 100_000):
    """Phase 8: the modular extraction path (extract_step) through its user
    entry points, with no kernel's plain version allowed in (a)-(c):

      (a) extract() of a LAS file holding an n_small-point corridor tile,
          default parameters: auto routes it to dbscan; every generated
          tower found, its member centroid within TOWER_TOL_M (xy);
      (b) extract_from_points_resolving(fast=False) on the big tile with
          max_clusters halved from 128 until the top tile saturates: the
          top tile takes the exact path, its quadrants (below
          auto_grid_threshold) dbscan; every tower found, resolved;
      (c) the big tile with ClusterParams(method="grid") at a capacity
          1,024 above its size (no exact plan): grid_dbscan with the
          density-floor retry; towers found, the settled floor and
          cells_overflow printed;
      (d) entry()'s batch and an n_chunked-row per-chunk tile on ``dev``
          and through the plain versions on the CPU: labels, keep, counts
          and accepted identical, accepted centres within 1 mm.

    Returns (results, launches by run, the kernel calls (a) and (c) made,
    for phase 3)."""
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu_torch.entry import entry
    from pointcloudhookup_tpu_torch.io.las import make_las, write_las
    from pointcloudhookup_tpu_torch.models import overflow, pipeline
    from pointcloudhookup_tpu_torch.ops import cluster, cluster_grid, segments
    from pointcloudhookup_tpu_torch.ops.kernels import (
        cluster_converge, compactrows, neighbor, obb_accum, segscan,
    )

    def require_towers(label, towers, tol=TOWER_TOL_M):
        got = [t.centroid for t in towers]
        worst = nearest_xy(centers_for[label], got) if got else float("inf")
        print(f"{label}: {len(towers)} towers, worst generated-tower distance to the "
              f"nearest member centroid {worst:.3f} m (xy)")
        if len(towers) != len(centers_for[label]) or worst > tol:
            raise AssertionError(f"{label}: {len(towers)} of {len(centers_for[label])} "
                                 f"towers, worst centroid distance {worst:.2f} m")

    kernels = (cluster_converge, compactrows, neighbor, obb_accum, segscan)
    results, launches = {}, {}
    calls = {"dbscan": [], "grid_scans": [], "grid_pack": [], "grid_cells": []}
    small_pts, small_centers = modular_tile(n_small, SEED)
    centers_for = {"(a) extract()": small_centers, "(b) resolver, fast=False": centers}

    # ---- (a) extract() below auto_grid_threshold: dbscan
    params = ExtractParams()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        las_path = os.path.join(tmp, "corridor_small.las")
        write_las(make_las(small_pts), las_path)
        logs = []
        with no_plain_versions(kernels):
            reset_counts()
            with recording(cluster, "cluster_cells", calls["dbscan"]):
                towers = pipeline.extract(las_path, device=dev, log_callback=logs.append)
            launches["modular_dbscan"] = read_counts(("cluster_converge",), "(a) extract()")
    route = next(line for line in logs if "path:" in line)
    print(f"(a) extract() of {n_small} points: {route}")
    if not route.startswith("modular path") or len(calls["dbscan"]) != 1:
        raise AssertionError(f"(a) did not run dbscan once: {route}")
    require_towers("(a) extract()", towers)
    results["a"] = dict(points=n_small, towers=len(towers), route=route)

    # ---- (b) the fast=False resolver on a saturated big tile
    max_clusters = 128
    while True:
        p_b = dataclasses.replace(params, max_clusters=max_clusters)
        _, top, _ = pipeline.extract_from_points(pts, p_b, device=dev)
        if overflow.saturated(top, p_b) or max_clusters <= 2:
            break
        max_clusters //= 2
    print(f"(b) max_clusters {max_clusters}: the top tile saturates "
          f"({int(top['alive'].sum())} clusters alive)")
    modular_runs = []
    with no_plain_versions(kernels):
        reset_counts()
        with recording(pipeline, "_extract_stats_modular", modular_runs):
            towers_b, info = overflow.extract_from_points_resolving(pts, p_b, fast=False,
                                                                    device=dev)
        launches["modular_resolver"] = read_counts(EXACT_PATH, "(b) resolver, fast=False")
    sizes = [int(args[1].sum()) for args, _ in modular_runs]
    print(f"(b) resolver, fast=False: {info}; {len(modular_runs)} tiles of {sizes} points on "
          f"the modular path (the others above auto_grid_threshold take the exact path)")
    require_towers("(b) resolver, fast=False", towers_b)
    if not info["resolved"] or not info["saturated_tiles"] or not modular_runs:
        raise AssertionError(f"(b) resolver: {info}, {len(modular_runs)} modular tiles")
    results["b"] = dict(max_clusters=max_clusters, info=info, modular_tiles=sizes,
                        towers=len(towers_b))

    # ---- (c) grid_dbscan on the big tile at a capacity with no exact plan
    p_c = ExtractParams(cluster=ClusterParams(method="grid"))
    cap_c = -(-len(pts) // 1024) * 1024 + 1024
    with no_plain_versions(kernels):
        reset_counts()
        with recording(cluster_grid, "cluster_cells", calls["grid_cells"]), \
                recording(cluster_grid, "compact_rows_multi", calls["grid_pack"]), \
                recording(segments.segscan, "segmented_scan", calls["grid_scans"]):
            towers_c, stats_c, _ = pipeline.extract_from_points(pts, p_c, capacity=cap_c,
                                                                device=dev)
        launches["modular_grid"] = read_counts(("compactrows", "segscan", "cluster_converge"),
                                               "(c) grid")
    mod = stats_c["modular"]
    if not calls["grid_cells"]:
        raise AssertionError("(c) did not run grid_dbscan")
    cents = np.array([t.centroid for t in towers_c]).reshape(-1, 3)
    found = int((np.linalg.norm(centers[:, None, :2] - cents[None, :, :2], axis=2)
                 .min(axis=1, initial=np.inf) <= TOWER_TOL_M).sum())
    print(f"(c) grid, capacity {cap_c}: grid_dbscan, density floor {mod['floor']}, "
          f"cells_overflow {mod['cells_overflow']}; towers {len(towers_c)} accepted, {found} "
          f"within {TOWER_TOL_M} m of a generated one, {len(centers)} generated")
    results["c"] = dict(capacity=cap_c, floor=mod["floor"],
                        cells_overflow=mod["cells_overflow"], towers=len(towers_c),
                        towers_near=found, towers_expected=len(centers))

    # ---- (d) on dev vs the plain versions on the CPU
    def same(label, got, ref):
        for key in ("labels", "ground_keep", "count", "accepted"):
            if not np.array_equal(np.asarray(got[key]), np.asarray(ref[key])):
                raise AssertionError(f"(d) {label}: {dev} and CPU differ in {key}")
        acc = np.asarray(ref["accepted"])
        d = np.abs(np.asarray(got["center"])[acc] - np.asarray(ref["center"])[acc])
        err = float(d.max()) if d.size else 0.0
        if err > 1e-3:
            raise AssertionError(f"(d) {label}: tower centres differ by {err} m")
        print(f"(d) {label}: {dev} == CPU plain versions ({int(acc.sum())} towers, centres "
              f"within {err} m)")

    fn, (x, m) = entry(dev)
    same("entry() batch", {k: v.cpu() for k, v in fn(x, m).items()}, fn(x.cpu(), m.cpu()))
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

    pts_d, _ = synthetic_corridor(
        np.random.default_rng(11), n_ground=int(n_chunked * 0.8),
        n_veg=int(n_chunked * 0.12), pts_per_tower=(n_chunked - int(n_chunked * 0.92)) // 3,
        extent=300.0,
    )
    p_d = ExtractParams(cluster=ClusterParams(per_chunk=True))
    _, s_dev, _ = pipeline.extract_from_points(pts_d, p_d, device=dev)
    _, s_cpu, _ = pipeline.extract_from_points(pts_d, p_d, device="cpu")
    same(f"{s_cpu['labels'].shape[0]}-row per-chunk tile", s_dev, s_cpu)
    return results, launches, calls


@contextlib.contextmanager
def counter_rises(module, attr, counter, rises):
    """Append the rise of the counter ``counter`` (utils/trace.py) over each
    call of module.attr made while the block runs to rises; the calls go
    through."""
    from pointcloudhookup_tpu_torch.utils import trace

    fn = getattr(module, attr)

    def call(*args, **kwargs):
        before = trace.counter(counter)
        out = fn(*args, **kwargs)
        rises.append(trace.counter(counter) - before)
        return out

    setattr(module, attr, call)
    try:
        yield rises
    finally:
        setattr(module, attr, fn)


def voxel_parity(label, xyz, mask, voxel_size, chunk_size, dev):
    """voxel_downsample (chunk_size None) or voxel_downsample_chunked on dev
    and through the plain segmented scan on the CPU: identical output rows,
    sort order, voxel keys and per-voxel counts, and centroids within the
    f32 summation bound (a voxel's c rows added in another order differ by
    at most c 2**-23 sum|x|, each row at most |centroid| + voxel_size, plus
    one rounding of the division on each side).  Returns the worst
    centroid difference (m)."""
    from pointcloudhookup_tpu_torch.ops import voxel

    def run(device):
        x = torch.from_numpy(xyz).to(device)
        m = torch.from_numpy(mask).to(device)
        masked = torch.where(m[:, None], x, 3.0e38)
        if chunk_size is None:
            out = voxel.voxel_downsample(x, m, voxel_size)
            mn, chunk = masked.amin(dim=0), None
        else:
            out = voxel.voxel_downsample_chunked(x, m, voxel_size, chunk_size=chunk_size)
            mn = masked.view(-1, chunk_size, 3).amin(dim=1).repeat_interleave(chunk_size, 0)
            chunk = torch.arange(len(mask), device=device) // chunk_size
        order, keys = voxel.voxel_order(x, m, mn, voxel_size, chunk)
        return [v.cpu().numpy() for v in (*out, order, *keys)]

    got, ref = run(dev), run("cpu")
    for name, g, r in zip(("mask", "order") + ("chunk",) * (chunk_size is not None)
                          + ("kx", "ky", "kz"), [got[1], *got[2:]], [ref[1], *ref[2:]]):
        if not np.array_equal(g, r):
            raise AssertionError(f"{label}: {dev} and CPU differ in {name}")
    keys = ref[3:]
    start = np.arange(len(mask)) == 0
    for k in keys:
        start[1:] |= k[1:] != k[:-1]
    seg = np.cumsum(start) - 1
    pos = np.flatnonzero(ref[1])
    counts = np.bincount(seg[mask[ref[2]]], minlength=int(seg[-1]) + 1)[seg[pos]]
    if not start[pos].all() or counts.sum() != int(mask.sum()):
        raise AssertionError(f"{label}: output rows are not the voxels' first rows")
    cg, cr = got[0][pos].astype(np.float64), ref[0][pos].astype(np.float64)
    bound = (counts[:, None] * 2.0**-23 + 2.0**-22) * (np.abs(cr) + voxel_size)
    diff = np.abs(cg - cr)
    if (diff > bound).any():
        raise AssertionError(f"{label}: a centroid beyond the f32 summation bound")
    err = float(diff.max()) if diff.size else 0.0
    print(f"(b) {label}: {dev} == CPU in mask, order, keys and counts ({len(pos)} voxels of "
          f"{int(mask.sum())} rows, up to {int(counts.max())} rows a voxel); centroids within "
          f"{err} m (bound held)")
    return err


def gim_files(tmp, pts, centers):
    """Phase 9 (a)'s inputs in tmp: the tile as a LAS at tm_forward(113.5,
    28.2) (z + 80 m, scale 0.01) and a synthetic GIM of its towers (h = z -
    25, r = 5; the GIM's 杆塔高 is the synthetic default).  Returns (LAS
    path, GIM path, world points, GIM tower dicts, tower lon, tower lat)."""
    from pointcloudhookup_tpu_torch.io.las import make_las, write_las
    from pointcloudhookup_tpu_torch.io.synthetic import build_synthetic_gim
    from pointcloudhookup_tpu_torch.ops.geo import tm_forward, tm_inverse

    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2))
    shift = np.array([e0, n0, 80.0])
    world, towers_w = pts + shift, centers + shift
    glon, glat = tm_inverse(towers_w[:, 0], towers_w[:, 1])
    las_path = os.path.join(tmp, "tile.las")
    write_las(make_las(world, scales=[0.01, 0.01, 0.01]), las_path)
    gts = [dict(id=f"P{i}", lat=float(glat[i]), lng=float(glon[i]),
                h=float(towers_w[i, 2]) - 25.0, r=5.0) for i in range(len(towers_w))]
    gim_path = os.path.join(tmp, "model.gim")
    build_synthetic_gim(gim_path, gts, workdir=os.path.join(tmp, "tree"))
    return las_path, gim_path, world, gts, glon, glat


def gim_phase(dev, pts, centers, reset_counts, read_counts, kernel_modules):
    """Phase 9: the GIM workflow on the card.

      (a) ``python -m pointcloudhookup_tpu_torch run-all`` through
          ``__main__.main`` with ``--device cuda`` and every kernel's plain
          version made to raise: the bench tile as a LAS at tm_forward(113.5,
          28.2) (z + 80 m, scale 0.01), a synthetic GIM of its 24 towers
          (h = z - 25); exit 0, "24 towers corrected", the 776-byte header
          kept, 24 re-parsed towers, every BLHA changed and each within 10 m
          (haversine) of its generated tower; segscan launched by compress;
      (b) voxel_downsample and voxel_downsample_chunked (chunk 32,768) on a
          131,072-row tile on the card and on the CPU (voxel_parity);
      (c) ``reproject`` of (a)'s LAS through ``__main__.main``: the f32
          deltas on the card within 2e-8 deg of the host f64 inverse, the
          written LAS within that plus half its 1e-7 deg scale.

    Returns (results, launches of (a), compress's segscan call args)."""
    import io

    from pointcloudhookup_tpu_torch.__main__ import main as cli
    from pointcloudhookup_tpu_torch.io.las import read_las
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
    from pointcloudhookup_tpu_torch.models import pipeline
    from pointcloudhookup_tpu_torch.ops.geo import haversine_m, local_cgcs2000_to_wgs84, tm_inverse
    from pointcloudhookup_tpu_torch.ops.kernels import segscan

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gim_") as tmp:
        las_path, gim_path, world, gts, glon, glat = gim_files(tmp, pts, centers)

        # ---- (a) run-all on the card, no plain version allowed
        out_gim = os.path.join(tmp, "corrected.gim")
        argv = ["run-all", las_path, gim_path, out_gim, "--device", str(dev),
                "--output-folder", os.path.join(tmp, "og"), "--csv", os.path.join(tmp, "r.csv")]
        compress_launches, scans, buf = [], [], io.StringIO()
        with no_plain_versions(kernel_modules), \
                counter_rises(pipeline, "compress", KERNELS["segscan"][2], compress_launches), \
                recording(segscan, "segmented_scan", scans), contextlib.redirect_stdout(buf):
            reset_counts()
            try:
                cli(argv)
                code = None
            except SystemExit as e:
                code = e.code
        launches = read_counts(EXACT_PATH, "(a) run-all")
        out = buf.getvalue()
        for line in out.splitlines():
            print(f"  run-all | {line}")
        print(f"(a) run-all: exit {code}; segscan launches in compress {compress_launches[0]}")
        if code != 0 or f"{len(gts)} towers corrected" not in out:
            raise AssertionError(f"(a) run-all: exit {code}, not '{len(gts)} towers corrected'")
        if compress_launches[0] < 1:
            raise AssertionError("(a) compress did not launch segscan")
        compress_scan = next(a for a, _ in scans if a[0].dim() == 2 and a[0].shape[1] == 4)
        with open(gim_path, "rb") as f, open(out_gim, "rb") as g:
            if g.read(776) != f.read(776):
                raise AssertionError("(a) the saved GIM lost the original 776-byte header")
        before, _, _ = pipeline.import_gim(gim_path, os.path.join(tmp, "reparse_a"))
        after, _, _ = pipeline.import_gim(out_gim, os.path.join(tmp, "reparse_b"))
        b = {r.name: (r.lat, r.lng, r.h) for r in before}
        a = {r.name: (r.lat, r.lng, r.h) for r in after}
        changed = sum(a[k] != b[k] for k in a)
        dist = np.array([float(haversine_m(a[f"P{i}"][0], a[f"P{i}"][1], glat[i], glon[i]))
                         for i in range(len(gts))]) if set(a) == set(b) else np.array([np.inf])
        print(f"(a) re-parsed {len(after)} towers, {changed} BLHA lines changed; corrected "
              f"positions from the generated towers (haversine): worst {dist.max():.3f} m, "
              f"median {np.median(dist):.3f} m")
        if len(after) != len(gts) or changed != len(gts) or dist.max() > 10.0:
            raise AssertionError(f"(a) {len(after)} towers, {changed} changed, worst "
                                 f"{dist.max():.2f} m")
        results["a"] = dict(points=len(world), exit=code,
                            compress_segscan_launches=compress_launches[0],
                            towers=len(after), changed=changed, worst_m=float(dist.max()))

        # ---- (c) reproject (a)'s tile: the CLI, then its device deltas
        deg_path = os.path.join(tmp, "deg.las")
        with contextlib.redirect_stdout(io.StringIO()):
            cli(["reproject", las_path, deg_path, "--device", str(dev)])
        src = read_las(las_path).xyz()
        lon, lat = tm_inverse(src[:, 0], src[:, 1])
        e_0, n_0 = float(src[:, 0].mean()), float(src[:, 1].mean())
        lt = local_cgcs2000_to_wgs84(e_0, n_0)
        d_err = 0.0
        for s in range(0, len(src), 1 << 20):
            sl = slice(s, s + (1 << 20))
            dlon, dlat = lt.eval_delta(
                torch.from_numpy((src[sl, 0] - e_0).astype(np.float32)).to(dev),
                torch.from_numpy((src[sl, 1] - n_0).astype(np.float32)).to(dev))
            d_err = max(d_err,
                        float(np.abs(lt.u0 + dlon.cpu().numpy().astype(np.float64) - lon[sl]).max()),
                        float(np.abs(lt.v0 + dlat.cpu().numpy().astype(np.float64) - lat[sl]).max()))
        deg = read_las(deg_path).xyz()
        las_err = float(max(np.abs(deg[:, 0] - lon).max(), np.abs(deg[:, 1] - lat).max()))
        print(f"(c) reproject of {len(src)} points: device deltas within {d_err:.3g} deg of "
              f"the f64 inverse (bound 2e-8), the written LAS within {las_err:.3g} deg "
              f"(bound 7e-8)")
        if d_err > 2e-8 or las_err > 5e-8 + 2e-8:
            raise AssertionError(f"(c) reproject: {d_err} / {las_err} deg")
        results["c"] = dict(points=len(src), max_err_deg=d_err, las_err_deg=las_err)

    # ---- (b) compress on the card vs the CPU, 131,072 rows, both variants
    n_b = 131_072
    xs = np.linspace(-400, 400, 6)
    pts_b, _ = synthetic_corridor(
        np.random.default_rng(9), n_ground=int(n_b * 0.8), n_veg=int(n_b * 0.12),
        towers=tuple(zip(xs, 30.0 * np.sin(xs / 200.0))),
        pts_per_tower=(n_b - int(n_b * 0.92)) // 6, extent=450.0,
    )
    xyz_b, mask_b = padded(pts_b[:n_b], n_b)
    results["b"] = {}
    for vs in (0.1, 0.5):
        for chunk in (None, 32_768):
            label = (f"voxel {vs}, " + ("global" if chunk is None else f"chunks of {chunk}")
                     + f", {n_b} rows")
            results["b"][label] = voxel_parity(label, xyz_b, mask_b, vs, chunk, dev)
    return results, launches, compress_scan


def syncs_in(fn) -> int:
    """Host syncs fn makes, counted by torch.cuda.set_sync_debug_mode."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def config4_batch():
    """benchmarks/config4_icp.py's batch: 50 lattice-tower clouds of 2,048
    points (seed 0), each moved by a planted rotation about z (|angle| <=
    0.15) and translation (|t| <= 1 m).  Returns (src, mask, dst, R, t)."""
    rng = np.random.default_rng(0)
    b, n = ICP_BATCH, ICP_POINTS
    t_param = rng.uniform(0, 1, (b, n))
    half = 6.0 * (1 - 0.7 * t_param)
    src = np.stack([rng.uniform(-1, 1, (b, n)) * half, rng.uniform(-1, 1, (b, n)) * half,
                    t_param * 35.0], axis=-1).astype(np.float32)
    angles = rng.uniform(-0.15, 0.15, b)
    ts = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    rots = np.zeros((b, 3, 3), np.float32)
    dst = np.empty_like(src)
    for i in range(b):
        c, s = np.cos(angles[i]), np.sin(angles[i])
        rots[i] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        dst[i] = src[i] @ rots[i].T + ts[i]
    return src, np.ones((b, n), bool), dst, rots, ts


def config4_sweep(src, mask, dst):
    """(a) config 4's batch as one sweep's inputs: the frame rows moved by
    a small rotation about z and a shift (seed 1)."""
    rng = np.random.default_rng(1)
    ang = rng.uniform(-0.05, 0.05, len(src))
    r = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
                  for a in ang]).astype(np.float32)
    return src, mask, dst, mask, r, rng.uniform(-0.3, 0.3, (len(src), 3)).astype(np.float32)


def icp50_sweep():
    """One sweep of the icp50.correct cell's shape: 50 tower frames of 280
    rows (models/refine.py::tower_frame_template, 30-45 m high, 8-14 m
    wide) against lattice-tower member clouds of 12,000-14,000 rows padded
    to 14,000 with prefix masks, a small rotation and shift (seed 2)."""
    from pointcloudhookup_tpu_torch.models.refine import tower_frame_template

    rng = np.random.default_rng(2)
    b, m = ICP_BATCH, 14_000
    src = np.stack([tower_frame_template(rng.uniform(30, 45), rng.uniform(8, 14))
                    for _ in range(b)])
    t_param = rng.uniform(0, 1, (b, m))
    half = 6.0 * (1 - 0.7 * t_param)
    dst = np.stack([rng.uniform(-1, 1, (b, m)) * half, rng.uniform(-1, 1, (b, m)) * half,
                    t_param * 35.0 - 17.5], axis=-1).astype(np.float32)
    dm = np.arange(m)[None, :] < rng.integers(12_000, m + 1, (b, 1))
    ang = rng.uniform(-0.05, 0.05, b)
    r = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
                  for a in ang]).astype(np.float32)
    return (src, np.ones(src.shape[:2], bool), dst, dm, r,
            rng.uniform(-0.3, 0.3, (b, 3)).astype(np.float32))


def nearest_sweep_case(label, arrays, dev):
    """nearest_moved (csrc/nearest.cu) against nearest_moved_plain on the
    card: index, d^2 and matched rows bit for bit, one icp.nearest_kernel
    count a call, the device ms a call over SWEEP_PROFILE_CALLS profiled
    calls (None where the profiler recorded no sweep kernel), and the bound
    as portbench/metrics/icp_roofline.py counts it (6 float32 operations a
    valid frame row x valid destination row; the rows read once, index and
    d^2 written once)."""
    from pointcloudhookup_tpu_torch.ops.kernels import nearest
    from pointcloudhookup_tpu_torch.utils import trace

    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    before = trace.counter("icp.nearest_kernel")
    got = nearest.nearest_moved(*args)
    ref = nearest.nearest_moved_plain(*args)
    for name, g, r in zip(("idx", "d2", "matched"), got, ref):
        if g.dtype.is_floating_point:
            g, r = g.view(torch.int32), r.view(torch.int32)
        if not torch.equal(g, r):
            raise AssertionError(f"(b) nearest sweep {label}: {name} differs from the plain "
                                 f"version in {int((g != r).sum())} places")
    calls = SWEEP_PROFILE_CALLS
    prof_k = profile_iteration(lambda: [nearest.nearest_moved(*args) for _ in range(calls)], top=4)
    launched = trace.counter("icp.nearest_kernel") - before
    seen = any("sweep_kernel" in k for k, _ in prof_k["top"])
    dev_k = prof_k["device_ms"] / calls if seen else None
    n_valid = arrays[1].sum(axis=1).astype(np.float64)
    m_valid = arrays[3].sum(axis=1).astype(np.float64)
    ops = 6.0 * float((n_valid * m_valid).sum())
    nbytes = 12.0 * float(n_valid.sum() + m_valid.sum()) + 8.0 * float(n_valid.sum())
    bound_ms = max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    b, n, m = arrays[0].shape[0], arrays[0].shape[1], arrays[2].shape[1]
    print(f"(b) nearest sweep {label} [{b}, {n}, {m}] (valid pairs {ops / 6:.4g}): kernel "
          f"{dev_k} ms (device), bound {bound_ms:.4f} ms (operations), {launched} launches "
          f"for {1 + 2 * calls} calls; bit-equal; kernel device ms by kernel over {calls} "
          "calls: " + ", ".join(f"{k[:40]} {v:.4f}" for k, v in prof_k["top"]))
    if launched != 1 + 2 * calls:
        raise AssertionError(f"(b) nearest sweep {label}: {launched} launches")
    return dict(shape=[b, n, m], pairs=ops / 6, kernel_device_ms=dev_k, bound_ms=bound_ms,
                launches=launched)


def gim_scenario(tmp):
    """benchmarks/config4_icp.py::gim_scenario on the port: three towers
    with a one-sided conductor stub each (seed 11), and a GIM of the
    planted towers with 杆塔高 35.  Returns (points, centres, GIM path)."""
    from pointcloudhookup_tpu_torch.io.synthetic import build_synthetic_gim, synthetic_corridor
    from pointcloudhookup_tpu_torch.ops.geo import tm_forward, tm_inverse

    rng = np.random.default_rng(11)
    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2))
    pts, centers = synthetic_corridor(
        rng, n_ground=4000, n_veg=800, pts_per_tower=500,
        towers=((0.0, 0.0), (160.0, 60.0), (-170.0, -80.0)), tower_height=35.0,
        extent=300.0, origin=(e0, n0, 80.0))
    stubs = []
    for c in centers:
        s = rng.uniform(0, 1, 120)
        stubs.append(np.column_stack([c[0] + 1.0 + s * 7.0, c[1] + rng.normal(0, 0.2, 120),
                                      c[2] + 35.0 / 2 - 2.0 - 3.0 * s]))
    gts = []
    for i, c in enumerate(centers):
        lon, lat = (float(v) for v in tm_inverse(c[0], c[1]))
        gts.append(dict(id=f"P{41 + i}", lat=lat, lng=lon, h=float(c[2]) - 25.0, r=0.0,
                        props={"杆塔编号": f"P{41 + i}", "杆塔高": "35.0", "呼高": "24",
                               "Kv值": "220", "转角": "0.0"}))
    gim = os.path.join(tmp, "truth.gim")
    build_synthetic_gim(gim, gts, workdir=os.path.join(tmp, "tree"))
    return np.vstack([pts] + stubs), centers, gim


def registration_streaming_phase(dev, pts, centers, reset_counts, read_counts, counts_now,
                                 kernel_modules):
    """Phase 10: registration and tile streaming on the card.

      (a) ``correct --icp --save`` through ``__main__.main`` on phase 9's
          4M LAS and GIM, no kernel's plain version allowed: 24 pairs, each
          with an ICP rmse, every refined centre within TOWER_TOL_M (xy) of
          its member centroid but those of ICP_WIDENED, which stay inside
          their boxes (within half the smaller width), the card within 1 mm
          of the CPU
          on ICP_CPU_TOWERS pairs and the farthest one, the saved GIM
          reopens, every sweep one launch of the nearest-sweep kernel
          (icp.nearest_kernel equals icp.sweeps) and none of the ten
          kernels;
      (b) batched_icp at config 4's shape (50 towers, 2,048 points, 20
          iterations): R within 0.05 and t within 0.2 m of the planted
          motions, R within 1e-4 and t within 1e-3 m of the CPU's on the
          first ICP_CPU_TOWERS towers; host syncs per ICP iteration;
          nearest_moved at that shape and at icp50.correct's (50 frames of
          280 rows, member clouds of 12,000-14,000 rows): index, d^2 and
          matched rows bit-equal to nearest_moved_plain, one launch a call,
          the kernel's device ms and bound;
      (c) ``register`` on the 4M tile: 24 transforms printed, the ICP's
          peak allocated device memory within REGISTER_PEAK_BOUND;
      (d) stream_extract with config 5's parameters (method grid, 8,192
          cells, density floor 3), fast, u16 wire, capacity 1,048,576,
          prefetch 1, over STREAM_TILES LAS tiles of STREAM_TILE_N points
          (bench corridors, seed t, centred, x + t * 4,500 m, scale 0.001),
          the towers merged as ``stream-extract`` merges them: 24 towers a
          tile, 1,200 after the cross-tile dedup, each generated tower
          within TOWER_TOL_M (xy) of a member centroid, the native reader;
          the launches of one fast and one modular tile, and their kernel
          calls (for phase 3); the governor's capacity; the device bytes a
          point of capacity of one fused and one modular step on the 4M
          tile;
      (e) the card against the CPU: a 131,072-row corridor streamed in
          32,768-row chunks on both wires (staged coordinates bit-equal),
          fast and modular (the same towers, centres within 1 mm), and
          correct(icp=True) on config 4's gim_scenario (the same pairs,
          refined centres within 1 mm).

    Returns (results, launches of the stream-extract tiles, their kernel
    calls by tile)."""
    import io

    from pointcloudhookup_tpu_torch.__main__ import main as cli
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams
    from pointcloudhookup_tpu_torch.core import governor, streaming
    from pointcloudhookup_tpu_torch.io.las import make_las, write_las
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
    from pointcloudhookup_tpu_torch.models import pipeline, refine
    from pointcloudhookup_tpu_torch.models.towers import extract_step, towers_from_stats
    from pointcloudhookup_tpu_torch.ops import registration
    from pointcloudhookup_tpu_torch.ops.frontend_fused import fused_extract_step
    from pointcloudhookup_tpu_torch.ops.kernels import nearest
    from pointcloudhookup_tpu_torch.utils import trace
    from pointcloudhookup_tpu_torch.utils.validate import quality_dedup

    results, launches, stream_calls = {}, {}, {}
    params = ExtractParams()

    def run_cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv)
        return buf.getvalue()

    @contextlib.contextmanager
    def capturing(module, attr, calls, before=None, **extra):
        """Record (args, kwargs, result) of every module.attr call, passing
        extra keyword arguments through; before() runs ahead of each."""
        fn = getattr(module, attr)

        def call(*args, **kwargs):
            if before is not None:
                before()
            out = fn(*args, **kwargs, **extra)
            calls.append((args, kwargs, out))
            return out

        setattr(module, attr, call)
        try:
            yield calls
        finally:
            setattr(module, attr, fn)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_icp_") as tmp:
        las_path, gim_path, _, gts, _, _ = gim_files(tmp, pts, centers)

        # ---- (a) correct --icp on the card, no plain version allowed
        out_gim = os.path.join(tmp, "icp.gim")
        refined, icp_counts = [], []

        def count_before():
            icp_counts.append(counts_now())
            sweeps.append((trace.counter("icp.sweeps"), trace.counter("icp.nearest_kernel")))

        sweeps = []
        with no_plain_versions(kernel_modules + [nearest]), \
                capturing(refine, "refine_tower_centers", refined, before=count_before):
            reset_counts()
            out = run_cli(["correct", gim_path, las_path, "--icp", "--save", out_gim,
                           "--device", str(dev), "--output-folder", os.path.join(tmp, "oa")])
            icp_counts.append(counts_now())
            sweeps.append((trace.counter("icp.sweeps"), trace.counter("icp.nearest_kernel")))
        read_counts(EXACT_PATH, "(a) correct --icp")
        icp_launches = {k: icp_counts[1][k] - icp_counts[0][k] for k in icp_counts[0]}
        icp_sweeps, nearest_launches = (b - a for a, b in zip(*sweeps))
        args, kwargs, ref_out = refined[0]
        towers_a, clouds, pair_idx = args[0], args[1], args[2]
        off = {pi: float(np.linalg.norm(r["center"][:2] - clouds[pi].mean(axis=0)[:2]))
               for pi, r in ref_out.items()}
        far = {pi: (round(d, 3), round(float(towers_a[pi].extent[1]), 1))
               for pi, d in off.items() if d > TOWER_TOL_M}
        shift_xy = max(off.values())
        # the card against the CPU on the first ICP_CPU_TOWERS pairs and the
        # farthest one (the template is 280 points for every pair, so the
        # padding, and each pair's result, is that of the whole batch)
        sub = sorted(set(pair_idx[:ICP_CPU_TOWERS]) | {max(off, key=off.get)})
        cpu_out = refine.refine_tower_centers(towers_a, clouds, sub,
                                              **dict(kwargs, device="cpu"))
        vs_cpu = max(float(np.abs(cpu_out[pi]["center"] - ref_out[pi]["center"]).max())
                     for pi in sub)
        inside = set(far) <= set(ICP_WIDENED) and all(
            off[pi] <= towers_a[pi].extent[1] / 2 for pi in far)
        rmse_lines = [ln for ln in out.splitlines() if "icp rmse" in ln]
        reopened, _, _ = pipeline.import_gim(out_gim, os.path.join(tmp, "ra"))
        print(f"(a) correct --icp: {len(ref_out)} towers refined, {len(rmse_lines)} rmse "
              f"lines, refined centres from the member centroid (xy): worst {shift_xy:.3f} m, "
              f"{len(off) - len(far)} within {TOWER_TOL_M} m, beyond it (m, box width ey) "
              f"{far}, only towers of {ICP_WIDENED} and within ey / 2: {inside}; card vs CPU "
              f"on pairs {sub}: centres within {vs_cpu:.3g} m; {icp_sweeps} sweeps, "
              f"{nearest_launches} nearest-sweep kernel launches, launches of the ten in the "
              f"ICP {icp_launches}; saved GIM reopens with {len(reopened)} towers")
        if (f"{len(gts)} pairs matched" not in out or len(rmse_lines) != len(gts)
                or len(ref_out) != len(gts) or not inside or vs_cpu > 1e-3
                or len(reopened) != len(gts) or "saved" not in out.splitlines()
                or any(icp_launches.values()) or not 0 < icp_sweeps == nearest_launches):
            raise AssertionError(f"(a) correct --icp: {len(rmse_lines)} rmse lines, "
                                 f"{len(ref_out)} refined, worst {shift_xy:.2f} m, inside "
                                 f"{inside}, vs CPU {vs_cpu}, {len(reopened)} reopened, "
                                 f"launches {icp_launches}, {icp_sweeps} sweeps, "
                                 f"{nearest_launches} nearest launches")
        results["a"] = dict(refined=len(ref_out), worst_centroid_m=shift_xy, beyond_tol=far,
                            vs_cpu_m=vs_cpu, icp_launches=icp_launches, icp_sweeps=icp_sweeps,
                            nearest_launches=nearest_launches,
                            template_points=int(len(refine.tower_frame_template(30.0, 10.0))),
                            cloud_points_max=int(max(len(clouds[pi]) for pi in pair_idx)))

        # ---- (c) register on the card: the ICP's peak device memory
        peaks = []

        def reset_peak():
            torch.cuda.synchronize(dev)
            peaks.append(torch.cuda.memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)

        regs = []
        with capturing(registration, "register_tower_pairs", regs, before=reset_peak):
            out = run_cli(["register", gim_path, las_path, "--device", str(dev),
                           "--output-folder", os.path.join(tmp, "oc")])
        peak = torch.cuda.max_memory_allocated(dev) - peaks[0]
        lines = [ln for ln in out.splitlines() if ln.startswith("GIM[")]
        pc, gc = regs[0][0][0], regs[0][0][1]
        untiled = len(pc) * max(map(len, pc)) * max(map(len, gc)) * 4
        print(f"(c) register: {len(lines)} transforms; batch {len(pc)} x "
              f"{max(map(len, pc))} x {max(map(len, gc))}: peak allocated in the ICP "
              f"{peak / 2**20:.1f} MiB (bound {REGISTER_PEAK_BOUND / 2**20:.0f} MiB; an untiled "
              f"d2 alone {untiled / 2**30:.2f} GiB); first: {lines[0] if lines else None}")
        if len(lines) != len(gts) or peak > REGISTER_PEAK_BOUND:
            raise AssertionError(f"(c) register: {len(lines)} transforms, peak {peak} bytes")
        results["c"] = dict(transforms=len(lines), peak_bytes=peak,
                            bound_bytes=REGISTER_PEAK_BOUND, untiled_d2_bytes=untiled,
                            batch=[len(pc), max(map(len, pc)), max(map(len, gc))])

    # ---- (b) config 4's batch: recovery, card vs CPU, syncs
    src, mask, dst, rots, ts = config4_batch()
    args_d = [torch.from_numpy(a).to(dev) for a in (src, mask, dst, mask)]
    out = registration.batched_icp(*args_d, iters=ICP_ITERS)
    r_err = float(np.abs(out["R"].cpu().numpy() - rots).max())
    t_err = float(np.abs(out["t"].cpu().numpy() - ts).max())
    k = ICP_CPU_TOWERS
    ref = registration.batched_icp(*(torch.from_numpy(a[:k]) for a in (src, mask, dst, mask)),
                                   iters=ICP_ITERS)
    r_cpu = max_abs(out["R"][:k].cpu(), ref["R"])
    t_cpu = max_abs(out["t"][:k].cpu(), ref["t"])
    syncs = [syncs_in(lambda i=i: registration.batched_icp(*args_d, iters=i)) for i in (1, 2)]
    print(f"(b) batched_icp {ICP_BATCH} x {ICP_POINTS}, {ICP_ITERS} iterations: from the "
          f"planted motions R {r_err:.2e}, t {t_err:.2e} m (bounds 0.05, 0.2); card vs CPU "
          f"({k} towers) R {r_cpu:.2e}, t {t_cpu:.2e} m (bounds 1e-4, 1e-3); host syncs per "
          f"call at 1 and 2 iterations {syncs} -> {syncs[1] - syncs[0]} a iteration")
    if r_err > 0.05 or t_err > 0.2 or r_cpu > 1e-4 or t_cpu > 1e-3:
        raise AssertionError(f"(b) batched_icp: R {r_err}, t {t_err}, vs CPU {r_cpu}, {t_cpu}")
    results["b"] = dict(r_err=r_err, t_err=t_err, r_vs_cpu=r_cpu, t_vs_cpu=t_cpu,
                        syncs_1_2=syncs, syncs_per_iteration=syncs[1] - syncs[0],
                        nearest={label: nearest_sweep_case(label, arrays, dev)
                                 for label, arrays in (
                                     ("config4", config4_sweep(src, mask, dst)),
                                     ("icp50", icp50_sweep()))})

    # ---- (d) stream_extract at config 5's scale and parameters
    p5 = ExtractParams(cluster=ClusterParams(method="grid", max_cells=8192,
                                             min_cell_points=3))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        paths, all_centers, n_total = [], [], 0
        for t in range(STREAM_TILES):
            p, c = corridor_tile(STREAM_TILE_N, seed=t)
            shift = np.array([t * STREAM_SHIFT_M, 0.0, 0.0]) - p.mean(axis=0)
            paths.append(os.path.join(tmp, f"tile_{t:02d}.las"))
            write_las(make_las(p + shift, scales=[0.001, 0.001, 0.001]), paths[-1])
            all_centers.append(c + shift)
            n_total += len(p)
        all_centers = np.concatenate(all_centers)
        b_gov = governor.budget(device=dev, n_points=STREAM_TILE_N)
        with no_plain_versions(kernel_modules):
            res = streaming.stream_extract(paths, capacity=STREAM_TILE_N, params=p5,
                                           fast=True, wire="u16", prefetch=1, device=dev)
        towers = []
        for st, m in res:
            towers.extend(towers_from_stats(st, np.asarray(m["origin"])))
        kept = quality_dedup(towers, loose_radius=p5.filters.duplicate_threshold)
        worst = nearest_xy(all_centers, [tw.centroid for tw in kept])
        per_tile_towers = sorted({int(st["accepted"].sum()) for st, _ in res})
        readers = sorted({m["reader"] for _, m in res})
        print(f"(d) stream_extract of {STREAM_TILES} tiles, {n_total} points: {len(kept)} "
              f"towers across {len(res)} tiles; towers a tile {per_tile_towers}, worst "
              f"generated tower from a member centroid {worst:.3f} m (xy); reader {readers}; "
              f"governor: capacity {b_gov.capacity:,} ({b_gov.reason})")
        if (len(res) != STREAM_TILES or per_tile_towers != [24]
                or len(kept) != len(all_centers) or worst > TOWER_TOL_M
                or readers != ["native"]):
            raise AssertionError(f"(d) stream_extract: {len(kept)} towers, per tile "
                                 f"{per_tile_towers}, worst {worst:.2f} m, readers {readers}")
        for fast, name, path_kernels in ((True, "stream_fast", FAST_PATH),
                                         (False, "stream_modular", MODULAR_GRID_PATH)):
            with kernel_calls(stream_calls.setdefault(name, [])):
                reset_counts()
                one = streaming.stream_extract(paths[:1], capacity=STREAM_TILE_N, params=p5,
                                               fast=fast, device=dev)
            launches[name] = read_counts(path_kernels, f"(d) one stream_extract tile, "
                                                       f"{'fast' if fast else 'modular'}")
            print(f"(d) one {'fast' if fast else 'modular'} tile: "
                  f"{int(one[0][0]['accepted'].sum())} towers")
        results["d"] = dict(tiles=STREAM_TILES, points=n_total, towers=len(kept),
                            worst_m=worst, readers=readers, governor_capacity=b_gov.capacity,
                            governor_reason=b_gov.reason)

    # device memory a point of capacity: one fused and one modular step, 4M
    xyz_np, mask_np = padded(pts, N_POINTS)
    peaks = {}
    for name, step in (
            ("fast", lambda x, m: fused_extract_step(
                x, m, params, geometric_voxels=True,
                min_cell_points=max(params.cluster.min_cell_points, 1), sort_mode="full",
                precut_div=4)),
            ("modular", lambda x, m: extract_step(x, m, params))):
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step(torch.from_numpy(xyz_np).to(dev), torch.from_numpy(mask_np).to(dev))
        torch.cuda.synchronize(dev)
        peaks[name] = torch.cuda.max_memory_allocated(dev) - base
    per_point = max(peaks.values()) / N_POINTS
    print(f"device memory of one step on {N_POINTS} rows (inputs included): fast "
          f"{peaks['fast'] / 2**20:.1f} MiB, modular {peaks['modular'] / 2**20:.1f} MiB -> "
          f"{per_point:.1f} bytes a point of capacity (governor: "
          f"{governor.DEVICE_BYTES_PER_POINT})")
    if per_point > governor.DEVICE_BYTES_PER_POINT:
        raise AssertionError(f"a step takes {per_point:.1f} bytes a point, above the "
                             f"governor's {governor.DEVICE_BYTES_PER_POINT}")
    results["device_bytes"] = dict(peaks, per_point=per_point,
                                   governor=governor.DEVICE_BYTES_PER_POINT)

    # ---- (e) the card against the CPU on the new paths
    n_e = 131_072
    xs = np.linspace(-400, 400, 6)
    pts_e, _ = synthetic_corridor(
        np.random.default_rng(13), n_ground=int(n_e * 0.8), n_veg=int(n_e * 0.12),
        towers=tuple(zip(xs, 30.0 * np.sin(xs / 200.0))),
        pts_per_tower=(n_e - int(n_e * 0.92)) // 6, extent=450.0)
    pts_e = pts_e[:n_e]
    results["e"] = {}
    for wire in ("u16", "f32"):
        staged = [(x.cpu(), m.cpu()) for x, m, _ in streaming.TileStreamer(
            [pts_e], capacity=32_768, wire=wire, device=dev)]
        staged_c = [(x, m) for x, m, _ in streaming.TileStreamer(
            [pts_e], capacity=32_768, wire=wire, device="cpu")]
        if not all(torch.equal(a, c) and torch.equal(b, d)
                   for (a, b), (c, d) in zip(staged, staged_c)):
            raise AssertionError(f"(e) {wire} wire: staged chunks differ on the card")
        for fast in (True, False):
            kw = dict(capacity=32_768, params=params, wire=wire, fast=fast, fetch_labels=True)
            got = streaming.stream_extract([pts_e], device=dev, **kw)
            ref = streaming.stream_extract([pts_e], device="cpu", **kw)
            found, diff = 0, 0.0
            for (g, _), (r, _) in zip(got, ref):
                for key in ("accepted", "count"):
                    if not np.array_equal(g[key], r[key]):
                        raise AssertionError(f"(e) {wire}, fast={fast}: {key} differs")
                if not np.array_equal(g["labels"], r["labels"]):
                    raise AssertionError(f"(e) {wire}, fast={fast}: labels differ")
                acc = r["accepted"]
                found += int(acc.sum())
                if acc.any():
                    diff = max(diff, float(np.abs(g["center"][acc] - r["center"][acc]).max()))
            label = f"{wire} wire, {'fast' if fast else 'modular'}"
            print(f"(e) {n_e} rows in chunks of 32,768, {label}: card == CPU ({found} towers, "
                  f"centres within {diff:.3g} m; staged chunks bit-equal)")
            if found == 0 or diff > 1e-3:
                raise AssertionError(f"(e) {label}: {found} towers, centres {diff} m apart")
            results["e"][label] = dict(towers=found, center_diff_m=diff)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cfg4_") as tmp:
        pts_s, centers_s, gim_s = gim_scenario(tmp)
        records, _, _ = pipeline.import_gim(gim_s, os.path.join(tmp, "o"))
        sp = ExtractParams(ground=GroundParams(min_points_after=100),
                           cluster=ClusterParams(eps=5.0, min_points=30),
                           max_clusters=32, obb_angles=128)
        res = {}
        for d in (dev, "cpu"):
            tw, st, _ = pipeline.extract_from_points(pts_s, sp, capacity=8192, device=d)
            lab = st["labels"][: len(pts_s)]
            res[str(d)] = pipeline.correct(records, tw, icp=True, device=d,
                                           pc_clouds=[pts_s[lab == x.label] for x in tw])
        g, c = res[str(dev)], res["cpu"]
        diff = max(float(np.abs(np.subtract(g.converted_towers[pi].original_center,
                                            c.converted_towers[pi].original_center)).max())
                   for _, pi in c.pairs) if c.pairs else np.inf
        print(f"(e) gim_scenario correct(icp=True): pairs {g.pairs} on the card, {c.pairs} on "
              f"the CPU; refined centres within {diff:.3g} m")
        if g.pairs != c.pairs or len(c.pairs) != len(centers_s) or diff > 1e-3:
            raise AssertionError(f"(e) gim_scenario: pairs {g.pairs} / {c.pairs}, {diff} m")
        results["e"]["gim_scenario"] = dict(pairs=len(c.pairs), center_diff_m=diff)
    return results, launches, stream_calls


# phase 11: the sharded step (parallel/sharded.py) over torch.distributed
SHARDED_RANKS = 4
SHARDED_SMALL = 32_768  # rows a rank in the card-vs-CPU check
SHARDED_MODES = ("modular", "fast", "exact")
# Group's collectives, as the tracer counts them (collective.<name>)
COLLECTIVES = ("psum", "pmin", "pmax", "all_gather", "ppermute")
# dryrun_multichip's gate, n ranks against one: box centres in exact mode
# (one global cell grid); member centroids in every mode, plus what f32
# summation order may move them.  The modular and fast steps anchor each
# rank's cell grid at its own minimum (the JAX package's design), so a tower
# may adopt other vegetation cells there: their box centres are reported.
# Member counts of 4 ranks and 1 are reported, not gated: the JAX package's
# own 4-device and 1-device runs differ in them in every mode (per-rank
# anchors; ghosts counted twice in fast mode; ghost cells beyond eps from
# the slab unsure of their core state), and the port's 4 ranks hold the
# JAX package's 4 devices on this script's small corridor
# (tests/test_torch_parallel.py::test_phase11_corridor_matches_jax)
SHARDED_CENTRE_TOL_M = 0.01
# the kernels of one rank's step, by mode (grid_dbscan on the modular step;
# compactrows also selects the halo rows)
SHARDED_PATH = {
    "modular": ("compactrows", "segscan", "cluster_converge", "obb_accum"),
    "fast": FAST_PATH,
    "exact": EXACT_PATH,
}


def sharded_corridor(n: int, seed: int):
    """n points in bench.py's shares (80 % ground, 12 % vegetation, 8 % in
    23 towers), 4 km square, sorted by x: the towers stand every 1000/6 m
    in x, so the tower set is symmetric about x = 0 and x = +-1000 m, and
    each x-quantile at 1/4, 1/2 and 3/4 of the rows (the edges of four
    equal slabs) falls inside a tower.  Returns (points f64[n, 3], planted
    centres f64[23, 3])."""
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

    xs = np.arange(-11, 12) * (1000.0 / 6.0)
    pts, centers = synthetic_corridor(
        np.random.default_rng(seed), n_ground=int(n * 0.80), n_veg=int(n * 0.12),
        towers=tuple(zip(xs, 80.0 * np.sin(xs / 500.0))),
        pts_per_tower=(n - int(n * 0.92)) // len(xs) + 1, extent=2000.0, n_line=0,
    )
    pts = pts[:n]
    return pts[np.argsort(pts[:, 0], kind="stable")], centers


def to_host(obj):
    """Tensors (nested in tuples, lists, dicts) as numpy arrays: what a rank
    sends back to the parent (torch's own pickling of CPU tensors would
    share memory with a process that is about to exit)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def to_device(obj, dev):
    """to_host's inverse, onto dev."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj).to(dev)
    if isinstance(obj, dict):
        return {k: to_device(v, dev) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, dev) for v in obj)
    return obj


def sharded_rank(device, runs, params, capture):
    """Phase 11's rank (run by parallel.launch.run_ranks): for each run
    (label -> (xyz, mask, exact cell bits, counted), this rank's shard) and
    each mode, build this rank's step and run it with every kernel's plain
    version made to raise (on a card): a first step whose merged dict is
    returned; where counted, one more step whose collective calls (the
    tracer's collective.* counters) and kernel launches every rank counts,
    whose kernel calls rank 0 records with capture, and whose halo
    selections' rows, [to the right, to the left] (what the rank sends its
    neighbours), every rank returns.  Every rank runs the same steps: the
    collectives pair up."""
    from pointcloudhookup_tpu_torch.parallel import sharded
    from pointcloudhookup_tpu_torch.parallel.sharded import make_sharded_extract, tile_mesh

    from pointcloudhookup_tpu_torch.utils import trace

    group = tile_mesh()
    modules = wrapper_modules()
    on_card = device.type == "cuda"
    counters = {**{n: c for n, (_, _, c) in KERNELS.items()},
                **{n: f"collective.{n}" for n in COLLECTIVES}}

    out = {}
    for label, (xyz_np, mask_np, bits, counted) in runs.items():
        xyz = torch.from_numpy(xyz_np).to(device)
        mask = torch.from_numpy(mask_np).to(device)
        for mode in SHARDED_MODES:
            step = make_sharded_extract(group, params, mode=mode, exact_cell_bits=bits)
            res = {}
            guard = no_plain_versions(modules) if on_card else contextlib.nullcontext()
            with guard:
                _, merged = step(xyz, mask)
                res["merged"] = to_host(merged)
                if counted:
                    before = {n: trace.counter(c) for n, c in counters.items()}
                    calls, halo = [], []
                    with kernel_calls(calls) if capture and group.rank == 0 \
                            else contextlib.nullcontext():
                        # inside kernel_calls, which rebinds the same name
                        with recording(sharded, "compact_rows_multi", halo):
                            step(xyz, mask)
                    rise = {n: trace.counter(c) - before[n] for n, c in counters.items()}
                    res["launches"] = {n: rise[n] for n in KERNELS}
                    res["collective_calls"] = {n: rise[n] for n in COLLECTIVES if rise[n]}
                    # _halo_exchange's compact_rows_multi(sel, bits, halo_cap)
                    res["halo_rows"] = [min(int(args[0].sum()), args[2]) for args, _ in halo]
                    if calls:
                        res["calls"] = to_host(calls)
            out[(label, mode)] = res
    return out


def sharded_phase(dev):
    """Phase 11: the sharded step (``parallel/sharded.py``) in its three
    modes, through ``parallel.launch.run_ranks`` as a user would start it,
    on a 4,194,304-point corridor cut into four slabs along x, towers on
    each slab edge:
      * 4 ranks sharing the card over gloo (collectives staged through the
        host) and 1 rank over NCCL: the
        same accepted towers, member centroids within 1 cm, box centres too
        in exact mode (whose cell grid is anchored at the global minimum;
        the modular and fast steps anchor their grids per rank, as the JAX
        package does, so the vegetation cells a tower adopts may differ:
        their box centres are reported); every rank's merged dict
        bit-identical to rank 0's; every planted tower within TOWER_TOL_M
        (xy) of a member centroid; cells_overflow and halo_overflow 0;
        the halo rows each rank's step selected equal to those derived
        from the corridor; member counts of 4 ranks and 1 and collective
        calls a step by collective reported;
      * 4 ranks on the CPU over gloo at 4 x 32,768 rows against the same
        ranks on the card: the same accepted towers and counts, geometry
        within 1 mm.
    Every kernel call of rank 0's 4-rank step in each mode is returned for
    phase 3; its launches too.  Raises after printing everything if a gate
    failed.  Returns (results, launches by mode, kernel calls by mode)."""
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu_torch.ops.frontend_exact import exact_cell_plan
    from pointcloudhookup_tpu_torch.parallel.launch import run_ranks
    from pointcloudhookup_tpu_torch.parallel.sharded import _halo_capacity

    n_r = SHARDED_RANKS
    # the bench tile's parameters on the grid path, config 5's density floor
    params = ExtractParams(cluster=ClusterParams(method="grid", min_cell_points=3))
    halo_w = 2.0 * params.cluster.eps

    def corridor(n, seed):
        pts, centers = sharded_corridor(n, seed)
        origin = pts.mean(axis=0)
        xyz = (pts - origin).astype(np.float32)
        mask = np.ones(n, bool)
        bits = exact_cell_plan(pts.max(axis=0) - pts.min(axis=0), params.cluster.eps)
        if bits is None:
            raise AssertionError("phase 11: no exact cell plan for the corridor")
        return xyz, mask, bits, centers - origin

    xyz, mask, bits, planted = corridor(N_POINTS, SEED)
    small = corridor(n_r * SHARDED_SMALL, SEED + 1)
    rows, rows_s = N_POINTS // n_r, SHARDED_SMALL

    def shard(c, r, m):
        return c[0][r * m:(r + 1) * m], c[1][r * m:(r + 1) * m]

    # slab edges, the towers cut by them (member rows in two slabs), and
    # the halo rows each rank should send [right, left], derived here in
    # numpy by the step's rule (float32, as the step compares) to check the
    # rows that the step's own selections chose
    edges = [float(xyz[r * rows, 0]) for r in range(1, n_r)]
    cut = 0
    for cx, cy, _ in planted:
        lo, hi = np.searchsorted(xyz[:, 0], [cx - 6.0, cx + 6.0])
        near = (np.abs(xyz[lo:hi, 1] - cy) <= 6.0) & (xyz[lo:hi, 2] > 8.0)
        cut += len(set(((lo + np.nonzero(near)[0]) // rows).tolist())) > 1
    halo_derived = []
    width, cap = np.float32(halo_w), _halo_capacity(rows)
    for r in range(n_r):
        x = xyz[r * rows:(r + 1) * rows, 0]
        right = int((x >= xyz[(r + 1) * rows, 0] - width).sum()) if r + 1 < n_r else 0
        left = int((x <= xyz[r * rows - 1, 0] + width).sum()) if r > 0 else 0
        halo_derived.append([min(right, cap), min(left, cap)])
    print(f"11. corridor {N_POINTS} points, {len(planted)} towers, {n_r} slabs along x "
          f"(edges at x = {', '.join(f'{e:.1f}' for e in edges)} m), towers cut by an edge "
          f"{cut}; exact cell bits {bits}")
    failures = []
    if cut < 3:
        failures.append(f"only {cut} towers have member rows in two slabs")

    four = run_ranks(sharded_rank, [
        ({"big": shard((xyz, mask), r, rows) + (bits, True),
          "small": shard(small, r, rows_s) + (small[2], False)}, params, True)
        for r in range(n_r)], backend="gloo", devices=str(dev))
    one = run_ranks(sharded_rank, [({"big": (xyz, mask, bits, True)}, params, False)],
                    backend="nccl", devices=[str(dev)])[0]
    cpu = run_ranks(sharded_rank, [({"small": shard(small, r, rows_s) + (small[2], False)},
                                    params, False) for r in range(n_r)],
                    backend="gloo", devices="cpu")

    def towers(merged):
        acc = merged["accepted"]
        return merged["center"][acc], merged["centroid"][acc], merged["count"][acc]

    def order_tol(count, centroid):
        """What f32 summation order may move a member centroid: sqrt(3 n) u
        max|x| for n members (u = 2**-24; sqrt(n) u |x| is the recursive sum's
        probabilistic error a run, with margin for two runs)."""
        return np.sqrt(3.0 * count) * 2.0**-24 * np.abs(centroid).max(axis=-1) + 1e-6

    def replicated(per_rank, key, what):
        m0 = per_rank[0][key]["merged"]
        for r in range(1, len(per_rank)):
            for k, v in per_rank[r][key]["merged"].items():
                if v.tobytes() != m0[k].tobytes():
                    failures.append(f"{what}: rank {r}'s {k} differs from rank 0's")
        return m0

    results, launches, calls = {}, {}, {}
    for mode in SHARDED_MODES:
        m4 = replicated(four, ("big", mode), f"{mode}, 4 ranks")
        m1 = one[("big", mode)]["merged"]
        c4, g4, n4 = towers(m4)
        c1, g1, n1 = towers(m1)
        worst_box = worst_cen = worst_cen_tol = 0.0
        count_diff = []  # member counts, 4 ranks - 1 rank, by tower
        if len(c4) != len(c1):
            failures.append(f"{mode}: 4 ranks accepted {len(c4)} towers, 1 rank {len(c1)}")
        else:
            used = set()
            for i in range(len(g4)):
                d = np.linalg.norm(g1 - g4[i][None], axis=1)
                j = int(np.argmin(d))
                if j in used:
                    failures.append(f"{mode}: two 4-rank towers pair with one 1-rank tower")
                used.add(j)
                tol = SHARDED_CENTRE_TOL_M + order_tol(max(n4[i], n1[j]), g4[i])
                if d[j] > tol:
                    failures.append(f"{mode}: a member centroid {d[j]:.4f} m from the 1-rank "
                                    f"one (bound {tol:.4f} m)")
                worst_cen = max(worst_cen, float(d[j]))
                worst_cen_tol = max(worst_cen_tol, float(tol))
                worst_box = max(worst_box, float(np.linalg.norm(c4[i] - c1[j])))
                count_diff.append(int(n4[i]) - int(n1[j]))
        if mode == "exact" and worst_box > SHARDED_CENTRE_TOL_M:
            failures.append(f"exact: a box centre {worst_box:.4f} m from the 1-rank one")
        planted_worst = nearest_xy(planted, g4) if len(g4) else np.inf
        if planted_worst > TOWER_TOL_M:
            failures.append(f"{mode}: a planted tower {planted_worst:.2f} m from a centroid")
        for name, m in (("4 ranks", m4), ("1 rank", m1)):
            for flag in ("cells_overflow", "halo_overflow"):
                if float(m[flag]) != 0.0:
                    failures.append(f"{mode}, {name}: {flag} {float(m[flag])}")
        # the small corridor: the card against the CPU
        s_gpu = replicated(four, ("small", mode), f"{mode}, small, card")
        s_cpu = replicated(cpu, ("small", mode), f"{mode}, small, CPU")
        acc = s_gpu["accepted"]
        geo = dict(box=0.0, centroid=0.0, centroid_bound=0.0)
        if not (np.array_equal(acc, s_cpu["accepted"])
                and np.array_equal(s_gpu["count"], s_cpu["count"])):
            failures.append(f"{mode}: the card and the CPU accept different towers or counts")
        elif acc.any():
            geo["box"] = max(float(np.abs(s_gpu[k][acc] - s_cpu[k][acc]).max())
                             for k in ("center", "extent"))
            d = np.abs(s_gpu["centroid"][acc] - s_cpu["centroid"][acc]).max(axis=1)
            bound = order_tol(s_gpu["count"][acc], s_gpu["centroid"][acc])
            geo.update(centroid=float(d.max()), centroid_bound=float(bound.min()))
            if geo["box"] > 1e-3 or (d > bound).any():
                failures.append(f"{mode}: card and CPU geometry apart: box {geo['box']:.2e} m, "
                                f"centroids {d.max():.2e} m (bounds 1e-3 m, f32 order)")
        r4 = [four[r][("big", mode)] for r in range(n_r)]
        r1 = one[("big", mode)]
        halo_read = [r["halo_rows"] for r in r4]
        if halo_read != halo_derived:
            failures.append(f"{mode}: the ranks' halo selections chose {halo_read} rows, "
                            f"the corridor gives {halo_derived}")
        if r1["halo_rows"]:
            failures.append(f"{mode}: one rank selected halo rows {r1['halo_rows']}")
        launches[f"sharded_{mode}"] = r4[0]["launches"]
        calls[f"sharded_{mode}"] = r4[0].get("calls", [])
        missing = [k for k in SHARDED_PATH[mode] if r4[0]["launches"][k] == 0]
        if missing:
            failures.append(f"{mode}: rank 0's step never launched {missing}")
        results[mode] = dict(
            towers_4=len(c4), towers_1=len(c1), towers_small=int(acc.sum()),
            worst_centroid_m=worst_cen, centroid_bound_m=worst_cen_tol,
            worst_box_centre_m=worst_box, count_diff_4_vs_1=count_diff, halo_rows=halo_read,
            planted_worst_m=planted_worst, small_card_vs_cpu_m=geo,
            collective_calls_4=r4[0]["collective_calls"], collective_calls_1=r1["collective_calls"],
            launches_rank0_4=r4[0]["launches"], base_height=float(m4["base_height"]),
        )
        print(f"11. {mode}: 4 ranks {len(c4)} towers, 1 rank {len(c1)}; worst member centroid "
              f"4 vs 1 {worst_cen:.6f} m (bound up to {worst_cen_tol:.4f} m), box centre "
              f"{worst_box:.6f} m; member counts 4 - 1 by tower: {sum(map(bool, count_diff))} "
              f"differ, by {min(count_diff, default=0)} to {max(count_diff, default=0)}; "
              f"planted worst {planted_worst:.3f} m; small corridor card vs "
              f"CPU {int(acc.sum())} towers, box centre and extent {geo['box']:.2e} m, member "
              f"centroid {geo['centroid']:.2e} m (bound from {geo['centroid_bound']:.2e} m)")
        print(f"11. {mode}: collective calls a step, rank 0 of 4 {r4[0]['collective_calls']} "
              f"({sum(r4[0]['collective_calls'].values())}), 1 rank {r1['collective_calls']} "
              f"({sum(r1['collective_calls'].values())})")
        print(f"11. {mode}: launches of rank 0's step {r4[0]['launches']}; kernel calls "
              f"captured {len(calls[f'sharded_{mode}'])}")
        print(f"11. {mode}: halo rows sent, read from each rank's step [to the right, to the "
              f"left]: {halo_read} (capacity {cap} a side; derived in numpy from the corridor: "
              f"{halo_derived})")
    results["halo_rows_derived"] = halo_derived
    if failures:
        raise AssertionError("phase 11: " + "; ".join(failures))
    return results, launches, calls


# phase 12: the viewers (render, export-scene, viz-export), the elevation
# report and the library functions, on phase 9's files
VIEWER_CAP = 500_000  # the viewers' display cap (the CLI default)
BOX_RGB = (255, 0, 0)  # the kuangxuan wireframe colour, (1, 0, 0) as u8
DOWNSAMPLE_GB = 16  # recommend_chunk_size(16): 2,000,000 rows
RANSAC_CPU_ROWS = 131_072  # (e): the card against the CPU on this many rows
RANSAC_PEAK_BOUND = 1 << 30  # (e): a RANSAC call's peak allocated bytes at 4M rows
# (d): a 0.25 deg grid around (28.2 N, 113.5 E) holding the plane
# N = A + B (lat - 28.2) + C (lon - 113.5), which bilinear interpolation
# reproduces up to the float32 rounding of the grid values
GEOID_PLANE = (-20.0, 1.5, -0.8)


def tile_rows(n: int):
    """(ground rows, vegetation rows, rows a tower) of corridor_tile(n):
    ground first, then vegetation, then each tower's rows in turn."""
    return int(n * 0.80), int(n * 0.12), max((n - int(n * 0.92)) // 24, 1)


@contextlib.contextmanager
def keeping(module, attr, calls):
    """Append (args, kwargs, result) of every call of module.attr made while
    the block runs to calls; the calls go through."""
    fn = getattr(module, attr)

    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, attr, call)
    try:
        yield calls
    finally:
        setattr(module, attr, fn)


def viewer_phase(dev, pts, centers, reset_counts, read_counts, kernel_modules):
    """Phase 12: the viewers, the elevation report and the library functions
    on phase 9's files (the bench tile as a LAS at tm_forward(113.5, 28.2),
    scale 0.01, and the GIM of its 24 towers), every kernel's plain version
    made to raise in (a)-(c):

      (a) ``render tile.las out.png --towers --device cuda`` through
          ``__main__.main``: 24 tower boxes, a 1280 x 960 PNG that
          viz/render.py's own reader decodes, box-colour pixels in it; then
          render_scene on the card against the CPU on the same points,
          subsample and geometries (pixel-identical, and identical to the
          CLI's PNG);
      (b) ``export-scene tile.las scene.ply --towers`` and ``scene.laz``:
          the PLY holds VIEWER_CAP cloud vertices plus 24 x 24 box vertices
          and 288 edges; the .laz read back gives the subsample's xyz (to
          the LAS scale) and the cluster colours x 257;
      (c) ``viz-export``: 24 boxes of 24 points, each holding its tower's
          centre, equal to tower_display_geometries of the towers the CLI's
          extract() returned on the card;
      (d) ``elevation-report model.gim --geoid grid.gtx --csv --text``, the
          grid written by save_gtx (GEOID_PLANE): 24 rows, each within 1e-4
          m of h - N; again with the empirical N;
      (e) on the 4M tile: random_downsample to recommend_chunk_size(16)
          rows (exactly that many kept, the rows numpy's stable argsort of
          the same keys picks; the card and the CPU identical on the same
          bits); ransac_plane, remove_ground_ransac (256 hypotheses) and
          remove_ground_tiled_ransac (grid 8, 64) on RANSAC_CPU_ROWS rows,
          the card and the CPU on the same triples (the same winners,
          normals within 1e-6), and on the 4M rows on the card (ground rows
          removed, each tower's rows at least 95 % kept, peak allocated
          bytes within RANSAC_PEAK_BOUND); segment_{sum,max,min}_rows on the tile's sorted 8 m cell
          keys, the card against the plain versions on the CPU (their
          segscan calls go to phase 3).

    Returns (results, launches by path, kernel calls by path)."""
    import csv
    import io

    from pointcloudhookup_tpu_torch import __main__ as cli_mod
    from pointcloudhookup_tpu_torch.io.geoid import save_gtx
    from pointcloudhookup_tpu_torch.io.las import read_las
    from pointcloudhookup_tpu_torch.models import pipeline
    from pointcloudhookup_tpu_torch.native import get_laz_lib
    from pointcloudhookup_tpu_torch.ops import ground, sample, segments
    from pointcloudhookup_tpu_torch.ops.geo import GeoidGrid
    from pointcloudhookup_tpu_torch.ops.kernels import segscan
    from pointcloudhookup_tpu_torch.viz import boxes, export, render

    results, launches, calls = {}, {}, {}

    def run_cli(argv, what=None):
        """One command through __main__.main, no plain version allowed:
        (stdout, launches or None)."""
        buf = io.StringIO()
        with no_plain_versions(kernel_modules), contextlib.redirect_stdout(buf):
            reset_counts()
            cli_mod.main(argv)
        counts = read_counts(EXACT_PATH, what) if what else None
        return buf.getvalue(), counts

    with tempfile.TemporaryDirectory(prefix="chip_smoke_viewers_") as tmp:
        las_path, gim_path, _, gts, _, _ = gim_files(tmp, pts, centers)
        world = read_las(las_path).xyz()  # the points the commands read
        n_towers = len(gts)

        # ---- (a) render --towers on the card
        png = os.path.join(tmp, "scene.png")
        geo = []
        with keeping(boxes, "tower_display_geometries", geo):
            out, launches["viewer_render"] = run_cli(
                ["render", las_path, png, "--towers", "--device", str(dev)], "(a) render")
        img = render.read_png(png)
        box_px = int((img == BOX_RGB).all(axis=2).sum())
        print(f"(a) render: {out.strip().splitlines()[0]}; PNG {img.shape}, {box_px} box-colour "
              f"pixels")
        if f"{n_towers} tower boxes" not in out or img.shape != (960, 1280, 3) or box_px == 0:
            raise AssertionError(f"(a) render: {out!r}, image {img.shape}, {box_px} box pixels")
        geoms = geo[-1][2]
        img_g = render.render_scene(world, geoms, device=dev)
        img_c = render.render_scene(world, geoms, device="cpu")
        differ = int((img_g != img_c).any(axis=2).sum())
        print(f"(a) render_scene ({VIEWER_CAP} of {len(world)} points, {len(geoms)} boxes): "
              f"{dev} vs CPU {differ} pixels differ, CLI image "
              f"{'identical' if np.array_equal(img, img_g) else 'DIFFERENT'}")
        if differ or not np.array_equal(img, img_g):
            raise AssertionError(f"(a) render_scene: {differ} pixels differ from the CPU's")
        results["a"] = dict(box_pixels=box_px, pixels_differ=differ)

        # ---- (b) export-scene: a PLY with the wireframes, a LAZ of the cloud
        if get_laz_lib() is None:
            raise AssertionError("(b) the native LAZ codec did not build")
        ply, laz = os.path.join(tmp, "scene.ply"), os.path.join(tmp, "scene.laz")
        scene = []
        with keeping(cli_mod, "_towers_and_labels", scene):
            _, launches["viewer_export_ply"] = run_cli(
                ["export-scene", las_path, ply, "--towers", "--device", str(dev)],
                "(b) export-scene .ply")
            _, launches["viewer_export_laz"] = run_cli(
                ["export-scene", las_path, laz, "--towers", "--device", str(dev)],
                "(b) export-scene .laz")
        xyz_s, _, edges_s = export.read_ply_scene(ply)
        idx = boxes.subsample_indices(len(world), VIEWER_CAP, 0)
        towers_l, labels_l = scene[-1][2]
        cols = export.colors_from_labels(labels_l, [t.label for t in towers_l])[idx]
        back = read_las(laz)
        xyz_err = float(np.abs(back.xyz() - world[idx]).max())
        rgb_ok = all(np.array_equal(back.points[c], cols[:, k].astype(np.uint16) * 257)
                     for k, c in enumerate(("red", "green", "blue")))
        print(f"(b) export-scene: .ply {len(xyz_s)} vertices, {len(edges_s)} edges; .laz "
              f"{len(back)} points, xyz within {xyz_err:.3g} m of the subsample at scale "
              f"{back.scales.tolist()}, RGB {'x257 as coloured' if rgb_ok else 'WRONG'}")
        if (len(xyz_s) != VIEWER_CAP + 24 * n_towers or len(edges_s) != 12 * n_towers
                or len(back) != VIEWER_CAP or xyz_err > back.scales.max() / 2 + 1e-6
                or not rgb_ok):
            raise AssertionError(f"(b) export-scene: {len(xyz_s)} vertices, {len(edges_s)} "
                                 f"edges; laz {len(back)} points, {xyz_err} m, rgb {rgb_ok}")
        results["b"] = dict(vertices=len(xyz_s), edges=len(edges_s), laz_xyz_err_m=xyz_err)

        # ---- (c) viz-export
        js = os.path.join(tmp, "boxes.json")
        ext = []
        with keeping(pipeline, "extract", ext):
            out_c, launches["viewer_viz_export"] = run_cli(
                ["viz-export", las_path, js, "--device", str(dev)], "(c) viz-export")
        with open(js) as f:
            payload = json.load(f)
        towers_c = ext[-1][2]
        expect = json.loads(json.dumps([dict(points=np.asarray(p).tolist(), color=list(c))
                                        for p, c in boxes.tower_display_geometries(towers_c)]))
        held = [bool((np.min(b["points"], 0) <= t.center).all()
                     and (t.center <= np.max(b["points"], 0)).all())
                for b, t in zip(payload, towers_c)]
        print(f"(c) viz-export: {len(payload)} boxes of "
              f"{sorted({len(b['points']) for b in payload})} points, each holding its tower's "
              f"centre: {all(held)}, equal to the card's towers' geometries: {payload == expect}")
        if (len(payload) != n_towers or any(len(b["points"]) != 24 for b in payload)
                or not all(held) or payload != expect):
            raise AssertionError("(c) viz-export: the boxes are not the towers'")
        results["c"] = dict(boxes=len(payload))

        # ---- (d) elevation-report with a grid and with the empirical N
        a, b, c = GEOID_PLANE
        lat_g, lon_g = np.meshgrid(26.2 + 0.25 * np.arange(17), 111.5 + 0.25 * np.arange(17),
                                   indexing="ij")
        gtx = os.path.join(tmp, "grid.gtx")
        save_gtx(GeoidGrid(26.2, 111.5, 0.25, 0.25, (a + b * (lat_g - 28.2)
                                                     + c * (lon_g - 113.5)).astype(np.float32)),
                 gtx)
        worst = {}
        for label, extra in (("grid", ["--geoid", gtx]), ("empirical", [])):
            csv_path = os.path.join(tmp, f"{label}.csv")
            out_d, _ = run_cli(["elevation-report", gim_path, "--csv", csv_path, "--text",
                                      os.path.join(tmp, f"{label}.txt"), "--output-folder",
                                      os.path.join(tmp, f"og_{label}")] + extra)
            with open(csv_path, encoding="utf-8") as f:
                rows = list(csv.DictReader(f))
            n_exp = [a + b * (float(r["lat"]) - 28.2) + c * (float(r["lon"]) - 113.5)
                     if label == "grid" else 28.0 for r in rows]
            err = max(abs(float(r["h_orthometric"]) - (float(r["h_ellipsoid"]) - n))
                      for r, n in zip(rows, n_exp))
            h_err = max(abs(float(r["h_ellipsoid"]) - t["h"]) for r, t in zip(rows, gts))
            worst[label] = err
            print(f"(d) elevation-report, {label} N: {len(rows)} rows, "
                  f"h_orthometric within {err:.3g} m of h - N (bound 1e-4), h within "
                  f"{h_err:.3g} m of the GIM's; {out_d.strip().splitlines()[-1]}")
            if len(rows) != n_towers or err > 1e-4:
                raise AssertionError(f"(d) elevation-report ({label}): {len(rows)} rows, {err} m")
        results["d"] = dict(worst_m=worst)

    # ---- (e) the library functions on the 4M tile
    n_ground, n_veg, per_tower = tile_rows(N_POINTS)
    xyz_np, mask_np = padded(pts, N_POINTS)
    xyz_g, mask_g = torch.from_numpy(xyz_np).to(dev), torch.from_numpy(mask_np).to(dev)
    xyz_c, mask_c = torch.from_numpy(xyz_np), torch.from_numpy(mask_np)
    max_points = sample.recommend_chunk_size(DOWNSAMPLE_GB)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bits = sample.random_bits(N_POINTS, gen, device=dev)
    out_g, keep_g = sample.random_downsample_from_bits(xyz_g, mask_g, bits, max_points)
    out_c, keep_c = sample.random_downsample_from_bits(xyz_c, mask_c, bits.cpu(), max_points)
    bits_np = bits.cpu().numpy()
    order = np.argsort(np.where(mask_np, bits_np >> 1, 0xFFFFFFFF), kind="stable")[:max_points]
    same = torch.equal(out_g.cpu(), out_c) and torch.equal(keep_g.cpu(), keep_c)
    rows_ok = (int(keep_c.sum()) == max_points and bool(mask_np[order].all())
               and np.array_equal(out_c[:max_points].numpy(), xyz_np[order]))
    print(f"(e) random_downsample to {max_points} of {int(mask_np.sum())} rows: {dev} == "
          f"CPU on the same bits: {same}; exactly {int(keep_c.sum())} kept, the stable "
          f"argsort's rows: {rows_ok}")
    if not same or not rows_ok:
        raise AssertionError("(e) random_downsample: card != CPU or wrong rows")
    results["e"] = dict(downsample=dict(rows=max_points))

    # RANSAC: the card against the CPU on the same triples
    pick = np.sort(np.random.default_rng(SEED).choice(len(pts), RANSAC_CPU_ROWS, replace=False))
    sub_c, sub_m = xyz_c[pick], mask_c[pick]
    sub_g, sub_mg = sub_c.to(dev), sub_m.to(dev)
    cpu_gen = torch.Generator().manual_seed(SEED)
    ransac = {}
    for name, thresh in (("ransac_plane", 0.3), ("remove_ground_ransac", 0.5)):
        idx = ground.draw_triples(sub_m, 256, cpu_gen)
        pg = ground._best_plane(sub_g, sub_mg, idx.to(dev), thresh)
        pc = ground._best_plane(sub_c, sub_m, idx, thresh)
        ransac[name] = dict(best=(int(pg[3]), int(pc[3])),
                            normal_diff=float((pg[0].cpu() - pc[0]).abs().max()),
                            score_diff=int((pg[4].cpu() - pc[4]).abs().max()),
                            inliers_differ=int((pg[2].cpu() != pc[2]).sum()))
    tidx = ground.draw_tile_triples(sub_c, sub_m, 8, 64, cpu_gen)
    tg = ground.tile_planes(sub_g, sub_mg, tidx.to(dev), 0.5, 8)
    tc = ground.tile_planes(sub_c, sub_m, tidx, 0.5, 8)
    keep_tg = ground.remove_ground_tiled_ransac_from_indices(sub_g, sub_mg, tidx.to(dev), 0.5, 8)
    keep_tc = ground.remove_ground_tiled_ransac_from_indices(sub_c, sub_m, tidx, 0.5, 8)
    ransac["remove_ground_tiled_ransac"] = dict(
        best_differ=int((tg[3].cpu() != tc[3]).sum()),
        normal_diff=float((tg[1].cpu() - tc[1]).abs().max()),
        keep_differ=int((keep_tg.cpu() != keep_tc).sum()))
    print(f"(e) RANSAC on {RANSAC_CPU_ROWS} rows, {dev} vs CPU on the same triples: {ransac}")
    if (any(r["best"][0] != r["best"][1] or r["normal_diff"] > 1e-6
            for k, r in ransac.items() if "best" in r)
            or ransac["remove_ground_tiled_ransac"]["best_differ"]
            or ransac["remove_ground_tiled_ransac"]["normal_diff"] > 1e-6):
        raise AssertionError(f"(e) RANSAC: the card picks other planes than the CPU: {ransac}")

    # RANSAC on the whole tile, on the card
    towers_at = n_ground + n_veg + per_tower * np.arange(len(centers))
    for name, fn in (("remove_ground_ransac",
                      lambda: ground.remove_ground_ransac(xyz_g, mask_g, gen, 0.5, 256)[0]),
                     ("remove_ground_tiled_ransac",
                      lambda: ground.remove_ground_tiled_ransac(xyz_g, mask_g, gen, grid=8,
                                                                num_hypotheses=64))):
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        keep = fn()
        peak = torch.cuda.max_memory_allocated(dev) - base
        keep = keep.cpu().numpy()
        removed = 1.0 - float(keep[:n_ground].mean())
        tower_kept = [float(keep[s:s + per_tower].mean()) for s in towers_at]
        ransac[name + "_4M"] = dict(ground_removed=removed, tower_kept_min=min(tower_kept),
                                    peak_bytes=peak)
        print(f"(e) {name} on {N_POINTS} rows: ground rows removed {100 * removed:.2f} %, "
              f"each tower's rows kept at least {100 * min(tower_kept):.2f} %, peak allocated "
              f"{peak / 2**20:.1f} MiB")
        if removed < 0.5 or min(tower_kept) < 0.95 or peak > RANSAC_PEAK_BOUND:
            raise AssertionError(f"(e) {name}: {removed} of the ground removed, a tower "
                                 f"{min(tower_kept)} kept, peak {peak} bytes")
    results["e"]["ransac"] = ransac

    # segment rows on the tile's sorted 8 m cell keys: the card vs the plain
    # versions (their segscan calls go to phase 3)
    cell = np.floor(xyz_np[:, :2] / 8.0).astype(np.int64)
    key = (cell[:, 0] - cell[:, 0].min()) * (1 << 20) + (cell[:, 1] - cell[:, 1].min())
    order = np.argsort(np.where(mask_np, key, key.max() + 1), kind="stable")
    keys_g = torch.from_numpy(key[order]).to(dev)
    vals_g = torch.from_numpy(xyz_np[order]).to(dev)

    def seg_rows(k, v):
        start = segments.boundary_flags(k)
        _, nxt = segments.segment_spans(start)
        return (segments.segment_sum_rows(v, start, nxt), segments.segment_max_rows(v, start),
                segments.segment_min_rows(v, start))

    calls["viewer_segments"] = []
    with no_plain_versions(kernel_modules), kernel_calls(calls["viewer_segments"]):
        reset_counts()
        got = seg_rows(keys_g, vals_g)
        launches["viewer_segments"] = read_counts(("segscan",), "(e) segment rows")
    # the same functions on the same card tensors through segscan's plain
    # version, and the summation bound from plain scans
    kernel = segscan.segmented_scan
    segscan.segmented_scan = segscan.segmented_scan_plain
    try:
        ref = seg_rows(keys_g, vals_g)
        start_p = segments.boundary_flags(keys_g)
        first, nxt_p = segments.segment_spans(start_p)
        k_rows = (nxt_p - first).double()[:, None]
        mag = segments.segment_sum_rows(vals_g.abs(), start_p, nxt_p).double()
    finally:
        segscan.segmented_scan = kernel
    d_sum = (got[0].double() - ref[0].double()).abs()
    seg_ok = (bool((d_sum <= k_rows * 2.0 ** -23 * mag).all())
              and torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]))
    print(f"(e) segment_sum/max/min_rows over {N_POINTS} rows in {int(start_p.sum())} cells: "
          f"{dev} vs the plain versions: max and min identical, sums within "
          f"{float(d_sum.max()):.3g} (bound k 2**-23 sum|v|): {seg_ok}; segscan launches "
          f"{launches['viewer_segments']['segscan']}")
    if not seg_ok:
        raise AssertionError("(e) segment rows: the card differs from the plain versions")
    results["e"]["segments"] = dict(cells=int(start_p.sum()), sum_err=float(d_sum.max()))
    return results, launches, calls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu_torch.core.batch import round_up
    from pointcloudhookup_tpu_torch.io.las import make_las, read_las, write_las
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
    from pointcloudhookup_tpu_torch.models import overflow, pipeline
    from pointcloudhookup_tpu_torch.models.towers import filter_and_dedup
    from pointcloudhookup_tpu_torch.ops import frontend_exact, frontend_fused
    from pointcloudhookup_tpu_torch.ops.kernels import (
        build,
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
    from pointcloudhookup_tpu_torch.ops.morton import fma_f32, morton_decode
    from pointcloudhookup_tpu_torch.ops.obb import (
        _compact_valid_rows,
        cluster_obb_stats_accum,
    )

    from pointcloudhookup_tpu_torch.utils import trace

    base = {}

    def counts_now():
        return {name: trace.counter(c) - base.get(name, 0)
                for name, (_, _, c) in KERNELS.items()}

    def reset_counts():
        base.update({name: trace.counter(c) for name, (_, _, c) in KERNELS.items()})

    def read_counts(path_kernels, what):
        counts = counts_now()
        print(f"launches in {what}: {counts}")
        missing = [name for name in path_kernels if counts[name] == 0]
        if missing:
            raise AssertionError(f"{what} never launched: {missing}")
        return counts

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # ---- build the kernels from the checkout's sources
    lib_path = build.build(verbose=True)
    build.library()
    print(f"kernels built -> {os.path.relpath(lib_path)}")

    launches = {}
    logs = []
    pts, centers = corridor_tile(N_POINTS, SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- the 4M corridor tile, as a user would hand it over: a LAS file
        las_path = os.path.join(tmp, "corridor_4m.las")
        write_las(make_las(pts), las_path)
        print(f"tile: {len(pts)} points, {len(centers)} towers")

        # ---- 1. the exact path through the user entry point; the first
        # call also saves each tower's member points (output_dir)
        out_dir = os.path.join(tmp, "towers")
        reset_counts()
        for call in range(2):
            logs.clear()
            towers = pipeline.extract(
                las_path, device=dev, log_callback=logs.append,
                output_dir=out_dir if call == 0 else None,
            )
        launches["exact"] = read_counts(EXACT_PATH, "the two extract() calls")
        centroids = np.array([
            read_las(os.path.join(out_dir, f"tower_{t.label}.las")).xyz().mean(axis=0)
            for t in towers
        ])
    ladder = next(line for line in logs if line.startswith("exact path:"))
    print(f"extract(): {len(towers)} towers; {ladder}")
    if len(towers) != len(centers):
        raise AssertionError(f"{len(towers)} towers found, {len(centers)} generated")
    # the member points' centroid locates a tower; the min-area box centre
    # also spans the vegetation cells adopted as border (reported only)
    box = nearest_xy(centers, [t.center for t in towers])
    worst = nearest_xy(centers, centroids)
    print(f"exact path: worst generated-tower distance to the nearest box centre "
          f"{box:.3f} m, to the nearest member centroid {worst:.3f} m (xy)")
    if worst > TOWER_TOL_M:
        raise AssertionError(f"a generated tower has no extracted centroid within "
                             f"{TOWER_TOL_M} m (worst {worst:.2f} m)")

    # ---- 2. small tile: GPU kernels vs the plain versions on the CPU
    small, _ = synthetic_corridor(
        np.random.default_rng(42), n_ground=4000, n_veg=800, pts_per_tower=400,
        extent=250.0,
    )
    sp = ExtractParams(
        cluster=ClusterParams(eps=5.0, min_points=30, auto_grid_threshold=1000)
    )
    tg, sg, _ = pipeline.extract_from_points(small, sp, device=dev)
    tc, sc, _ = pipeline.extract_from_points(small, sp, device="cpu")
    for key in ("labels", "ground_keep", "count", "accepted"):
        if not np.array_equal(sg[key], sc[key]):
            raise AssertionError(f"small tile: GPU and CPU differ in {key}")
    for a, b in zip(tg, tc):
        if np.abs(a.center - b.center).max() > 1e-3:
            raise AssertionError("small tile: tower centres differ by > 1 mm")
    print(f"small tile: GPU == CPU plain versions ({len(tg)} towers)")
    fma_check(dev)

    # ---- 4. the fast path through its user entry point
    params = ExtractParams()
    reset_counts()
    fast_towers, info = overflow.extract_from_points_resolving(
        pts, params, fast=True, device=dev
    )
    launches["fast"] = read_counts(FAST_PATH, "extract_from_points_resolving(fast=True)")
    worst_fast = nearest_xy(centers, [t.centroid for t in fast_towers])
    print(f"resolver (fast): {len(fast_towers)} towers; "
          f"tiles run {info['tiles_run']}, saturated tiles {info['saturated_tiles']}, "
          f"resolved {info['resolved']}; worst generated-tower distance to the "
          f"nearest centroid {worst_fast:.3f} m, box centre "
          f"{nearest_xy(centers, [t.center for t in fast_towers]):.3f} m (xy)")
    if len(fast_towers) != len(centers) or worst_fast > TOWER_TOL_M:
        raise AssertionError(f"fast path: {len(fast_towers)} towers, worst centroid "
                             f"distance {worst_fast:.2f} m")

    # ---- 5. bench.py's configuration on the card
    xyz_np, mask_np = padded(pts, N_POINTS)
    xyz_b = torch.from_numpy(xyz_np).to(dev)
    mask_b = torch.from_numpy(mask_np).to(dev)
    bench_kw = dict(max_cells=4096, min_cell_points=3, geometric_voxels=True,
                    emit="codes", core_cap=2048, core_flood_cells=16384)

    def bench_iter(precut_div):
        hi, lo, keep, labels, base, mn, over, _ = frontend_fused.fused_downsample_ground_cluster(
            xyz_b, mask_b, params, precut_div=precut_div, return_cells_overflow=True,
            **bench_kw,
        )
        stats = cluster_obb_stats_accum(
            hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
            num_angles=params.obb_angles,
        )
        return stats, filter_and_dedup(stats, params.filters), over

    reset_counts()
    precut_div = 6
    while True:  # settle the pre-cut as bench.py does
        over = float(bench_iter(precut_div)[2])
        if over <= 0.0 or precut_div <= 4:
            break
        precut_div -= 1
    bench = {}
    for div in (precut_div, 0):
        _, accepted, over = bench_iter(div)
        found = int(accepted.sum())
        bench[div] = dict(towers=found, overflow=float(over))
        print(f"bench config, precut_div {div}: {found}/{len(centers)} accepted, "
              f"overflow {float(over)}")
        if found != len(centers) or float(over) != 0.0:
            raise AssertionError(f"bench config (precut_div {div}): {found} towers, "
                                 f"overflow {float(over)}")
    launches["bench"] = read_counts(BENCH_PATH, "the bench configuration runs")

    # ---- 7. the other sort modes in the bench configuration, no pre-cut
    span = xyz_np.max(axis=0) - xyz_np.min(axis=0)
    sort_plan = frontend_fused.cell_sort_plan(span, eps=params.cluster.eps)
    eligible = frontend_fused.hier_sort_eligible(span)
    print(f"bench tile span {span.tolist()}: cell_sort_plan {sort_plan}, hier eligible {eligible}, "
          f"merge eligible {mergesort.merge_sort_eligible(N_POINTS)}")
    if sort_plan is None or not eligible or not mergesort.merge_sort_eligible(N_POINTS):
        raise AssertionError("the bench tile must be eligible for every sort mode")
    modes = {"cell": dict(sort_mode="cell", cell_plan=sort_plan),
             "cell_untight": dict(sort_mode="cell"),
             "hier": dict(sort_mode="hier"),
             "merge": dict(sort_mode="merge")}

    def mode_iter(kw):
        hi, lo, keep, labels, base, mn, over, hier_over = (
            frontend_fused.fused_downsample_ground_cluster(
                xyz_b, mask_b, params, precut_div=0, return_cells_overflow=True,
                **bench_kw, **kw))
        stats = cluster_obb_stats_accum(
            hi, lo, labels, keep, mn, max_clusters=params.max_clusters,
            num_angles=params.obb_angles,
        )
        return filter_and_dedup(stats, params.filters), over, hier_over

    sort_modes = {}
    for name, kw in modes.items():
        reset_counts()
        accepted, over, hier_over = mode_iter(kw)
        launches[f"sort_{name}"] = read_counts(SORT_PATH + (SORT_KERNEL[name],),
                                               f"sort_mode {name}")
        found = int(accepted.sum())
        sort_modes[name] = dict(towers=found, cells_over=float(over),
                                hier_runs_over=float(hier_over))
        print(f"sort_mode {name}: {found}/{len(centers)} accepted, cells_over {float(over)}, "
              f"hier_runs_over {float(hier_over)}")
        if found != len(centers) or float(over) != 0.0:
            raise AssertionError(f"sort_mode {name}: {found} towers, cells_over {float(over)}")

    # ---- 6. 131,072-row pre-cut tile: GPU vs the plain versions on the CPU
    n6 = 131072
    xs6 = np.linspace(-400, 400, 6)
    pts6, _ = synthetic_corridor(
        np.random.default_rng(5), n_ground=int(n6 * 0.8), n_veg=int(n6 * 0.12),
        towers=tuple(zip(xs6, 30.0 * np.sin(xs6 / 200.0))),
        pts_per_tower=(n6 - int(n6 * 0.92)) // 6, extent=450.0,
    )
    xyz6, mask6 = padded(pts6[:n6], n6)
    p6 = ExtractParams(max_clusters=64)
    kw6 = dict(max_cells=2048, min_cell_points=3, geometric_voxels=True, precut_div=4)
    plan6 = frontend_fused.cell_sort_plan(np.ptp(pts6[:n6], axis=0), eps=p6.cluster.eps)
    variants6 = {"full, pre-cut /4": {}, "cell": dict(sort_mode="cell", cell_plan=plan6),
                 "cell_untight": dict(sort_mode="cell"), "hier": dict(sort_mode="hier"),
                 "merge": dict(sort_mode="merge"), "obb sort": dict(obb="sort"),
                 "centroid voxels": dict(geometric_voxels=False)}
    for label, extra in variants6.items():
        kwv = dict(kw6, **extra)
        out_g = frontend_fused.fused_extract_step(
            torch.from_numpy(xyz6).to(dev), torch.from_numpy(mask6).to(dev), p6, **kwv)
        out_c = frontend_fused.fused_extract_step(
            torch.from_numpy(xyz6), torch.from_numpy(mask6), p6, **kwv)
        for key in ("labels", "ground_keep", "count", "accepted"):
            if not torch.equal(out_g[key].cpu(), out_c[key]):
                raise AssertionError(f"131,072-row tile, {label}: GPU and CPU differ in {key}")
        acc6 = out_c["accepted"]
        d6 = (out_g["center"].cpu() - out_c["center"])[acc6].abs()
        if d6.numel() and float(d6.max()) > 1e-3:
            raise AssertionError(f"131,072-row tile, {label}: tower centres differ by > 1 mm")
        print(f"131,072-row tile, {label} ({out_c['labels'].shape[0]} rows after the front "
              f"end's cut, hier_runs_over {float(out_c['hier_runs_over'])}): GPU == CPU plain "
              f"versions ({int(acc6.sum())} towers, centres within "
              f"{float(d6.max()) if d6.numel() else 0.0} m)")

    # ---- 8. the modular path (extract_step): dbscan, the fast=False
    # resolver, grid_dbscan, and GPU == CPU on entry()'s batch and a
    # per-chunk tile
    modular, modular_launches, modular_calls = modular_phase(
        dev, pts, centers, reset_counts, read_counts)
    launches.update(modular_launches)

    # ---- 9. the GIM workflow: run-all, compress GPU == CPU, reproject
    kernel_modules = wrapper_modules()
    gim, launches["gim_run_all"], compress_scan = gim_phase(
        dev, pts, centers, reset_counts, read_counts, kernel_modules)

    # ---- 10. registration (correct --icp, batched_icp, register) and
    # tile streaming (stream-extract at config 5's scale), card vs CPU
    phase10, stream_launches, stream_calls = registration_streaming_phase(
        dev, pts, centers, reset_counts, read_counts, counts_now, kernel_modules)
    launches.update(stream_launches)

    # ---- 11. the sharded step over torch.distributed: 4 ranks on the card
    # (gloo) against 1 rank (nccl), and the card against the CPU
    sharded, sharded_launches, sharded_calls = sharded_phase(dev)
    launches.update(sharded_launches)

    # ---- 12. the viewers (render, export-scene, viz-export), the elevation
    # report and the library functions (random_downsample, RANSAC, segment
    # rows) on phase 9's files and the 4M tile
    viewers, viewer_launches, viewer_calls = viewer_phase(
        dev, pts, centers, reset_counts, read_counts, kernel_modules)
    launches.update(viewer_launches)

    # ---- 3. each kernel vs its plain version at the paths' shapes.
    # Exact path: inputs as extract_from_points pads them; capacities as
    # the retry ladder settles them (an uncounted run of the path)
    n_cap = round_up(len(pts), 32768)
    xyz_e, mask_e = padded(pts, n_cap)
    plan = pipeline._exact_fast_plan(pts, params, n_cap)
    settled = pipeline._extract_stats_exact_fast(
        xyz_e, mask_e, params, plan, device=dev
    )["ladder"]
    print(f"settled ladder: {settled}")
    xyz = torch.from_numpy(xyz_e).to(dev)
    mask = torch.from_numpy(mask_e).to(dev)
    kw = dict(
        cell_bits=plan, compact_cap=settled["compact_cap"],
        max_cells=params.cluster.max_cells,
        min_cell_points=settled["floor"], core_cap=settled["core_cap"],
    )
    results = {name: [] for name in KERNELS}

    def case(name, label, kernel_fn, plain_fn, compare, *, nbytes, flops=0.0,
             library_fn=None, pairs=None, all_pairs=None):
        if pairs is not None:  # a pair kernel: 9 operations a pair within eps
            flops = 9.0 * pairs
        err = compare(kernel_fn(), plain_fn())
        prof = profile_iteration(kernel_fn, top=50)
        lib_dev = profile_iteration(library_fn)["device_ms"] if library_fn is not None else None
        ran = [(k.replace("(anonymous namespace)::", "").split("(")[0], v)
               for k, v in prof["top"]]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        entry = dict(
            case=label, device_ms=prof["device_ms"], library_device_ms=lib_dev, max_abs_err=err,
            bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", device_kernels=ran,
            device_launches=prof["counts"], pairs=pairs, all_pairs=all_pairs,
        )
        results[name].append(entry)
        lib = f"  library device {lib_dev} ms" if library_fn is not None else ""
        dms = f"{prof['device_ms']:.4f}" if prof["device_ms"] is not None else "not measured"
        print(f"{name:16s} {label:46s} device {dms} ms{lib}  bound {max(t_bytes, t_ops):.4f} "
              f"ms  max|diff| {err}"
              + ("" if pairs is None else f"  pairs within eps {pairs} (all-pairs count "
                 f"{all_pairs}, bound then {9.0 * all_pairs / F32_FLOPS * 1e3:.4f} ms)"))
        print(f"{'':16s} one profiled call ran: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ran))
        return entry

    def exact(name):
        def cmp(got, ref):
            require_equal(name, flat(got), flat(ref))
            return 0.0
        return cmp

    def compact_bytes(keep_mask, nchan, capacity):
        # keep read once, the kept rows that reach the output (this run's
        # count, up to the capacity) read once per channel, every output row
        # written once
        moved = min(int(keep_mask.sum()), capacity)
        return keep_mask.numel() + 4 * nchan * (moved + capacity)

    # compactrows: the survivor compaction (keep[4M], 4 channels)
    keep = frontend_exact.exact_extract_graph(xyz, mask, params, _cut=1, **kw)["keep"]
    chans = tuple(xyz[:, a].contiguous().view(torch.int32) for a in range(3)) + (
        torch.arange(n_cap, dtype=torch.int32, device=dev),
    )
    stacked = torch.stack(chans)
    cap = kw["compact_cap"]
    case("compactrows", f"keep[{n_cap}] x4 -> cap {cap}",
         lambda: compactrows.compact_rows_multi(keep, chans, cap),
         lambda: compactrows.compact_rows_multi_plain(keep, chans, cap),
         exact("compactrows"), nbytes=compact_bytes(keep, 4, cap),
         library_fn=lambda: stacked[:, keep])

    # segscan: per-cell population (add, reverse) and the label fill (max)
    ck_s = frontend_exact.exact_extract_graph(xyz, mask, params, _cut=3, **kw)["ck_s"]
    valid_s = (ck_s != 0xFFFFFFFF).to(torch.int32)
    c_start = ck_s != torch.roll(ck_s, 1)
    c_start[0] = True
    fill = torch.where(c_start, torch.arange(cap, device=dev, dtype=torch.int32) % 997,
                       torch.tensor(-1, dtype=torch.int32, device=dev))
    for label, vals, op, rev in ((f"add reverse i32[{cap}]", valid_s, "add", True),
                                 (f"max forward i32[{cap}]", fill, "max", False)):
        case("segscan", label,
             lambda v=vals, o=op, r=rev: segscan.segmented_scan(v, c_start, o, r),
             lambda v=vals, o=op, r=rev: segscan.segmented_scan_plain(v, c_start, o, r),
             exact("segscan"), nbytes=cap * (4 + 1 + 4))

    # one exact graph run, profiled: device ms by kernel
    graph = profile_iteration(lambda: frontend_exact.exact_extract_graph(xyz, mask, params, **kw))
    print(f"one exact graph run: device {graph['device_ms']} ms; device ms by kernel:")
    for name, ms in graph["top"]:
        print(f"  {ms:8.3f}  {name[:110]}")

    # neighbor + cluster_converge on the dense-cell table.  Their bound
    # counts the pairs within eps the function needs (the plain version's
    # walk with unit weights), 9 operations each: 3 subtractions, 3
    # products, 2 sums and the reduction
    cells = frontend_exact.exact_extract_graph(xyz, mask, params, _cut=4, **kw)
    centers_t, ccount, alive = cells["centers"], cells["ccount"], cells["cell_alive"]
    m = centers_t.shape[0]
    n_alive = int(alive.sum())
    eps2 = torch.tensor(params.cluster.eps, dtype=torch.float32, device=dev) ** 2

    def pair_counts(centers, allowed, e2=eps2):
        """Per row, the allowed columns within eps (int64)."""
        k = centers.shape[0]
        cnt, _ = neighbor.neighbor_reduce_plain(
            centers, torch.zeros(k, dtype=torch.int32, device=dev),
            torch.ones(k, dtype=torch.float32, device=dev), allowed, e2, mode="pop")
        return cnt.to(torch.int64)

    def converge_pairs(centers, ccount_c, alive_c, min_points, e2=eps2):
        """cluster_cells' pairs: the pop pass (every row, alive columns),
        the union (core pairs, each once) and the border pass (non-core
        alive rows, core columns); and the all-pairs count of the three."""
        k = centers.shape[0]
        pop_c, _ = neighbor.neighbor_reduce_plain(
            centers, torch.zeros(k, dtype=torch.int32, device=dev), ccount_c, alive_c,
            e2, mode="pop")
        pop_c = torch.where(centers[:, 0].abs() < 1e37, pop_c, 0.0)
        core_c = alive_c & (pop_c >= float(min_points))
        to_core = pair_counts(centers, core_c, e2)
        selfp = int((core_c & (((centers - centers) ** 2).sum(1) <= e2)).sum())
        pairs = (int(pair_counts(centers, alive_c, e2).sum())
                 + (int(to_core[core_c].sum()) - selfp) // 2
                 + int(to_core[alive_c & ~core_c].sum()))
        live, nc = int(alive_c.sum()), int(core_c.sum())
        return pairs, live * live + nc * nc + live * nc, nc

    zeros_i = torch.zeros(m, dtype=torch.int32, device=dev)
    case("neighbor", f"pop M={m} ({n_alive} live)",
         lambda: neighbor.neighbor_reduce(centers_t, zeros_i, ccount, alive, eps2, mode="pop"),
         lambda: neighbor.neighbor_reduce_plain(centers_t, zeros_i, ccount, alive, eps2, mode="pop"),
         exact("neighbor"), nbytes=m * (12 + 4 + 1 + 4),
         pairs=int(pair_counts(centers_t, alive).sum()), all_pairs=n_alive * n_alive)
    pop, _ = neighbor.neighbor_reduce(centers_t, zeros_i, ccount, alive, eps2, mode="pop")
    core = alive & (pop >= float(params.cluster.min_points))
    n_core = int(core.sum())
    iota_m = torch.arange(m, dtype=torch.int32, device=dev)
    zeros_f = torch.zeros(m, dtype=torch.float32, device=dev)
    case("neighbor", f"lmin M={m}, allowed=core ({n_core})",
         lambda: neighbor.neighbor_reduce(centers_t, iota_m, zeros_f, core, eps2, mode="lmin"),
         lambda: neighbor.neighbor_reduce_plain(centers_t, iota_m, zeros_f, core, eps2, mode="lmin"),
         exact("neighbor"), nbytes=m * (12 + 4 + 1 + 4),
         pairs=int(pair_counts(centers_t, core).sum()), all_pairs=n_alive * n_core)
    ccap = min(kw["core_cap"], m)
    (core_rows,), n_core_t, _ = _compact_valid_rows(core, (iota_m,), ccap, fill=m)
    slot_ok = torch.arange(ccap, device=dev) < torch.clamp(n_core_t, max=ccap)
    core_centers = torch.where(
        slot_ok[:, None], centers_t[torch.clamp(core_rows, 0, m - 1)], 3.0e38
    ).contiguous()
    ones_c = torch.ones(ccap, dtype=torch.float32, device=dev)
    iota_c = torch.arange(ccap, dtype=torch.int32, device=dev)
    converge_cases = [
        (f"core table {ccap}, min_points 0", (core_centers, ones_c, slot_ok, iota_c), 0.0),
        (f"full table {m}, min_points {params.cluster.min_points}",
         (centers_t, ccount, alive, iota_m), float(params.cluster.min_points)),
    ]
    # the fast path's own call: the bench configuration's cell table
    # (fused_downsample_ground_cluster below core_flood_cells)
    centers_f, ccount_f, alive_f = frontend_fused.fused_downsample_ground_cluster(
        xyz_b, mask_b, params, precut_div=precut_div, _cut=4, **bench_kw)
    mf = centers_f.shape[0]
    converge_cases.append((
        f"bench m-table {mf} ({int(alive_f.sum())} live), min_points "
        f"{params.cluster.min_points}",
        (centers_f, ccount_f, alive_f, torch.arange(mf, dtype=torch.int32, device=dev)),
        float(params.cluster.min_points)))
    for label, args, mp in converge_cases:
        pairs, all_pairs, nc = converge_pairs(args[0], args[1], args[2], mp)
        case("cluster_converge", f"{label}, {nc} core",
             lambda a=args, mp=mp: cluster_converge.cluster_cells(*a, eps2, mp),
             lambda a=args, mp=mp: cluster_converge.cluster_cells_plain(*a, eps2, mp),
             exact("cluster_converge"), nbytes=args[0].shape[0] * (12 + 4 + 1 + 4 + 4 + 4),
             pairs=pairs, all_pairs=all_pairs)

    # obb_accum over the cell-sorted rows and their labels
    full = frontend_exact.exact_extract_graph(xyz, mask, params, **kw)
    rows = full["rows_sorted"].long()
    lab_s = full["labels_sorted"]
    px, py, pz = (xyz[rows, a].contiguous() for a in range(3))
    k, a = params.max_clusters, params.obb_angles
    out_bytes = 4 * (6 * k + 4 * k * a)

    def cmp_obb(name, mag):
        # counts and extremes are order-free: identical.  The sums of one
        # cluster's n coordinates, added in two orders (atomics in both),
        # may differ by up to 2 n u sum|x| (u = 2**-24, the recursive
        # summation bound for each side); the centroid difference is
        # printed in metres.
        def cmp(got, ref):
            err = 0.0
            cnt = ref["cnt"].double()
            for key in obb_accum.NAMES:
                d = (got[key].double() - ref[key].double()).abs()
                err = max(err, float(d.max()))
                if key in ("sx", "sy", "sz"):
                    bound = 2.0 * cnt * 2.0**-24 * mag[key].double() + 1e-6
                    if bool((d > bound).any()):
                        raise AssertionError(f"{name}: {key} beyond the f32 summation bound")
                    cen = float((d / cnt.clamp(min=1.0)).max())
                    print(f"{name}: {key} max |diff| {float(d.max())}, as a centroid {cen} m")
                elif not torch.equal(got[key], ref[key]):
                    raise AssertionError(f"{name}: {key} differs (max |diff| {float(d.max())})")
            return err
        return cmp

    mag = obb_accum.obb_accumulate_xyz_plain(px.abs(), py.abs(), pz.abs(), lab_s,
                                             max_clusters=k, num_angles=a)
    n_lab = int(((lab_s >= 0) & (lab_s < k)).sum())
    case("obb_accum", f"rows {cap} ({n_lab} labelled), K={k}, A={a}",
         lambda: obb_accum.obb_accumulate_xyz(px, py, pz, lab_s, max_clusters=k, num_angles=a),
         lambda: obb_accum.obb_accumulate_xyz_plain(px, py, pz, lab_s, max_clusters=k, num_angles=a),
         cmp_obb("obb_accum", mag), nbytes=cap * 16 + out_bytes, flops=6.0 * n_lab * a)

    # compactrows: the exact path's dense-cell table pack (5 channels: start
    # row, population and one member coordinate), over the sorted rows
    ctot_s = segscan.segmented_scan(valid_s, c_start, "add", True)
    dense_e = c_start & (valid_s != 0) & (ctot_s >= settled["floor"])
    me = params.cluster.max_cells
    pos_e = torch.arange(cap, dtype=torch.int32, device=dev)
    chans5 = (pos_e, ctot_s, *(v.view(torch.int32) for v in (px, py, pz)))
    stacked5 = torch.stack(chans5)
    case("compactrows", f"dense table keep[{cap}] x5 -> m {me}",
         lambda: compactrows.compact_rows_multi(dense_e, chans5, me),
         lambda: compactrows.compact_rows_multi_plain(dense_e, chans5, me),
         exact("compactrows"), nbytes=compact_bytes(dense_e, 5, me),
         library_fn=lambda: stacked5[:, dense_e])

    # fast path, bench configuration: the pre-cut compaction of the Morton
    # words, the OBB accumulation over the settled run's rows, and the
    # cell-table pack of the run without pre-cut (compact_indices)
    hi0, lo0, _, v_b = frontend_fused.morton_keys(xyz_b, mask_b)
    thresh, _ = frontend_fused.precut_threshold(xyz_b, mask_b, params)
    keep_pre = mask_b & (xyz_b[:, 2] > thresh)
    pcap = -(-(N_POINTS // precut_div) // 32768) * 32768
    case("compactrows", f"Morton keep_pre[{N_POINTS}] -> cap {pcap}",
         lambda: compactrows.compact_rows(keep_pre, hi0, lo0, pcap),
         lambda: compactrows.compact_rows_plain(keep_pre, hi0, lo0, pcap),
         exact("compactrows"), nbytes=compact_bytes(keep_pre, 2, pcap),
         library_fn=lambda: torch.stack((hi0, lo0))[:, keep_pre])

    # the m-table pack of the pre-cut run (one channel, dead slots n - 1)
    dense_p, _ = frontend_fused.fused_downsample_ground_cluster(
        xyz_b, mask_b, params, precut_div=precut_div, _cut=3, **bench_kw)
    mc = bench_kw["max_cells"]
    pos_p = torch.arange(pcap, dtype=torch.int32, device=dev)
    case("compactrows", f"m-table dense_start[{pcap}] ({int(dense_p.sum())} set) x1 -> m {mc}",
         lambda: compactrows.compact_rows_multi(dense_p, (pos_p,), mc, fills=(pcap - 1,)),
         lambda: compactrows.compact_rows_multi_plain(dense_p, (pos_p,), mc, fills=(pcap - 1,)),
         exact("compactrows"), nbytes=compact_bytes(dense_p, 1, mc),
         library_fn=lambda: pos_p[dense_p])

    hi, lo, keepf, labels, _, mn = frontend_fused.fused_downsample_ground_cluster(
        xyz_b, mask_b, params, precut_div=precut_div, **bench_kw)
    labf = torch.where((labels >= 0) & (labels < k) & keepf, labels, -1)
    vx, vy, vz = (v.to(torch.float32) * 0.1 + mn[i] for i, v in enumerate(morton_decode(hi, lo)))
    mag_f = obb_accum.obb_accumulate_xyz_plain(vx.abs(), vy.abs(), vz.abs(), labf,
                                               max_clusters=k, num_angles=a)
    n_labf = int((labf >= 0).sum())
    case("obb_accumulate", f"rows {hi.shape[0]} ({n_labf} labelled), K={k}, A={a}",
         lambda: obb_accum.obb_accumulate(hi, lo, labf, mn, max_clusters=k, num_angles=a),
         lambda: obb_accum.obb_accumulate_plain(hi, lo, labf, mn, max_clusters=k, num_angles=a),
         cmp_obb("obb_accumulate", mag_f), nbytes=hi.shape[0] * 12 + 12 + out_bytes,
         flops=6.0 * n_labf * a)

    dense_start, _ = frontend_fused.fused_downsample_ground_cluster(
        xyz_b, mask_b, params, precut_div=0, _cut=3, **bench_kw)
    case("compact_indices",
         f"dense_start[{N_POINTS}] ({int(dense_start.sum())} set) -> m {mc}",
         lambda: compactidx.compact_indices(dense_start, mc),
         lambda: compactidx.compact_indices_plain(dense_start, mc),
         exact("compact_indices"), nbytes=N_POINTS + 4 * mc,
         library_fn=lambda: torch.nonzero(dense_start))

    # segscan at the fast path's shapes, taken from the path's own calls:
    # the cell populations (add reverse) of the bench run with the pre-cut
    # and of the sort-mode tile, and the centroid-voxel sums of four columns
    def captured_scans(run):  # every caller passes the four arguments
        with recording(segscan, "segmented_scan", []) as calls:
            run()
        return [args for args, _ in calls]

    def cell_population(calls):
        return next(c for c in calls if c[2] == "add" and c[3] and c[0].dim() == 1)

    for label, run in (("bench run, pre-cut", lambda: bench_iter(precut_div)),
                       ("sort-mode tile (hier)", lambda: mode_iter(modes["hier"]))):
        vals, flags, _, _ = cell_population(captured_scans(run))
        case("segscan", f"{label}: add reverse i32[{vals.shape[0]}]",
             lambda v=vals, f=flags: segscan.segmented_scan(v, f, "add", True),
             lambda v=vals, f=flags: segscan.segmented_scan_plain(v, f, "add", True),
             exact("segscan"), nbytes=vals.shape[0] * (4 + 1 + 4))

    def cmp_sums(vals, flags, reverse, kernel_fn):
        # float32 sums in the kernel's fixed order: two calls give the same
        # bits, and each output, a sum of k rows, lies within k 2**-23 sum|v|
        # of the doubling scan's (each order is within (k - 1) u sum|v| of
        # the exact sum, u = 2**-24)
        def cmp(got, ref):
            if not torch.equal(got, kernel_fn()):
                raise AssertionError("segscan: two calls of a float32 sum differ")
            ones = torch.ones(vals.shape[0], dtype=torch.float64, device=dev)
            k = segscan.segmented_scan_plain(ones, flags, "add", reverse)
            mag = segscan.segmented_scan_plain(vals.double().abs(), flags, "add", reverse)
            d = (got.double() - ref.double()).abs()
            if bool((d > k[:, None] * 2.0**-23 * mag).any()):
                raise AssertionError("segscan: a float32 sum beyond the summation bound")
            return float(d.max())
        return cmp

    centroid_kw = dict(bench_kw, geometric_voxels=False, emit="xyz")
    vals4, flags4, _, _ = next(c for c in captured_scans(
        lambda: frontend_fused.fused_downsample_ground_cluster(
            xyz_b, mask_b, params, precut_div=0, **centroid_kw)) if c[0].dim() == 2)
    scan4 = lambda: segscan.segmented_scan(vals4, flags4, "add", True)  # noqa: E731
    case("segscan", f"centroid voxels: f32 add reverse [{vals4.shape[0]}, {vals4.shape[1]}]",
         scan4, lambda: segscan.segmented_scan_plain(vals4, flags4, "add", True),
         cmp_sums(vals4, flags4, True, scan4), nbytes=vals4.shape[0] * (16 + 1 + 16))
    # compress's call (phase 9 (a)): the voxel sums of four float32 columns
    vals_c, flags_c, _, _ = compress_scan
    scan_c = lambda: segscan.segmented_scan(vals_c, flags_c, "add", True)  # noqa: E731
    case("segscan", f"compress (9a): f32 add reverse [{vals_c.shape[0]}, {vals_c.shape[1]}]",
         scan_c, lambda: segscan.segmented_scan_plain(vals_c, flags_c, "add", True),
         cmp_sums(vals_c, flags_c, True, scan_c), nbytes=vals_c.shape[0] * (16 + 1 + 16))
    # segscan and compact_indices: one kernel launch a call, besides a memset
    for name in ("segscan", "compact_indices"):
        for c in results[name]:
            runs = c["device_launches"]
            memsets = sum(v for k, v in runs.items() if "memset" in k.lower())
            if c["device_ms"] is not None and (sum(runs.values()) - memsets != 1 or memsets > 1):
                raise AssertionError(f"{name} {c['case']}: one call launched {runs}")

    # sort-mode kernels on the bench tile's keys: dupwin on the tight key
    # (depth 16) and on the cell key (depth 64), winsort on the hier keys,
    # mergesort on the Morton words, and at block 2,048 on adversarial pairs.
    # Bytes are the function's: a u32 key k1 is 4 bytes (the port holds it
    # in int64, which the kernels read at 8), winsort's w input is u16 and
    # dupwin writes one flag byte
    cs =frontend_fused._effective_cell_shift(params.cluster.eps, 0.1, 5)
    ksort, _, _, w_low = frontend_fused.tight_cell_key(v_b, hi0, lo0, mask_b, sort_plan, cs)
    k1, w16 = frontend_fused.cell_key(hi0, lo0, mask_b, 3 * cs)
    for label, key, wv, depth in ((f"tight key, depth {sort_plan[4]}", ksort, w_low, sort_plan[4]),
                                  ("cell key, depth 64", k1, w16, 64)):
        case("dupwin", f"{label}, rows {N_POINTS}",
             lambda key=key, wv=wv, d=depth: dupwin.first_occurrence_flags(key, wv, d),
             lambda key=key, wv=wv, d=depth: dupwin.first_occurrence_flags_plain(key, wv, d),
             exact("dupwin"), nbytes=N_POINTS * (4 + 4 + 1))
    keys0 = winsort.packed_windows(k1, w16, 256)
    keys_mid = keys0[128:-128]
    case("winsort", f"hier keys, rows {N_POINTS}, W 256",
         lambda: winsort.window_sort_w(k1, w16, 256),
         lambda: winsort.window_sort_w_plain(k1, w16, 256),
         exact("winsort"), nbytes=N_POINTS * (4 + 2 + 4),
         library_fn=lambda: (keys0.view(-1, 256).sort(dim=1), keys_mid.view(-1, 256).sort(dim=1)))
    # hier_window takes any even size: windows a block sorts (2,048 and
    # 4,096, the largest) and one above 4,096 rows, sorted in chunked passes
    nw = 1 << 20
    k1w, w16w = k1[:nw], w16[:nw]
    for ww in (2048, 4096, 32768):
        keys_w = winsort.packed_windows(k1w, w16w, ww)
        case("winsort", f"hier keys, rows {nw}, W {ww}",
             lambda ww=ww: winsort.window_sort_w(k1w, w16w, ww),
             lambda ww=ww: winsort.window_sort_w_plain(k1w, w16w, ww),
             exact("winsort"), nbytes=nw * (4 + 2 + 4),
             library_fn=lambda ww=ww, kw=keys_w: (
                 kw.view(-1, ww).sort(dim=1), kw[ww // 2:-ww // 2].view(-1, ww).sort(dim=1)))
    for name in ("dupwin", "winsort"):
        for c in results[name]:
            lib = ("none" if c["library_device_ms"] is None
                   else f"{c['library_device_ms']:.4f} (torch.sort(dim=1), both offsets)")
            print(f"{name} {c['case']}: device {c['device_ms']} ms, library device {lib} ms, "
                  f"bound {c['bound_ms']:.4f} ms")
    packed = (hi0.to(torch.int64) << 30) | lo0.to(torch.int64)
    merge_case = case("mergesort", f"Morton (hi, lo)[{N_POINTS}], block 8192",
                      lambda: mergesort.merge_sort_2key(hi0, lo0),
                      lambda: mergesort.merge_sort_2key_plain(hi0, lo0),
                      exact("mergesort"), nbytes=N_POINTS * 16,
                      library_fn=lambda: torch.sort(packed))
    # its parts, from the profiled call: the block sort and the 9 merge rounds
    mergesort_parts = {
        part: sum(v for k, v in merge_case["device_kernels"] if kernel in k)
        for part, kernel in (("block_sort_ms", "block_sort_kernel"),
                             ("merge_rounds_ms", "merge_kernel"))
    }
    print(f"mergesort at {N_POINTS} rows, device ms: block sort "
          f"{mergesort_parts['block_sort_ms']:.4f}, 9 merge rounds "
          f"{mergesort_parts['merge_rounds_ms']:.4f}")
    rng3 = np.random.default_rng(3)
    na = 1 << 20
    half = np.arange(na // 2)
    adversarial = {
        "all equal": (np.full(na, 5), np.full(na, 9)),
        "reversed": (np.arange(na, 0, -1), np.zeros(na)),
        "80 % sentinel": (np.where(rng3.random(na) < 0.8, 0x7FFFFFFF,
                                   rng3.integers(0, 1 << 30, na)), rng3.integers(0, 1 << 30, na)),
        "skewed co-ranks": (np.concatenate([1000000 + half, half]), np.zeros(na)),
    }
    for label, (h, l) in adversarial.items():
        h = torch.from_numpy(h.astype(np.int32)).to(dev)
        l = torch.from_numpy(l.astype(np.int32)).to(dev)
        packed = mergesort.pack(h, l)
        case("mergesort", f"{label}, rows {na}, block 2048",
             lambda h=h, l=l: mergesort.merge_sort_2key(h, l, block=2048),
             lambda h=h, l=l: mergesort.merge_sort_2key_plain(h, l),
             exact("mergesort"), nbytes=na * 16,
             library_fn=lambda packed=packed: torch.sort(packed))

    # the modular path's calls (phase 8): cluster_converge on dbscan's rows
    # (cell-sorted, as dbscan hands them over) and on the grid table;
    # segscan and compactrows at grid_dbscan's calls (the settled run)
    for label, (args, _) in (("dbscan rows (8a), cell-sorted", modular_calls["dbscan"][-1]),
                             ("grid table (8c)", modular_calls["grid_cells"][-1])):
        mp = args[5]
        pairs, all_pairs, nc = converge_pairs(args[0], args[1], args[2], mp)
        case("cluster_converge",
             f"{label} M={args[0].shape[0]} ({int(args[2].sum())} live), min_points "
             f"{mp:g}, {nc} core",
             lambda a=args: cluster_converge.cluster_cells(*a),
             lambda a=args: cluster_converge.cluster_cells_plain(*a),
             exact("cluster_converge"), nbytes=args[0].shape[0] * (12 + 4 + 1 + 4 + 4 + 4),
             pairs=pairs, all_pairs=all_pairs)
    # the same dbscan call on rows in input order: the kernel culls by row
    # boxes, which then span the tile.  labels0 carries the input row, so
    # the result is the same, permuted
    args = modular_calls["dbscan"][-1][0]
    src = args[3].long()

    def unsorted(v):
        out = torch.empty_like(v)
        out[src] = v
        return out

    args_u = tuple(unsorted(v).contiguous() for v in args[:4]) + tuple(args[4:])
    got_u = cluster_converge.cluster_cells(*args_u)
    require_equal("cluster_converge (input order)", [v[src] for v in got_u],
                  list(cluster_converge.cluster_cells(*args)))
    print(f"cluster_converge on dbscan's rows (8a), M={args[0].shape[0]}, in input order: "
          f"the cell-sorted result, permuted")
    for (vals, flags, op, rev), _ in modular_calls["grid_scans"][-2:]:
        case("segscan", f"grid (8c): {op} {'reverse' if rev else 'forward'} i32[{vals.shape[0]}]",
             lambda v=vals, f=flags, o=op, r=rev: segscan.segmented_scan(v, f, o, r),
             lambda v=vals, f=flags, o=op, r=rev: segscan.segmented_scan_plain(v, f, o, r),
             exact("segscan"), nbytes=vals.shape[0] * (4 + 1 + 4))
    # grid_dbscan makes each masked row (sorted last) a segment of its own;
    # the same scans with those rows as one segment give the same outputs
    grid_scans = [args for args, _ in modular_calls["grid_scans"][-2:]]
    dead = grid_scans[0][0] == 0  # the add scan's values: 1 on live rows
    one_dead_segment = grid_scans[0][1] & ~(dead & torch.roll(dead, 1))
    for vals, flags, op, rev in grid_scans:
        require_equal("segscan (dead-row flags)", [segscan.segmented_scan(
            vals, one_dead_segment, op, rev)], [segscan.segmented_scan(vals, flags, op, rev)])
        print(f"segscan grid (8c) {op} {'reverse' if rev else 'forward'}, {int(dead.sum())} "
              f"dead rows: the same outputs with them as one segment")
    (keep_g, chans_g, m_g), _ = modular_calls["grid_pack"][-1]
    stacked_g = torch.stack(chans_g)
    case("compactrows",
         f"grid table (8c) keep[{keep_g.shape[0]}] ({int(keep_g.sum())} set) x4 -> m {m_g}",
         lambda: compactrows.compact_rows_multi(keep_g, chans_g, m_g),
         lambda: compactrows.compact_rows_multi_plain(keep_g, chans_g, m_g),
         exact("compactrows"), nbytes=compact_bytes(keep_g, 4, m_g),
         library_fn=lambda: stacked_g[:, keep_g])

    # the streaming paths' own calls (phase 10 (d)): every kernel call of one
    # fast and one modular stream_extract tile of STREAM_TILE_N points with
    # config 5's parameters (the ground pre-cut, the 8,192-cell grid table),
    # and of rank 0's 4-rank sharded step in each mode (phase 11), each held
    # against its plain version
    def replay(tag, calls):
        for i, (name, args, kw) in enumerate(calls):
            label = f"{tag} call {i}"
            if name == "compactrows":
                keep_t, chans_t, cap_t = args[:3]
                stacked_t = torch.stack(chans_t)
                case(name, f"{label}: keep[{keep_t.shape[0]}] ({int(keep_t.sum())} set) "
                           f"x{len(chans_t)} -> {cap_t}",
                     lambda a=args, k_=kw: compactrows.compact_rows_multi(*a, **k_),
                     lambda a=args, k_=kw: compactrows.compact_rows_multi_plain(*a, **k_),
                     exact(name), nbytes=compact_bytes(keep_t, len(chans_t), cap_t),
                     library_fn=lambda st=stacked_t, kp=keep_t: st[:, kp])
            elif name == "segscan":
                vals_t, flags_t, op_t, rev_t = args
                fn = lambda a=args: segscan.segmented_scan(*a)  # noqa: E731
                cols = vals_t[0].numel()
                cmp = (exact(name) if not vals_t.is_floating_point()
                       else cmp_sums(vals_t, flags_t, rev_t, fn))
                case(name, f"{label}: {op_t} {'reverse' if rev_t else 'forward'} "
                           f"{str(vals_t.dtype)[6:]}{list(vals_t.shape)}",
                     fn, lambda a=args: segscan.segmented_scan_plain(*a), cmp,
                     nbytes=vals_t.shape[0] * (2 * cols * vals_t.element_size() + 1))
            elif name == "neighbor":
                cen_t, _, _, allowed_t, e2_t = args
                m_t = cen_t.shape[0]
                live_t = int((cen_t[:, 0].abs() < 1e37).sum())
                case(name, f"{label}: {kw.get('mode')} M={m_t} ({live_t} live, "
                           f"{int(allowed_t.sum())} allowed)",
                     lambda a=args, k_=kw: neighbor.neighbor_reduce(*a, **k_),
                     lambda a=args, k_=kw: neighbor.neighbor_reduce_plain(*a, **k_),
                     exact(name), nbytes=m_t * (12 + 4 + 1 + 4),
                     pairs=int(pair_counts(cen_t, allowed_t, e2_t).sum()),
                     all_pairs=live_t * int(allowed_t.sum()))
            elif name == "cluster_converge":
                mp = float(args[5])
                pairs, all_pairs, nc = converge_pairs(args[0], args[1], args[2], mp,
                                                      args[4])
                case(name, f"{label}: M={args[0].shape[0]} ({int(args[2].sum())} live), "
                           f"min_points {mp:g}, {nc} core",
                     lambda a=args, k_=kw: cluster_converge.cluster_cells(*a, **k_),
                     lambda a=args, k_=kw: cluster_converge.cluster_cells_plain(*a, **k_),
                     exact(name), nbytes=args[0].shape[0] * (12 + 4 + 1 + 4 + 4 + 4),
                     pairs=pairs, all_pairs=all_pairs)
            elif name == "obb_accum":
                x_t, y_t, z_t, lab_t = args
                k_t, a_t = kw["max_clusters"], kw["num_angles"]
                mag_t = obb_accum.obb_accumulate_xyz_plain(
                    x_t.abs(), y_t.abs(), z_t.abs(), lab_t, max_clusters=k_t, num_angles=a_t)
                n_lab_t = int(((lab_t >= 0) & (lab_t < k_t)).sum())
                case(name, f"{label}: rows {x_t.shape[0]} ({n_lab_t} labelled), "
                           f"K={k_t}, A={a_t}",
                     lambda a=args, k_=kw: obb_accum.obb_accumulate_xyz(*a, **k_),
                     lambda a=args, k_=kw: obb_accum.obb_accumulate_xyz_plain(*a, **k_),
                     cmp_obb(name, mag_t), nbytes=x_t.shape[0] * 16
                     + 4 * (6 * k_t + 4 * k_t * a_t), flops=6.0 * n_lab_t * a_t)
            elif name == "obb_accumulate":
                hi_t, lo_t, lab_t, mn_t = args
                vs_t, off_t = obb_accum._morton_offset(mn_t, kw["voxel_size"])
                vs_d = torch.tensor(vs_t, dtype=torch.float32, device=dev)
                absxyz = [fma_f32(v.to(torch.float32), vs_d, off_t[j]).abs()
                          for j, v in enumerate(morton_decode(hi_t, lo_t))]
                k_t, a_t = kw["max_clusters"], kw["num_angles"]
                mag_t = obb_accum.obb_accumulate_xyz_plain(*absxyz, lab_t, max_clusters=k_t,
                                                           num_angles=a_t)
                n_lab_t = int(((lab_t >= 0) & (lab_t < k_t)).sum())
                case(name, f"{label}: rows {hi_t.shape[0]} ({n_lab_t} labelled), "
                           f"K={k_t}, A={a_t}",
                     lambda a=args, k_=kw: obb_accum.obb_accumulate(*a, **k_),
                     lambda a=args, k_=kw: obb_accum.obb_accumulate_plain(*a, **k_),
                     cmp_obb(name, mag_t), nbytes=hi_t.shape[0] * 12 + 12
                     + 4 * (6 * k_t + 4 * k_t * a_t), flops=6.0 * n_lab_t * a_t)
            else:
                raise AssertionError(f"phase 3: no replay for a {name} call")

    for tile, calls in stream_calls.items():
        replay(f"{tile} (10d)", calls)
    for mode_key, calls in sharded_calls.items():
        replay(f"{mode_key} (11, rank 0 of {SHARDED_RANKS})", to_device(calls, dev))
    for key, calls in viewer_calls.items():
        replay(f"{key} (12e)", calls)
    captured = {**stream_calls, **sharded_calls, **viewer_calls}
    paths = {"stream_fast": FAST_PATH, "stream_modular": MODULAR_GRID_PATH,
             **{key: SHARDED_PATH[key.split("_", 1)[1]] for key in sharded_calls},
             "viewer_segments": ("segscan",)}
    missing = [(key, name) for key, path in paths.items() for name in path
               if name not in {c[0] for c in captured[key]}]
    if missing:
        raise AssertionError(f"phase 3: no captured call of {missing}")

    entries = []
    for name, (source, replaces, _) in KERNELS.items():
        cases = results[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        lib = [c["library_device_ms"] for c in cases if c["library_device_ms"] is not None]
        worst = max(cases, key=lambda c: c["bound_ms"])
        entries.append(dict(
            name=name,
            route="cuda",
            source=f"pointcloudhookup_tpu_torch/csrc/{source}",
            replaces=replaces,
            launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            device_ms=(None if any(c["device_ms"] is None for c in cases)
                       else sum(c["device_ms"] for c in cases)),
            bound_ms=sum(c["bound_ms"] for c in cases),
            bound_by=worst["bound_by"],
            library_device_ms=sum(lib) if lib else None,
            cases=cases,
        ))
    print(json.dumps(dict(
        card=smi, resolver_info=info, bench_precut_div=precut_div, bench=bench,
        sort_modes=sort_modes, mergesort_parts=mergesort_parts, modular=modular,
        gim_workflow=gim, registration_streaming=phase10, sharded=sharded, viewers=viewers,
    )))
    print(json.dumps(dict(kernels=entries)))
    print(json.dumps(dict(
        ok=True,
        device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=torch.cuda.device_count()),
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
