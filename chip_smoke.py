"""Chip smoke test of the PyTorch + CUDA port (pointcloudhookup_tpu_torch).

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
     against the JAX reference);
  4. the fast path through its user entry point
     ``extract_from_points_resolving(pts, fast=True, device="cuda")``:
     24/24 towers, each generated tower within 2 m (xy) of an accepted
     tower's centroid, every kernel of the path launched;
  5. bench.py's configuration (fused front-end + accumulator OBB +
     filters; 4,096 cells, density floor 3, pre-cut /6 settled toward /4
     on overflow): 24/24 accepted, no overflow, ms per iteration by CUDA
     events; once more without the pre-cut, which packs the cell table
     with compact_indices;
  7. the fused front-end's other sort modes in bench.py's configuration
     without the pre-cut (the reference pre-cuts only in sort_mode
     "full"): "cell" with the tile's tight cell_sort_plan (dupwin, depth
     16), "cell" without a plan (dupwin, depth 64), "hier" (winsort,
     W 256) and "merge" (mergesort): 24/24 accepted, cells_over 0,
     hier_runs_over printed, ms per iteration by CUDA events beside "full"
     without the pre-cut, and the mode's kernel launched;
  6. checks that the fast path on a 131,072-row tile gives the same
     labels, keep, counts and accepted towers on the GPU as through the
     plain versions on the CPU, and tower centres within 1 mm: pre-cut
     "full", each sort mode of phase 7, the sort-based OBB and centroid
     voxels;
  3. runs each kernel and its plain PyTorch version on the same device
     tensors at the shapes the paths give it, requires agreement (integer
     outputs, pop, counts and extremes identical; OBB sums within the f32
     summation bound), times both with CUDA events, profiles one call of the
     kernel (device_ms: the summed device time of what that call ran, with
     the names of its kernels) and one of its library call where there is
     one (library_device_ms), times the host's issue of the calls
     (host_ms), to tell device time from host time, and computes each
     kernel's bound (the larger of its bytes over 3.35 TB/s and its float32
     operations over 67 TFLOP/s, counted from this run's inputs: for the
     pair kernels 9 operations for each pair within eps that the function
     needs, counted by the plain version's walk, beside the all-pairs
     count). Phase 3 also profiles one exact graph run (device ms by
     kernel), runs cluster_converge at the fast path's own call, the
     bench configuration's 4,096-row cell table, and winsort at W 2,048,
     4,096 (the largest window one block sorts) and 32,768 (chunked
     passes through a scratch buffer) besides W 256, with a line of
     device, library and bound ms for each sort-mode kernel case; segscan
     also at the fast path's own calls (the pre-cut bench run's and the
     sort-mode tile's cell populations, the centroid-voxel sums of four
     float32 columns, within the summation bound and bit-equal over two
     calls), torch.cumsum of the same int32 rows for scale, and a check
     that a segscan or compact_indices call launches one kernel.

Launch counts are reset just before each path's run (1, 4, 5, each mode of
7) and read just after.  Prints the card's name and power limit, one JSON line of
per-kernel results, and as its last line {"ok": true, "device": {...}}.
Any failure raises: the exit code is non-zero and the last line is not
printed.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_POINTS = 4 * 1024 * 1024
SEED = 7
TOWER_TOL_M = 2.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BENCH_ITERS = 10

# name -> (source, TPU kernel it replaces, (module, launch counter))
KERNELS = {
    "compactrows": ("compactrows.cu", "pointcloudhookup_tpu/ops/pallas/compactrows.py:320",
                    ("compactrows", "launches")),
    "segscan": ("segscan.cu", "pointcloudhookup_tpu/ops/pallas/segscan.py:104",
                ("segscan", "launches")),
    "neighbor": ("neighbor.cu", "pointcloudhookup_tpu/ops/pallas/neighbor.py:133",
                 ("neighbor", "launches")),
    "cluster_converge": ("cluster_converge.cu",
                         "pointcloudhookup_tpu/ops/pallas/cluster_converge.py:259",
                         ("cluster_converge", "launches")),
    "obb_accum": ("obb_accum.cu", "pointcloudhookup_tpu/ops/pallas/obb_accum.py:301",
                  ("obb_accum", "launches")),
    "obb_accumulate": ("obb_accum.cu", "pointcloudhookup_tpu/ops/pallas/obb_accum.py:168",
                       ("obb_accum", "launches_morton")),
    "compact_indices": ("compactidx.cu", "pointcloudhookup_tpu/ops/pallas/compactidx.py:122",
                        ("compactidx", "launches")),
    "dupwin": ("dupwin.cu", "pointcloudhookup_tpu/ops/pallas/dupwin.py:70",
               ("dupwin", "launches")),
    "winsort": ("winsort.cu", "pointcloudhookup_tpu/ops/pallas/winsort.py:169",
                ("winsort", "launches")),
    "mergesort": ("mergesort.cu", "pointcloudhookup_tpu/ops/pallas/mergesort.py:284",
                  ("mergesort", "launches")),
}
EXACT_PATH = ("compactrows", "segscan", "neighbor", "cluster_converge", "obb_accum")
FAST_PATH = ("compactrows", "segscan", "cluster_converge", "obb_accumulate")
BENCH_PATH = FAST_PATH + ("compact_indices",)
# phase 7: the bench configuration without the pre-cut packs its cell table
# with compact_indices; each sort mode adds its own kernel
SORT_PATH = ("segscan", "cluster_converge", "obb_accumulate", "compact_indices")
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


def timed(fn, reps: int):
    """Mean ms per call over reps calls after one warm-up, by CUDA events;
    returns (ms, last result)."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def issue_ms(fn, reps: int) -> float:
    """Host ms per call to issue reps calls back to back (the device is
    idle at the start, the queue is drained after); where it nears the event
    ms of timed(), the host, not the device, sets the pace."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


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
    """One call of fn under torch.profiler: its wall ms, the device's busy
    ms (device-side kernels and copies, summed), the idle share of the
    wall, the top device ms by kernel name and the launches by name; device
    figures are None when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's row repeats its kernels' time
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = {e.key: e.self_device_time_total for e in device}
    device_ms = sum(device_us.values()) / 1e3
    ranked = sorted(device_us.items(), key=lambda kv: -kv[1])[:top]
    if device_ms == 0.0:
        return dict(wall_ms=wall_ms, device_ms=None, idle_share=None, top=[], counts={})
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1.0 - device_ms / wall_ms),
                top=[(k, v / 1e3) for k, v in ranked],
                counts={e.key: e.count for e in device})


def nearest_xy(centers, xy) -> float:
    """The largest distance (xy) from a generated tower to the nearest of
    the given positions."""
    dist = np.linalg.norm(centers[:, None, :2] - np.asarray(xy)[None, :, :2], axis=2)
    return float(dist.min(axis=1).max())


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
    from pointcloudhookup_tpu_torch.ops.morton import morton_decode
    from pointcloudhookup_tpu_torch.ops.obb import (
        _compact_valid_rows,
        cluster_obb_stats_accum,
    )

    counters = {
        name: (importlib.import_module(f"pointcloudhookup_tpu_torch.ops.kernels.{mod}"), attr)
        for name, (_, _, (mod, attr)) in KERNELS.items()
    }

    def reset_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read_counts(path_kernels, what):
        counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
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
    lib_path, build_s = build.build(verbose=True)
    build.library()
    print(f"kernels built in {build_s:.1f} s -> {os.path.relpath(lib_path)}")

    launches = {}
    logs = []
    walls = []
    pts, centers = corridor_tile(N_POINTS, SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # ---- the 4M corridor tile, as a user would hand it over: a LAS file
        t0 = time.perf_counter()
        las_path = os.path.join(tmp, "corridor_4m.las")
        write_las(make_las(pts), las_path)
        print(f"tile: {len(pts)} points, {len(centers)} towers, LAS written in "
              f"{time.perf_counter() - t0:.1f} s")

        # ---- 1. the exact path through the user entry point; the first
        # call also saves each tower's member points (output_dir), the
        # second is timed alone
        out_dir = os.path.join(tmp, "towers")
        reset_counts()
        for call in range(2):
            logs.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            towers = pipeline.extract(
                las_path, device=dev, log_callback=logs.append,
                output_dir=out_dir if call == 0 else None,
            )
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches["exact"] = read_counts(EXACT_PATH, "the two extract() calls")
        centroids = np.array([
            read_las(os.path.join(out_dir, f"tower_{t.label}.las")).xyz().mean(axis=0)
            for t in towers
        ])
    ladder = next(line for line in logs if line.startswith("exact path:"))
    print(f"extract(): {len(towers)} towers; {ladder}; wall ms "
          f"first {walls[0]:.1f} (with per-tower LAS output), second {walls[1]:.1f}")
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

    # ---- 4. the fast path through its user entry point
    params = ExtractParams()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast_towers, info = overflow.extract_from_points_resolving(
        pts, params, fast=True, device=dev
    )
    torch.cuda.synchronize()
    resolver_ms = (time.perf_counter() - t0) * 1e3
    launches["fast"] = read_counts(FAST_PATH, "extract_from_points_resolving(fast=True)")
    worst_fast = nearest_xy(centers, [t.centroid for t in fast_towers])
    print(f"resolver (fast): {len(fast_towers)} towers in {resolver_ms:.1f} ms; "
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
        ms, (stats, accepted, over) = timed(lambda d=div: bench_iter(d), BENCH_ITERS)
        found = int(accepted.sum())
        bench[div] = dict(ms=ms, mpts=N_POINTS / ms / 1e3, towers=found,
                          overflow=float(over))
        print(f"bench config, precut_div {div}: {ms:.3f} ms/iteration, "
              f"{N_POINTS / ms / 1e3:.1f} Mpts/s, {found}/{len(centers)} accepted, "
              f"overflow {float(over)}")
        if found != len(centers) or float(over) != 0.0:
            raise AssertionError(f"bench config (precut_div {div}): {found} towers, "
                                 f"overflow {float(over)}")
    launches["bench"] = read_counts(BENCH_PATH, "the bench configuration runs")
    profile = profile_iteration(lambda: bench_iter(precut_div))
    busy = (f"device busy {profile['device_ms']:.3f} ms (idle "
            f"{100 * profile['idle_share']:.1f} %)" if profile["device_ms"] is not None
            else "device time not measured (the profiler saw none)")
    print(f"bench config, precut_div {precut_div}, one profiled iteration: wall "
          f"{profile['wall_ms']:.3f} ms, {busy}; device ms by kernel:")
    for name, ms in profile["top"]:
        print(f"  {ms:8.3f}  {name[:110]}")

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

    sort_modes = {"full": dict(ms=[timed(lambda: bench_iter(0), BENCH_ITERS)[0]])}
    for name, kw in modes.items():
        reset_counts()
        mode_iter(kw)
        torch.cuda.synchronize()
        launches[f"sort_{name}"] = read_counts(SORT_PATH + (SORT_KERNEL[name],),
                                               f"sort_mode {name}")
        ms, (accepted, over, hier_over) = timed(lambda kw=kw: mode_iter(kw), BENCH_ITERS)
        found = int(accepted.sum())
        prof = profile_iteration(lambda kw=kw: mode_iter(kw), top=0)
        sort_modes[name] = dict(ms=ms, towers=found, cells_over=float(over),
                                hier_runs_over=float(hier_over), device_ms=prof["device_ms"],
                                idle_share=prof["idle_share"])
        print(f"sort_mode {name}: {ms:.3f} ms/iteration, {found}/{len(centers)} accepted, "
              f"cells_over {float(over)}, hier_runs_over {float(hier_over)}; one profiled "
              f"iteration: device busy {prof['device_ms']} ms, idle share {prof['idle_share']}")
        if found != len(centers) or float(over) != 0.0:
            raise AssertionError(f"sort_mode {name}: {found} towers, cells_over {float(over)}")
    sort_modes["full"]["ms"].append(timed(lambda: bench_iter(0), BENCH_ITERS)[0])
    prof = profile_iteration(lambda: bench_iter(0), top=0)
    sort_modes["full"].update(device_ms=prof["device_ms"], idle_share=prof["idle_share"])
    print(f"sort_mode full (no pre-cut), before and after the modes: "
          f"{sort_modes['full']['ms']} ms/iteration; one profiled iteration: device busy "
          f"{prof['device_ms']} ms, idle share {prof['idle_share']}")

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
             library_fn=None, reps=5, plain_reps=3, pairs=None, all_pairs=None):
        if pairs is not None:  # a pair kernel: 9 operations a pair within eps
            flops = 9.0 * pairs
        ms, got = timed(kernel_fn, reps)
        plain_ms, ref = timed(plain_fn, plain_reps)
        lib_ms = timed(library_fn, reps)[0] if library_fn is not None else None
        err = compare(got, ref)
        host_ms = issue_ms(kernel_fn, reps)
        prof = profile_iteration(kernel_fn, top=50)
        lib_dev = profile_iteration(library_fn)["device_ms"] if library_fn is not None else None
        ran = [(k.replace("(anonymous namespace)::", "").split("(")[0], v)
               for k, v in prof["top"]]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        entry = dict(
            case=label, ms=ms, device_ms=prof["device_ms"], host_ms=host_ms, plain_ms=plain_ms,
            library_ms=lib_ms, library_device_ms=lib_dev, max_abs_err=err, bytes=nbytes, flops=flops,
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            device_kernels=ran, device_launches=prof["counts"], pairs=pairs, all_pairs=all_pairs,
        )
        results[name].append(entry)
        lib = (f"  library {lib_ms:8.3f} ms (device {lib_dev})" if lib_ms is not None
               else "")
        dev = f"{prof['device_ms']:.4f}" if prof["device_ms"] is not None else "not measured"
        print(f"{name:16s} {label:46s} kernel {ms:8.3f} ms  device {dev} ms  host "
              f"{host_ms:.4f} ms  plain {plain_ms:9.3f} ms{lib}  bound {max(t_bytes, t_ops):.4f} "
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
    print(f"one exact graph run: wall {graph['wall_ms']:.3f} ms, device busy "
          f"{graph['device_ms']} ms; device ms by kernel:")
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

    def pair_counts(centers, allowed):
        """Per row, the allowed columns within eps (int64)."""
        k = centers.shape[0]
        cnt, _ = neighbor.neighbor_reduce_plain(
            centers, torch.zeros(k, dtype=torch.int32, device=dev),
            torch.ones(k, dtype=torch.float32, device=dev), allowed, eps2, mode="pop")
        return cnt.to(torch.int64)

    def converge_pairs(centers, ccount_c, alive_c, min_points):
        """cluster_cells' pairs: the pop pass (every row, alive columns),
        the union (core pairs, each once) and the border pass (non-core
        alive rows, core columns); and the all-pairs count of the three."""
        k = centers.shape[0]
        pop_c, _ = neighbor.neighbor_reduce_plain(
            centers, torch.zeros(k, dtype=torch.int32, device=dev), ccount_c, alive_c,
            eps2, mode="pop")
        pop_c = torch.where(centers[:, 0].abs() < 1e37, pop_c, 0.0)
        core_c = alive_c & (pop_c >= float(min_points))
        to_core = pair_counts(centers, core_c)
        selfp = int((core_c & (((centers - centers) ** 2).sum(1) <= eps2)).sum())
        pairs = (int(pair_counts(centers, alive_c).sum())
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
        (f"core table {ccap}, min_points 0",
         (core_centers, ones_c, slot_ok, iota_c), 0.0, {}),
        (f"full table {m}, min_points {params.cluster.min_points}",
         (centers_t, ccount, alive, iota_m), float(params.cluster.min_points),
         dict(plain_reps=1)),
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
        float(params.cluster.min_points), {}))
    for label, args, mp, extra in converge_cases:
        pairs, all_pairs, nc = converge_pairs(args[0], args[1], args[2], mp)
        case("cluster_converge", f"{label}, {nc} core",
             lambda a=args, mp=mp: cluster_converge.cluster_cells(*a, eps2, mp),
             lambda a=args, mp=mp: cluster_converge.cluster_cells_plain(*a, eps2, mp),
             exact("cluster_converge"), nbytes=args[0].shape[0] * (12 + 4 + 1 + 4 + 4 + 4),
             pairs=pairs, all_pairs=all_pairs, **extra)

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
    def captured_scans(run):
        calls = []
        kernel = segscan.segmented_scan

        def record(values, is_start, op="add", reverse=False):
            calls.append((values, is_start, op, reverse))
            return kernel(values, is_start, op, reverse)

        segscan.segmented_scan = record
        try:
            run()
        finally:
            segscan.segmented_scan = kernel
        return calls

    def cell_population(calls):
        return next(c for c in calls if c[2] == "add" and c[3] and c[0].dim() == 1)

    for label, run in (("bench run, pre-cut", lambda: bench_iter(precut_div)),
                       ("sort-mode tile (hier)", lambda: mode_iter(modes["hier"]))):
        vals, flags, _, _ = cell_population(captured_scans(run))
        case("segscan", f"{label}: add reverse i32[{vals.shape[0]}]",
             lambda v=vals, f=flags: segscan.segmented_scan(v, f, "add", True),
             lambda v=vals, f=flags: segscan.segmented_scan_plain(v, f, "add", True),
             exact("segscan"), nbytes=vals.shape[0] * (4 + 1 + 4))
    # an unsegmented one-pass scan of the same int32 [N], for scale only (it
    # computes another function, so it is not the library column)
    cum_ms = timed(lambda: torch.cumsum(vals, 0, dtype=torch.int32), 5)[0]
    cum_dev = profile_iteration(lambda: torch.cumsum(vals, 0, dtype=torch.int32))["device_ms"]
    print(f"torch.cumsum over the same i32[{vals.shape[0]}] (not segmented, for scale): "
          f"{cum_ms:.4f} ms, device {cum_dev} ms")

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
         cmp_sums(vals4, flags4, True, scan4), nbytes=vals4.shape[0] * (16 + 1 + 16),
         plain_reps=1)
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
          f"{mergesort_parts['merge_rounds_ms']:.4f}; kernel {merge_case['ms']:.4f} ms against "
          f"torch.sort of the packed keys {merge_case['library_ms']:.4f} ms")
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

    entries = []
    for name, (source, replaces, _) in KERNELS.items():
        cases = results[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        lib = [c["library_ms"] for c in cases if c["library_ms"] is not None]
        worst = max(cases, key=lambda c: c["bound_ms"])
        entries.append(dict(
            name=name,
            route="cuda",
            source=f"pointcloudhookup_tpu_torch/csrc/{source}",
            replaces=replaces,
            launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=sum(c["ms"] for c in cases),
            device_ms=(None if any(c["device_ms"] is None for c in cases)
                       else sum(c["device_ms"] for c in cases)),
            plain_ms=sum(c["plain_ms"] for c in cases),
            bound_ms=sum(c["bound_ms"] for c in cases),
            bound_by=worst["bound_by"],
            library_ms=sum(lib) if lib else None,
            cases=cases,
        ))
    print(json.dumps(dict(
        card=smi, build_s=build_s, extract_ms=walls[1], extract_first_ms=walls[0],
        resolver_fast_ms=resolver_ms, resolver_info=info,
        bench_precut_div=precut_div, bench=bench, bench_profile=profile,
        sort_modes=sort_modes, mergesort_parts=mergesort_parts,
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
