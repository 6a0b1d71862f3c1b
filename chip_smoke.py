"""Chip smoke test of the PyTorch + CUDA port (pointcloudhookup_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from pointcloudhookup_tpu_torch/csrc,
writes the 4,194,304-point synthetic corridor tile of bench.py (seed 7, 80 %
ground, 12 % vegetation, 24 towers, 2 km extent) as LAS, and

  1. extracts its towers twice through the user entry point
     ``extract(las, device="cuda")`` with every kernel's launch counter reset
     just before, and requires 24/24 towers, the centroid of each tower's
     saved member points within 2 m (xy) of a generated centre, and every
     kernel of the path launched;
  2. checks that a small tile extracts identically on the GPU and through
     the plain PyTorch versions on the CPU (which the CPU test suite holds
     against the JAX reference);
  3. runs each kernel and its plain PyTorch version on the same device
     tensors at the shapes the main path gives it, requires agreement
     (integer outputs, pop, counts and extremes identical; OBB sums within
     the f32 summation bound) and times both with CUDA events.

Prints the card's name and power limit, one JSON line of per-kernel
results, and as its last line {"ok": true, "device": {...}}.  Any failure
raises: the exit code is non-zero and the last line is not printed.  It
imports nothing of JAX.
"""

from __future__ import annotations

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

KERNELS = (
    ("compactrows", "pointcloudhookup_tpu/ops/pallas/compactrows.py:320"),
    ("segscan", "pointcloudhookup_tpu/ops/pallas/segscan.py:104"),
    ("neighbor", "pointcloudhookup_tpu/ops/pallas/neighbor.py:133"),
    ("cluster_converge", "pointcloudhookup_tpu/ops/pallas/cluster_converge.py:259"),
    ("obb_accum", "pointcloudhookup_tpu/ops/pallas/obb_accum.py:301"),
)


def corridor_tile(n: int, seed: int):
    """bench.py's build_workload tile in world coordinates (f64)."""
    from pointcloudhookup_tpu.io.synthetic import synthetic_corridor

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    from pointcloudhookup_tpu.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu.io.las import make_las, read_las, write_las
    from pointcloudhookup_tpu_torch.core.batch import round_up
    from pointcloudhookup_tpu_torch.models import pipeline
    from pointcloudhookup_tpu_torch.ops import frontend_exact
    from pointcloudhookup_tpu_torch.ops.kernels import (
        build,
        cluster_converge,
        compactrows,
        neighbor,
        obb_accum,
        segscan,
    )
    from pointcloudhookup_tpu_torch.ops.obb import _compact_valid_rows

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

    modules = dict(
        compactrows=compactrows, segscan=segscan, neighbor=neighbor,
        cluster_converge=cluster_converge, obb_accum=obb_accum,
    )
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

        # ---- 1. the main path through the user entry point; the first
        # call also saves each tower's member points (output_dir), the
        # second is timed alone
        out_dir = os.path.join(tmp, "towers")
        for mod in modules.values():
            mod.launches = 0
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
        launches = {name: mod.launches for name, mod in modules.items()}
        centroids = np.array([
            read_las(os.path.join(out_dir, f"tower_{t.label}.las")).xyz().mean(axis=0)
            for t in towers
        ])
    ladder = next(line for line in logs if line.startswith("exact path:"))
    print(f"extract(): {len(towers)} towers; {ladder}; wall ms "
          f"first {walls[0]:.1f} (with per-tower LAS output), second {walls[1]:.1f}")
    for t, c in zip(towers, centroids):
        print(f"  {t.id}: box center=({t.center[0]:.2f},{t.center[1]:.2f},"
              f"{t.center[2]:.2f}) centroid=({c[0]:.2f},{c[1]:.2f}) h={t.height:.1f} "
              f"w={t.width:.1f} pts={t.num_points}")
    print(f"launches in the two extract() calls: {launches}")
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"the main path never launched: {missing}")
    if len(towers) != len(centers):
        raise AssertionError(f"{len(towers)} towers found, {len(centers)} generated")
    # the member points' centroid locates a tower; the min-area box centre
    # also spans the vegetation cells adopted as border (reported only)
    for what, xy in (("box centre", np.array([t.center[:2] for t in towers])),
                     ("centroid", centroids[:, :2])):
        dist = np.linalg.norm(centers[:, None, :2] - xy[None, :, :], axis=2)
        worst = float(dist.min(axis=1).max())
        print(f"worst generated-tower distance to the nearest extracted {what}: "
              f"{worst:.3f} m (xy)")
    if worst > TOWER_TOL_M:
        raise AssertionError(f"a generated tower has no extracted centroid within "
                             f"{TOWER_TOL_M} m (worst {worst:.2f} m)")

    # ---- 2. small tile: GPU kernels vs the plain versions on the CPU
    from pointcloudhookup_tpu.io.synthetic import synthetic_corridor

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

    # ---- 3. each kernel vs its plain version at the path's shapes
    # inputs as extract_from_points pads them; capacities as the retry
    # ladder settles them (a third, uncounted run of the path)
    params = ExtractParams()
    n_cap = round_up(len(pts), 32768)
    xyz_np = np.zeros((n_cap, 3), np.float32)
    xyz_np[: len(pts)] = (pts - pts.mean(axis=0)).astype(np.float32)
    mask_np = np.arange(n_cap) < len(pts)
    plan = pipeline._exact_fast_plan(pts, params, n_cap)
    settled = pipeline._extract_stats_exact_fast(
        xyz_np, mask_np, params, plan, device=dev
    )["ladder"]
    print(f"settled ladder: {settled}")
    xyz = torch.from_numpy(xyz_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    kw = dict(
        cell_bits=plan, compact_cap=settled["compact_cap"],
        max_cells=params.cluster.max_cells,
        min_cell_points=settled["floor"], core_cap=settled["core_cap"],
    )
    results = {name: [] for name in modules}

    def case(name, label, kernel_fn, plain_fn, compare, reps=5, plain_reps=3):
        ms, got = timed(kernel_fn, reps)
        plain_ms, ref = timed(plain_fn, plain_reps)
        err = compare(got, ref)
        results[name].append(dict(case=label, ms=ms, plain_ms=plain_ms, max_abs_err=err))
        print(f"{name:17s} {label:44s} kernel {ms:9.3f} ms  plain {plain_ms:9.3f} ms"
              f"  max|diff| {err}")

    def exact(name):
        def cmp(got, ref):
            require_equal(name, flat(got), flat(ref))
            return 0.0
        return cmp

    # compactrows: the survivor compaction (keep[4M], 4 channels)
    keep = frontend_exact.exact_extract_graph(xyz, mask, params, _cut=1, **kw)["keep"]
    chans = tuple(xyz[:, a].contiguous().view(torch.int32) for a in range(3)) + (
        torch.arange(n_cap, dtype=torch.int32, device=dev),
    )
    cap = kw["compact_cap"]
    case("compactrows", f"keep[{n_cap}] x4 -> cap {cap}",
         lambda: compactrows.compact_rows_multi(keep, chans, cap),
         lambda: compactrows.compact_rows_multi_plain(keep, chans, cap),
         exact("compactrows"))

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
             exact("segscan"))

    # neighbor + cluster_converge on the dense-cell table
    cells = frontend_exact.exact_extract_graph(xyz, mask, params, _cut=4, **kw)
    centers_t, ccount, alive = cells["centers"], cells["ccount"], cells["cell_alive"]
    m = centers_t.shape[0]
    eps2 = torch.tensor(params.cluster.eps, dtype=torch.float32, device=dev) ** 2
    zeros_i = torch.zeros(m, dtype=torch.int32, device=dev)
    case("neighbor", f"pop M={m}",
         lambda: neighbor.neighbor_reduce(centers_t, zeros_i, ccount, alive, eps2, mode="pop"),
         lambda: neighbor.neighbor_reduce_plain(centers_t, zeros_i, ccount, alive, eps2, mode="pop"),
         exact("neighbor"))
    pop, _ = neighbor.neighbor_reduce(centers_t, zeros_i, ccount, alive, eps2, mode="pop")
    core = alive & (pop >= float(params.cluster.min_points))
    iota_m = torch.arange(m, dtype=torch.int32, device=dev)
    zeros_f = torch.zeros(m, dtype=torch.float32, device=dev)
    case("neighbor", f"lmin M={m}, allowed=core",
         lambda: neighbor.neighbor_reduce(centers_t, iota_m, zeros_f, core, eps2, mode="lmin"),
         lambda: neighbor.neighbor_reduce_plain(centers_t, iota_m, zeros_f, core, eps2, mode="lmin"),
         exact("neighbor"))
    ccap = min(kw["core_cap"], m)
    (core_rows,), n_core, _ = _compact_valid_rows(core, (iota_m,), ccap, fill=m)
    slot_ok = torch.arange(ccap, device=dev) < torch.clamp(n_core, max=ccap)
    core_centers = torch.where(
        slot_ok[:, None], centers_t[torch.clamp(core_rows, 0, m - 1)], 3.0e38
    ).contiguous()
    ones_c = torch.ones(ccap, dtype=torch.float32, device=dev)
    iota_c = torch.arange(ccap, dtype=torch.int32, device=dev)
    case("cluster_converge", f"core table {ccap} ({int(n_core)} core), min_points 0",
         lambda: cluster_converge.cluster_cells(core_centers, ones_c, slot_ok, iota_c, eps2, 0.0),
         lambda: cluster_converge.cluster_cells_plain(core_centers, ones_c, slot_ok, iota_c, eps2, 0.0),
         exact("cluster_converge"))
    case("cluster_converge", f"full table {m}, min_points {params.cluster.min_points}",
         lambda: cluster_converge.cluster_cells(centers_t, ccount, alive, iota_m, eps2,
                                                float(params.cluster.min_points)),
         lambda: cluster_converge.cluster_cells_plain(centers_t, ccount, alive, iota_m, eps2,
                                                      float(params.cluster.min_points)),
         exact("cluster_converge"), reps=2, plain_reps=1)

    # obb_accum over the cell-sorted rows and their labels
    full = frontend_exact.exact_extract_graph(xyz, mask, params, **kw)
    rows = full["rows_sorted"].long()
    lab_s = full["labels_sorted"]
    px, py, pz = (xyz[rows, a].contiguous() for a in range(3))
    k, a = params.max_clusters, params.obb_angles
    mag = obb_accum.obb_accumulate_xyz_plain(px.abs(), py.abs(), pz.abs(), lab_s,
                                             max_clusters=k, num_angles=a)

    def cmp_obb(got, ref):
        # counts and extremes are order-free: identical.  The sums of one
        # cluster's n coordinates, added in two orders (atomics in both),
        # may differ by up to 2 n u sum|x| (u = 2**-24, the recursive
        # summation bound for each side); the centroid difference is
        # printed in metres.
        err = 0.0
        cnt = ref["cnt"].double()
        for key in obb_accum.NAMES:
            d = (got[key].double() - ref[key].double()).abs()
            err = max(err, float(d.max()))
            if key in ("sx", "sy", "sz"):
                bound = 2.0 * cnt * 2.0**-24 * mag[key].double() + 1e-6
                if bool((d > bound).any()):
                    raise AssertionError(f"obb_accum: {key} beyond the f32 summation bound")
                cen = float((d / cnt.clamp(min=1.0)).max())
                print(f"obb_accum: {key} max |diff| {float(d.max())}, as a centroid {cen} m")
            elif not torch.equal(got[key], ref[key]):
                raise AssertionError(f"obb_accum: {key} differs (max |diff| {float(d.max())})")
        return err

    case("obb_accum", f"rows {cap}, K={k}, A={a}",
         lambda: obb_accum.obb_accumulate_xyz(px, py, pz, lab_s, max_clusters=k, num_angles=a),
         lambda: obb_accum.obb_accumulate_xyz_plain(px, py, pz, lab_s, max_clusters=k, num_angles=a),
         cmp_obb)

    entries = []
    for name, replaces in KERNELS:
        cases = results[name]
        entries.append(dict(
            name=name,
            route="cuda",
            source=f"pointcloudhookup_tpu_torch/csrc/{name}.cu",
            replaces=replaces,
            launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=sum(c["ms"] for c in cases),
            plain_ms=sum(c["plain_ms"] for c in cases),
            cases=cases,
        ))
    print(json.dumps(dict(
        card=smi, extract_ms=walls[1], extract_first_ms=walls[0],
        build_s=build_s,
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
