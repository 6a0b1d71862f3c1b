"""The port's tracer (``utils/trace.py``) and its spans and counters in the
extraction, compress, streaming and ICP paths, on the CPU."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams
from pointcloudhookup_tpu_torch.core.streaming import stream_extract
from pointcloudhookup_tpu_torch.io.las import make_las, write_las
from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor
from pointcloudhookup_tpu_torch.models import pipeline
from pointcloudhookup_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def tracer():
    trace.disable()
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def names(spans):
    return [s.name for s in sorted(spans, key=lambda s: s.t0_ns)]


def test_inactive_spans_record_nothing():
    assert not trace.active()
    a, b = trace.span("a"), trace.span("b")
    assert a is b  # the one shared no-op context
    with a as opened:
        assert opened is None
        trace.count("test.inactive", 2)
    assert trace.spans() == []
    assert trace.counter("test.inactive") >= 2  # totals count always


def test_spans_record_under_a_cpu_profiler_and_stop_after_it():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.active()
        with trace.span("inside"):
            pass
    assert not trace.active()
    with trace.span("after"):
        pass
    assert names(trace.spans()) == ["inside"]


def test_enable_and_disable():
    trace.enable()
    with trace.span("on"):
        pass
    trace.disable()
    with trace.span("off"):
        pass
    assert names(trace.spans()) == ["on"]
    trace.reset()
    assert trace.spans() == []


def test_parents_requests_and_self_time():
    trace.enable()
    with trace.span("req") as req:
        time.sleep(0.02)
        with trace.span("req.a") as a:
            time.sleep(0.01)
        with trace.span("req.b") as b:
            with trace.span("req.b.c") as c:
                time.sleep(0.01)
    with trace.span("next") as nxt:
        pass
    assert req.parent is None and nxt.parent is None
    assert (a.parent, b.parent, c.parent) == (req.id, req.id, b.id)
    assert a.request == b.request == c.request == req.request != nxt.request
    assert len({s.id for s in trace.spans()}) == 5
    wall = {s.name: s.t1_ns - s.t0_ns for s in trace.spans()}
    for s in (a, b, c):
        assert req.t0_ns <= s.t0_ns <= s.t1_ns <= req.t1_ns
    self_req = wall["req"] - wall["req.a"] - wall["req.b"]
    self_b = wall["req.b"] - wall["req.b.c"]
    assert 0.02e9 <= self_req < wall["req"] - 0.02e9
    assert 0 <= self_b < 0.01e9
    assert all(s.tid == threading.get_native_id() for s in trace.spans())
    assert 0 < req.cpu_ns <= wall["req"] + 1e6


def test_counts_land_on_the_innermost_span_and_in_the_totals():
    before = trace.counter("test.k")
    trace.enable()
    with trace.span("outer") as outer:
        trace.count("test.k")
        with trace.span("inner") as inner:
            trace.count("test.k", 3)
            trace.count("test.j")
    trace.count("test.k", 5)  # no open span: the totals only
    assert outer.counts == {"test.k": 1}
    assert inner.counts == {"test.k": 3, "test.j": 1}
    assert trace.counter("test.k") == before + 9
    assert trace.counter("test.never") == 0


def _two_tiles(rng):
    return [synthetic_corridor(rng, n_ground=1500, n_veg=0, towers=((0.0, 0.0),),
                               pts_per_tower=400, extent=100.0, origin=(d * 500.0, 0.0, 0.0))[0]
            for d in range(2)]


def _stream_params():
    return ExtractParams(cluster=ClusterParams(eps=5.0, min_points=30),
                         ground=GroundParams(min_points_after=64), max_clusters=16,
                         obb_angles=32)


def test_producer_spans_carry_the_consumers_request_and_stream_parent():
    tiles = _two_tiles(np.random.default_rng(3))
    trace.enable()
    stream_extract(tiles, capacity=2048, params=_stream_params(), fast=True, wire="f32",
                   device="cpu")
    got = trace.spans()
    (stream,) = [s for s in got if s.name == "stream"]
    producer = [s for s in got if s.name in ("stream.decode", "stream.stage")]
    assert len(producer) == 4
    assert {s.tid for s in producer} != {stream.tid}
    for s in producer:
        assert (s.parent, s.request) == (stream.id, stream.request)
    stage_parts = [s for s in got if s.name.startswith("stream.stage.")]
    stages = {s.id for s in got if s.name == "stream.stage"}
    assert len(stage_parts) == 6 and all(s.parent in stages for s in stage_parts)
    for s in got:
        assert s.request == stream.request


def test_anchor_places_a_span_on_the_trace_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w0 = time.perf_counter()
        with record_function("pb:window"):
            time.sleep(0.005)
            with trace.span("aligned") as s:
                time.sleep(0.005)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ts = {e["name"]: float(e["ts"]) for e in events
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    anchor_us = ts["pb:window"] - w0 * 1e6
    assert abs(s.t0_ns / 1e3 + anchor_us - ts["pc:aligned"]) < 1000.0


@pytest.mark.parametrize("eps,n_veg,max_cells,steps", [(5.0, 800, 32768, 1), (2.0, 2000, 1024, 2)],
                         ids=["one_step", "floor_retry"])
def test_extract_spans_in_order_and_ladder_steps(monkeypatch, eps, n_veg, max_cells, steps):
    pts, _ = synthetic_corridor(np.random.default_rng(7), n_ground=4000, n_veg=n_veg,
                                pts_per_tower=400, extent=250.0)
    # a low threshold routes the ~6k-point tile to the exact path; few
    # table cells make the density floor's retry run a second graph
    params = ExtractParams(cluster=ClusterParams(eps=eps, min_points=30, max_cells=max_cells,
                                                 auto_grid_threshold=1000))
    graphs = []
    inner = pipeline.exact_extract_graph

    def counted(*args, **kwargs):
        graphs.append(kwargs["min_cell_points"])
        return inner(*args, **kwargs)

    monkeypatch.setattr(pipeline, "exact_extract_graph", counted)
    steps0, up0 = trace.counter("extract.ladder_step"), trace.counter("upload_bytes")
    trace.enable()
    _, stats, _ = pipeline.extract_from_points(pts, params, device="cpu")
    trace.disable()
    assert stats["ladder"]["floor"] == graphs[-1] and len(graphs) == steps
    assert names(trace.spans()) == (["extract", "extract.prepare", "extract.upload"]
                                    + ["extract.graph", "extract.fetch"] * steps
                                    + ["extract.finish", "extract.finish"])
    assert trace.counter("extract.ladder_step") - steps0 == steps
    (top,) = [s for s in trace.spans() if s.name == "extract"]
    assert top.counts == {"extract.ladder_step": steps}
    (prep,) = [s for s in trace.spans() if s.name == "extract.prepare"]
    assert prep.counts == {"extract.prepare.native": 1}  # the native passes
    cap = stats["labels"].shape[0]
    # one f32 [cap, 3] and one bool [cap] upload, however many steps
    assert trace.counter("upload_bytes") - up0 == cap * 13
    fetched = [s.counts["fetch"] for s in trace.spans() if s.name == "extract.fetch"]
    assert len(fetched) == steps and min(fetched) > 0


_STEP_PARAMS = {
    "per_chunk": ClusterParams(eps=5.0, min_points=30, per_chunk=True, chunk_size=1024),
    "modular": ClusterParams(eps=5.0, min_points=30),
    "exact": ClusterParams(eps=5.0, min_points=30, auto_grid_threshold=1000),
}


def _step_tile():
    pts, _ = synthetic_corridor(np.random.default_rng(11), n_ground=4000, n_veg=800,
                                pts_per_tower=400, extent=250.0)
    return pts[np.argsort(pts[:, 0], kind="stable")]  # flight order: towers cut by chunks


@pytest.mark.parametrize("path", ["per_chunk", "modular"])
def test_modular_step_spans_and_counters(path):
    """extract_step's four phases open under extract.graph; per chunk,
    cluster.chunks counts capacity / chunk_size; every dedup round counts."""
    params = ExtractParams(cluster=_STEP_PARAMS[path])
    chunks0, rounds0 = trace.counter("cluster.chunks"), trace.counter("extract.dedup_rounds")
    trace.enable()
    _, stats, _ = pipeline.extract_from_points(_step_tile(), params, device="cpu")
    trace.disable()
    assert "modular" in stats
    got = trace.spans()
    step = ["extract.ground", "extract.cluster", "extract.obb", "extract.filter"]
    assert names(got) == (["extract", "extract.prepare", "extract.upload", "extract.graph"]
                          + step + ["extract.fetch", "extract.finish"])
    by = {s.name: s for s in got}
    assert all(by[n].parent == by["extract.graph"].id for n in step)
    cap = stats["labels"].shape[0]
    chunks = cap // 1024 if path == "per_chunk" else 0
    assert trace.counter("cluster.chunks") - chunks0 == chunks
    assert by["extract.cluster"].counts == ({"cluster.chunks": chunks} if chunks else None)
    rounds = trace.counter("extract.dedup_rounds") - rounds0
    assert rounds >= 1 and by["extract.filter"].counts == {"extract.dedup_rounds": rounds}


@pytest.mark.parametrize("path", ["per_chunk", "modular", "exact"])
def test_extract_outputs_equal_with_the_tracer_on_and_off(path):
    params = ExtractParams(cluster=_STEP_PARAMS[path])
    pts = _step_tile()
    off_towers, off, _ = pipeline.extract_from_points(pts, params, device="cpu")
    trace.enable()
    on_towers, on, _ = pipeline.extract_from_points(pts, params, device="cpu")
    trace.disable()
    assert ("ladder" in on) == (path == "exact") and trace.spans()
    for key in ("labels", "ground_keep", "accepted", "center", "extent", "count"):
        assert np.array_equal(on[key], off[key]), key
    assert len(on_towers) == len(off_towers) >= 2
    for a, b in zip(on_towers, off_towers):
        assert a.label == b.label and a.num_points == b.num_points
        assert np.array_equal(a.center, b.center) and np.array_equal(a.extent, b.extent)
        assert a.north_angle == b.north_angle


def test_compress_spans_in_order(tmp_path):
    pts, _ = synthetic_corridor(np.random.default_rng(8), n_ground=3000, n_veg=300,
                                pts_per_tower=200, extent=150.0)
    src, out = str(tmp_path / "in.las"), str(tmp_path / "out.las")
    write_las(make_las(pts, scales=[0.01] * 3), src)
    trace.enable()
    pipeline.compress(src, out, voxel_size=0.5, device="cpu")
    got = trace.spans()
    by_id = {s.name: s.id for s in got}
    assert names(got) == ["compress", "las.load", "las.read", "las.xyz", "compress.prepare",
                          "compress.voxel", "compress.fetch", "compress.write"]
    parents = {s.parent for s in got}
    assert [s.name for s in got if s.id not in parents][0] == "las.read"  # leaves
    under_load = {"las.read", "las.xyz"}
    assert all(s.parent == by_id["las.load"] for s in got if s.name in under_load)
    assert all(s.parent == by_id["compress"] for s in got
               if s.name not in under_load | {"compress"})
    by = {s.name: s for s in got}
    assert by["las.xyz"].counts == {"las.read.native": 1}  # the native decoder
    assert by["compress.fetch"].counts == {"fetch": 2}
    assert by["compress.prepare"].counts["upload_bytes"] > 0


def test_stream_extract_spans_in_order(tmp_path):
    tiles = _two_tiles(np.random.default_rng(9))
    paths = []
    for i, t in enumerate(tiles):
        paths.append(str(tmp_path / f"t{i}.las"))
        write_las(make_las(t, scales=[0.001] * 3), paths[-1])
    trace.enable()
    res = stream_extract(paths, capacity=2048, params=_stream_params(), fast=True, wire="f32",
                         device="cpu")
    got = trace.spans()
    consumer = [s for s in got if s.tid == threading.get_native_id()]
    producer = [s for s in got if s.tid != threading.get_native_id()]
    assert names(consumer) == ["stream"] + ["stream.wait", "stream.step"] * 2 + ["stream.wait"]
    assert names(producer) == ["stream.decode", "stream.stage", "stream.stage.stats",
                               "stream.stage.alloc", "stream.stage.fill"] * 2
    fills = [s for s in producer if s.name == "stream.stage.fill"]
    assert all(s.counts == {"upload_bytes": 2048 * 13} for s in fills)
    steps = [s for s in consumer if s.name == "stream.step"]
    tensors = sum(isinstance(v, np.ndarray) for v in res[0][0].values())
    assert all(s.counts["fetch"] <= tensors for s in steps)
    assert all("decode_seconds" not in m and "stage_seconds" not in m for _, m in res)


def test_kernel_counters_count_cuda_calls_only():
    from pointcloudhookup_tpu_torch.ops.kernels import segscan

    before = trace.counter("kernel.segmented_scan")
    segscan.segmented_scan(torch.ones(8), torch.zeros(8, dtype=torch.bool))
    assert trace.counter("kernel.segmented_scan") == before  # the plain version ran


def _icp_section():
    """Two extracted towers, their member rows and a GIM record of each at
    its box centre (h = z - 25 m, 杆塔高 42 m), in EPSG:4547."""
    from pointcloudhookup_tpu_torch.ops.geo import tm_forward, tm_inverse

    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2))
    pts, _ = synthetic_corridor(np.random.default_rng(10), n_ground=4000, n_veg=0,
                                towers=((0.0, 0.0), (150.0, 20.0)), pts_per_tower=400,
                                extent=250.0, origin=(e0, n0, 80.0))
    params = ExtractParams(cluster=ClusterParams(eps=5.0, min_points=30, auto_grid_threshold=1000))
    towers, stats, _ = pipeline.extract_from_points(pts, params, device="cpu")
    labels = stats["labels"][: len(pts)]
    records = []
    for i, t in enumerate(towers):
        lon, lat = (float(v) for v in tm_inverse(t.center[0], t.center[1]))
        records.append(dict(lat=lat, lng=lon, h=float(t.center[2]) - 25.0, r=5.0,
                            properties={"杆塔编号": f"P{i}", "杆塔高": "42.0"}))
    return towers, [pts[labels == t.label] for t in towers], records


def test_correct_icp_spans_and_counters():
    towers, clouds, records = _icp_section()
    keys = ("icp.sweeps", "icp.towers", "upload_bytes", "fetch")
    before = {k: trace.counter(k) for k in keys}
    trace.enable()
    res = pipeline.correct(records, towers, icp=True, pc_clouds=clouds, device="cpu")
    trace.disable()
    got = trace.spans()
    assert len(res.pairs) == len(towers) == 2
    stage = ["icp.stage", "icp.pack", "icp.upload", "icp.solve", "icp.fetch"]
    assert names(got) == ["gim.correct", "icp.refine"] + stage * 3
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    (correct,), (refine,) = by["gim.correct"], by["icp.refine"]
    assert refine.parent == correct.id
    assert all(s.parent == refine.id for s in by["icp.stage"])
    stages = {s.id for s in by["icp.stage"]}
    for name in stage[1:]:
        assert len(by[name]) == 3 and all(s.parent in stages for s in by[name])
    assert refine.counts == {"icp.towers": 2}
    assert [s.counts for s in by["icp.solve"]] == [{"icp.sweeps": 11}] * 3
    assert [s.counts for s in by["icp.fetch"]] == [{"fetch": 4}] * 3  # R, t, rmse, inlier share
    # a stage uploads the padded batch: 280 frame rows and the largest
    # cloud, f32 xyz and a bool mask a row
    batch = 13 * 2 * (280 + max(len(c) for c in clouds))
    assert [s.counts for s in by["icp.upload"]] == [{"upload_bytes": batch}] * 3
    delta = {k: trace.counter(k) - before[k] for k in keys}
    assert delta == {"icp.sweeps": 33, "icp.towers": 2, "upload_bytes": 3 * batch, "fetch": 12}
    # the tracer off: no span, the totals still count
    trace.reset()
    pipeline.correct(records, towers, icp=True, pc_clouds=clouds, device="cpu")
    assert trace.spans() == []
    assert trace.counter("icp.sweeps") - before["icp.sweeps"] == 66
