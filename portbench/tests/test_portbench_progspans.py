"""The readers of the program's own spans (``progspans.py`` and the metrics
that use it): a synthetic window and span buffer with hand-counted
answers, None where the program has no spans, and a traced CPU run of two
small cells through the harness."""

import importlib
from types import SimpleNamespace

import pytest

from portbench import harness, progspans
from portbench.profiling import Trace
from portbench.tests.small import small_info

NEW = ["extract_prep_ms", "extract_upload_ms", "graph_issue_ms", "stats_fetch_ms",
       "extract_finish_ms", "compress_prep_ms", "compress_fetch_ms", "compress_write_ms",
       "stage_stats_ms", "stage_alloc_ms", "stage_fill_ms", "stream_wait_ms", "ladder_steps",
       "kernel_calls", "upload_mib", "fetches", "idle_explained_pct", "host_offcpu_pct"]
W0 = 100.0  # the window's perf_counter start, s
TRACE_T0 = 5e6  # its pb:window range on the trace's clock, us


def _span(id_, name, parent, tid, t0, t1, cpu, counts=None):
    return SimpleNamespace(id=id_, name=name, parent=parent, request=1, tid=tid,
                           t0_ns=round(t0 * 1e9), t1_ns=round(t1 * 1e9),
                           cpu_ns=round(cpu * 1e9), counts=counts)


BUFFER = [
    _span(9, "early", None, 1, 99.0, 99.5, 0.5),  # before the window: left out
    _span(2, "stream.wait", 1, 1, 100.0, 100.5, 0.0),
    _span(5, "stream.stage.stats", 4, 2, 100.0, 100.2, 0.1),
    _span(6, "stream.stage.fill", 4, 2, 100.2, 100.6, 0.4, {"upload_bytes": 2 << 20}),
    _span(4, "stream.stage", 1, 2, 100.0, 100.6, 0.5),
    _span(3, "stream.step", 1, 1, 100.5, 100.9, 0.4, {"kernel.cluster_cells": 3, "fetch": 5}),
    _span(1, "stream", None, 1, 100.0, 101.0, 0.9),
]


def _window(spans=True):
    def at(t):  # perf_counter seconds -> trace microseconds
        return TRACE_T0 + (t - W0) * 1e6

    events = [dict(ph="X", cat="user_annotation", name="pb:window", tid=1, ts=at(W0), dur=1e6)]
    for t0, t1 in ((100.1, 100.2), (100.6, 100.7)):  # the device is busy 0.2 s
        events.append(dict(ph="X", cat="kernel", name="k", tid=7, ts=at(t0), dur=(t1 - t0) * 1e6,
                           args=dict(correlation=1)))
    return SimpleNamespace(spans={"window": [(W0, W0 + 1.0)]} if spans else {},
                           trace=Trace(events), tiles=2, requests=[], kernel_costs=[])


def _read_all(window):
    return {name: importlib.import_module(f"portbench.metrics.{name}").read(window)
            for name in NEW}


def test_every_new_reader_on_a_synthetic_window(monkeypatch):
    monkeypatch.setattr(progspans, "program_buffer", lambda: list(BUFFER))
    window = _window()
    p = progspans.of(window)
    assert [s.name for s in p.spans if s.name == "early"] == []
    assert sorted(s.name for s in p.leaves) == ["stream.stage.fill", "stream.stage.stats",
                                               "stream.step", "stream.wait"]
    assert p.self_ms("stream") == pytest.approx(100.0)  # less wait and step, not the producer's
    idle = p.idle()
    assert idle["idle"] == pytest.approx(0.8e6)
    assert idle["explained"] == pytest.approx(0.7e6)
    assert idle["by_leaf"] == pytest.approx({"stream.wait": 0.4e6, "stream.stage.stats": 0.1e6,
                                             "stream.stage.fill": 0.4e6, "stream.step": 0.3e6})
    got = _read_all(window)
    expect = dict(stage_stats_ms=100.0, stage_fill_ms=200.0, stream_wait_ms=250.0,
                  kernel_calls=1.5, fetches=2.5, upload_mib=1.0, idle_explained_pct=87.5,
                  host_offcpu_pct=10.0)
    for name in NEW:
        if name in expect:
            assert got[name] == pytest.approx(expect[name]), name
        else:  # no such span or counter in this window
            assert got[name] is None, name


@pytest.mark.parametrize("case", ["no_tracer", "empty_buffer", "untraced", "no_window"])
def test_no_program_spans_no_reading(monkeypatch, case):
    monkeypatch.setattr(progspans, "program_buffer",
                        lambda: None if case == "no_tracer" else [] if case == "empty_buffer"
                        else list(BUFFER))
    window = _window(spans=case != "no_window")
    if case == "untraced":
        window.trace = None
    assert set(_read_all(window).values()) == {None}


@pytest.mark.parametrize("workload,present", [
    ("tile4m.extract", ["extract_prep_ms", "extract_upload_ms", "graph_issue_ms",
                        "stats_fetch_ms", "extract_finish_ms", "ladder_steps", "upload_mib",
                        "fetches", "idle_explained_pct", "host_offcpu_pct"]),
    ("stream1m.las", ["stage_stats_ms", "stage_alloc_ms", "stage_fill_ms", "stream_wait_ms",
                      "upload_mib", "fetches", "idle_explained_pct", "host_offcpu_pct"]),
])
def test_a_traced_cpu_run_reads_the_programs_spans(tmp_path, workload, present):
    """The harness's traced run turns the program's tracer on (its profiler),
    and the readers find the spans of the window.  On the CPU no kernel
    function takes its CUDA path and the device never works, so
    kernel_calls stays silent and every idle second is the window's."""
    r = harness.run_cell(workload, 11, 0.2, True, device="cpu", info=small_info(workload),
                         workdir=str(tmp_path))
    got = {n for n in NEW if n in r["metrics"]}
    assert got == set(present)
    m = {n: r["metrics"][n]["value"] for n in got}
    assert m["idle_explained_pct"] > 50.0
    if workload == "tile4m.extract":
        points = small_info(workload)["config"]["tile"]["points"]
        cap = -(-points // 32768) * 32768
        assert m["upload_mib"] == pytest.approx(cap * 13 / 2**20)
        assert m["ladder_steps"] >= 1
