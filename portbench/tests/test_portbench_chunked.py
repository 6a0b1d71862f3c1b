"""The cell tile4m.chunked: it resolves by name, its entry kind writes
tiles in flight order, and on the CPU at a small size the program passes
the per-chunk reference, the control fails it, and a traced run reads the
cell's program metrics."""

import numpy as np
import pytest

from portbench import control, harness, lasio
from portbench.drive import make_entry
from portbench.tests.small import shrink

CELL = "tile4m.chunked"
SMALL = {"tile.points": 120000, "tile.towers": 6, "tile.extent_m": 300.0,
         "tile.span_m": 270.0, "tile.sway_m": 20.0, "tile.period_m": 125.0,
         "params.cluster.chunk_size": 8192, "distinct_tiles": 1}
METRICS = ("chunk_cluster_ms", "chunk_cluster_device_ms", "sort_obb_device_ms", "dedup_rounds")


def small_chunked_info() -> dict:
    info = harness.resolve(CELL)
    info["config"] = shrink(info["config"], SMALL)
    return info


def test_the_cell_resolves_to_its_files():
    info = harness.resolve(CELL)
    assert info["config"]["name"] == "corridor_tile_4m_chunked"
    assert info["config"]["reference"] == "chunked" and info["traffic"]["entry"] == "extract_flight"
    cluster = info["config"]["params"]["cluster"]
    assert cluster["per_chunk"] and cluster["chunk_size"] == 50000
    assert (cluster["eps"], cluster["min_points"]) == (8.0, 80)
    assert {m["name"] for m in info["end_to_end"]} == {"mpts_per_s", "peak_device_mib", "setup_s"}
    layers = {m["name"]: m for m in info["per_layer"]}
    for name in METRICS:
        assert layers[name]["workloads"] == [CELL]
        assert info["modules"][name].LAYER == layers[name]["layer"]
    assert set(info["config"]["check"]) == set(info["config"]["check_why"])


def test_flight_order_rows_are_non_decreasing_in_x(tmp_path):
    info = small_chunked_info()
    info["config"]["distinct_tiles"] = 2
    entry = make_entry(info["config"], info["traffic"], 2**31 + 3, "cpu", str(tmp_path))
    try:
        entry.prepare()
        for t, path in enumerate(entry.paths):
            xyz = lasio.read_las(path)
            assert len(xyz) == entry.n_points[t] == SMALL["tile.points"]
            assert np.all(np.diff(xyz[:, 0]) >= 0)
            assert np.array_equal(xyz, entry.reference_input(t))
    finally:
        entry.cleanup()


@pytest.mark.parametrize("seed", [2**31 + 7, 3220000101])
def test_program_passes_and_control_fails(seed, tmp_path):
    r = control.readings(CELL, seed, device="cpu", info=small_chunked_info(),
                         workdir=str(tmp_path))
    assert r["program"]["ok"], r["program"]
    assert r["program"]["worst"]["label_mismatch"] == 0
    assert not r["control"]["ok"], r["control"]


def test_traced_run_reads_the_program_metrics(tmp_path):
    """On the CPU: the program's span and counter are read, the device
    times are not (no device trace)."""
    r = harness.run_cell(CELL, 11, 0.5, True, device="cpu", workdir=str(tmp_path),
                         info=small_chunked_info())
    assert r["correct"] is True
    got = r["metrics"]
    assert got["chunk_cluster_ms"]["value"] > 0 and got["dedup_rounds"]["value"] >= 1
    assert "chunk_cluster_device_ms" not in got and "sort_obb_device_ms" not in got
    assert "exact_graph_device_ms" not in got and "las_load_ms" in got
