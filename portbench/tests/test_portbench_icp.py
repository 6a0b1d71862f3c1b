"""The cell icp50.correct on the CPU at a small size: its sections of 5
towers of ~2,200 member rows (its own shrink; small.py is the other
cells'), what decides its ``correct``, the count behind ``icp_roofline``
and what its reference loads."""

import numpy as np
import pytest

from portbench import control, harness
from portbench.entries.icp import stage_sweeps
from portbench.metrics import icp_roofline
from portbench.roofline import F32_FLOPS_PER_S, HBM_BYTES_PER_S
from portbench.tests.small import shrink
from portbench.tests.test_portbench_imports import FORBIDDEN, loaded_top_level

CELL = "icp50.correct"
SMALL_ICP = {"tile.points": 150000, "tile.towers": 5, "tile.extent_m": 300.0,
             "tile.span_m": 270.0, "tile.sway_m": 20.0, "tile.period_m": 125.0,
             "params.cluster.auto_grid_threshold": 1000, "params.cluster.max_cells": 4096}


def small_icp_info() -> dict:
    info = harness.resolve(CELL)
    info["config"] = shrink(info["config"], SMALL_ICP)
    return info


def test_program_passes_and_control_fails(tmp_path):
    r = control.readings(CELL, 2**31 + 7, device="cpu", info=small_icp_info(),
                         workdir=str(tmp_path))
    assert r["program"]["ok"], r["program"]
    assert not r["control"]["ok"], r["control"]


def _moved_centre(monkeypatch):
    from pointcloudhookup_tpu_torch.models import refine

    inner = refine.refine_tower_centers

    def moved(*args, **kwargs):
        out = inner(*args, **kwargs)
        first = min(out)
        out[first] = dict(out[first], center=out[first]["center"] + np.array([0.5, 0.0, 0.0]))
        return out
    monkeypatch.setattr(refine, "refine_tower_centers", moved)


def _half_dropped(monkeypatch):
    from pointcloudhookup_tpu_torch.models import refine

    inner = refine.refine_tower_centers

    def half(*args, **kwargs):
        out = inner(*args, **kwargs)
        return {k: out[k] for k in sorted(out)[: len(out) // 2]}
    monkeypatch.setattr(refine, "refine_tower_centers", half)


def _unrefined(monkeypatch):
    from pointcloudhookup_tpu_torch.models import refine

    inner = refine.refine_tower_centers

    def box_centres(towers, *args, **kwargs):
        out = inner(towers, *args, **kwargs)
        return {pi: dict(r, center=np.asarray(towers[pi].center, np.float64),
                         shift=np.zeros(3)) for pi, r in out.items()}
    monkeypatch.setattr(refine, "refine_tower_centers", box_centres)


FAULTS = [_moved_centre,  # an answer altered where it is produced
          _half_dropped,  # half of the batch left out
          _unrefined]     # a step that returns its state unchanged


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_a_broken_timed_path_reads_not_correct(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    result = harness.run_cell(CELL, 11, 0.5, False, device="cpu", info=small_icp_info(),
                              workdir=str(tmp_path))
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_a_sound_run_reads_correct(tmp_path):
    result = harness.run_cell(CELL, 12, 0.2, False, device="cpu", info=small_icp_info(),
                              workdir=str(tmp_path))
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"mpts_per_s", "peak_device_mib", "setup_s"}


def test_a_traced_run_reads_the_host_spans(tmp_path):
    """On the CPU the trace holds no device time: the program's spans and
    counters read, the device metrics do not."""
    result = harness.run_cell(CELL, 13, 0.2, True, device="cpu", info=small_icp_info(),
                              workdir=str(tmp_path))
    got = result["metrics"]
    assert result["correct"] is True
    for name in ("icp_ms", "icp_pack_ms", "icp_solve_ms", "upload_mib", "fetches"):
        assert got[name]["value"] > 0, name
    assert got["icp_ms"]["value"] > got["icp_solve_ms"]["value"] + got["icp_pack_ms"]["value"]
    assert got["fetches"]["value"] == 12  # R, t, rmse and inlier share, a stage
    assert "icp_device_ms" not in got and "icp_roofline" not in got


def test_roofline_count_by_hand():
    meta = dict(pairs=[(280, 1000), (280, 500)], sweeps=stage_sweeps(30))
    assert meta["sweeps"] == [11, 11, 11]
    ops = 33 * 6 * 280 * (1000 + 500)  # three FMAs a (frame row, member row) pair
    nbytes = 33 * (12 * (280 + 1000) + 12 * (280 + 500) + 8 * 2 * 280)
    want = max(ops / F32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    assert icp_roofline.request_bound_s(meta) == pytest.approx(want, rel=1e-12)
    assert ops / F32_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S  # bound by operations


def test_a_request_records_the_roofline_meta(tmp_path):
    from portbench.drive import make_entry

    info = small_icp_info()
    entry = make_entry(info["config"], info["traffic"], 14, "cpu", str(tmp_path))
    try:
        entry.prepare()
        req = entry.request(0)
        s = entry.sections[0]
        (meta,) = req.meta
        pairs = req.outputs[0]["result"].pairs
        assert meta["pairs"] == [(280, len(s["clouds"][pi])) for _, pi in pairs]
        assert req.points == sum(len(c) for c in s["clouds"])
        assert len(pairs) == 5
    finally:
        entry.cleanup()


def test_the_icp_reference_loads_nothing_of_the_program():
    names = loaded_top_level("import portbench.reference.icp, portbench.entries.icp")
    ref = loaded_top_level("import portbench.reference.icp")
    assert not names & FORBIDDEN, names & FORBIDDEN
    assert not ref & (FORBIDDEN | {"pointcloudhookup_tpu_torch"}), ref
