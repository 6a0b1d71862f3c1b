"""What decides ``correct``: the program passes, the control (the
reference one precision lower in the program's place) fails, and a run
with the timed path broken underneath reads correct false.  On the CPU at
small sizes (portbench/tests/small.py); control.py takes the same readings
on the card at the cells' own sizes."""

import numpy as np
import pytest

from portbench import control, harness
from portbench.tests.small import small_info

CELLS = ("tile4m.extract", "stream1m.las", "tile4m.run_all")


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload, tmp_path):
    r = control.readings(workload, 2**31 + 7, device="cpu", info=small_info(workload),
                         workdir=str(tmp_path))
    assert r["program"]["ok"], r["program"]
    assert not r["control"]["ok"], r["control"]


def _altered_tower(monkeypatch):
    from pointcloudhookup_tpu_torch.models import pipeline

    inner = pipeline.towers_from_stats

    def shifted(stats, origin):
        towers = inner(stats, origin)
        towers[0].center = towers[0].center + np.array([0.5, 0.0, 0.0])
        return towers
    monkeypatch.setattr(pipeline, "towers_from_stats", shifted)


def _half_tile(monkeypatch):
    from pointcloudhookup_tpu_torch.models import pipeline

    inner = pipeline.read_las

    def half(path):
        las = inner(path)
        las.points = las.points[: len(las.points) // 2]
        return las
    monkeypatch.setattr(pipeline, "read_las", half)


def _stale_answer(monkeypatch):
    from pointcloudhookup_tpu_torch.models import pipeline

    inner, first = pipeline.extract_from_points, []

    def stale(*args, **kwargs):
        if not first:
            first.append(inner(*args, **kwargs))
        return first[0]
    monkeypatch.setattr(pipeline, "extract_from_points", stale)


def _stream_altered(monkeypatch):
    from pointcloudhookup_tpu_torch.ops import frontend_fused

    inner = frontend_fused.fused_extract_step

    def shifted(*args, **kwargs):
        out = inner(*args, **kwargs)
        out["center"] = out["center"] + 0.5
        return out
    monkeypatch.setattr(frontend_fused, "fused_extract_step", shifted)


def _stream_half(monkeypatch):
    from pointcloudhookup_tpu_torch.core import streaming

    inner = streaming.stream_extract

    def half(sources, *args, **kwargs):
        return inner(list(sources)[: len(sources) // 2], *args, **kwargs)
    monkeypatch.setattr(streaming, "stream_extract", half)


def _stream_stale(monkeypatch):
    from pointcloudhookup_tpu_torch.ops import frontend_fused

    inner, first = frontend_fused.fused_extract_step, []

    def stale(*args, **kwargs):
        if not first:
            first.append(inner(*args, **kwargs))
        return first[0]
    monkeypatch.setattr(frontend_fused, "fused_extract_step", stale)


def _altered_blha(monkeypatch):
    from pointcloudhookup_tpu_torch.models import pipeline

    inner = pipeline.save_gim

    def shifted(folder, rows, *args, **kwargs):
        rows = [dict(r, 纬度=r["纬度"] + 1e-5) if i == 0 else r for i, r in enumerate(rows)]
        return inner(folder, rows, *args, **kwargs)
    monkeypatch.setattr(pipeline, "save_gim", shifted)


FAULTS = [
    ("tile4m.extract", _altered_tower),  # an answer altered where it is produced
    ("tile4m.extract", _half_tile),      # half of the batch left out
    ("tile4m.extract", _stale_answer),   # a step that returns its state unchanged
    ("stream1m.las", _stream_altered),
    ("stream1m.las", _stream_half),
    ("stream1m.las", _stream_stale),
    ("tile4m.run_all", _altered_blha),
    ("tile4m.run_all", _half_tile),
    ("tile4m.run_all", _stale_answer),
]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_timed_path_reads_not_correct(workload, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    result = harness.run_cell(workload, 11, 0.5, False, device="cpu", info=small_info(workload),
                              workdir=str(tmp_path))
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_reads_correct(workload, tmp_path):
    result = harness.run_cell(workload, 12, 0.2, False, device="cpu", info=small_info(workload),
                              workdir=str(tmp_path))
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
