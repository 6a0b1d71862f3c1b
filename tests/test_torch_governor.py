"""The port's resource governor (``core/governor.py``), mirroring
``tests/test_governor.py`` with the same monkeypatching.  The JAX module's
TPU memory table is gone: a CUDA device reports through
``torch.cuda.mem_get_info`` (faked here, so the tests need no card) and the
CPU takes a fixed 8 GiB, as the JAX module's ``cpu`` entry does."""

import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.core import governor as jgovernor
from pointcloudhookup_tpu_torch.core import governor


def _fake_cuda(monkeypatch, free, reserved=0):
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: reserved)


def test_host_available_bytes_positive():
    assert governor.host_available_bytes() > (1 << 28)


def test_device_memory_of_the_cpu():
    assert governor.device_memory_bytes("cpu") == 8 << 30
    assert governor.device_memory_bytes(torch.device("cpu")) == jgovernor._HBM_BY_KIND["cpu"]


def test_device_memory_from_mem_get_info(monkeypatch):
    _fake_cuda(monkeypatch, 7 << 30, reserved=1 << 30)
    assert governor.device_memory_bytes("cuda:0") == 8 << 30


def test_auto_capacity_scales_with_ram(monkeypatch):
    _fake_cuda(monkeypatch, 16 << 30)
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 4 << 30)
    small = governor.auto_capacity(device="cuda")
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 64 << 30)
    big = governor.auto_capacity(device="cuda")
    assert small < big
    assert small in governor._LADDER and big in governor._LADDER
    assert small * governor.HOST_BYTES_PER_POINT * 2 <= (4 << 30) * 0.31


def test_auto_capacity_respects_device_budget(monkeypatch):
    _fake_cuda(monkeypatch, 1 << 30)
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 256 << 30)
    cap = governor.auto_capacity(device="cuda")
    assert cap * governor.DEVICE_BYTES_PER_POINT <= (1 << 30) * 0.61


def test_auto_capacity_hard_cap_and_small_input(monkeypatch):
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 64 << 30)
    assert governor.auto_capacity(device="cpu", hard_cap=2_000_000) <= 2_000_000
    cap = governor.auto_capacity(device="cpu", n_points=20_000)
    assert cap >= 20_000
    assert cap == min(v for v in governor._LADDER if v >= 20_000)


def test_auto_chunk_size_reference_ladder(monkeypatch):
    for gib, want in ((4, 500_000), (8, 1_000_000), (16, 2_000_000), (64, 8_000_000)):
        monkeypatch.setattr(governor, "host_available_bytes", lambda g=gib: g << 30)
        monkeypatch.setattr(jgovernor, "host_available_bytes", lambda g=gib: g << 30)
        assert governor.auto_chunk_size() == want == jgovernor.auto_chunk_size()


def test_budget_reason_string(monkeypatch):
    b = governor.budget(device="cpu")
    assert b.capacity >= governor._LADDER[0]
    assert "capacity" in b.reason
    # the same budget and wording as the JAX module on the same memory
    monkeypatch.setattr(governor, "host_available_bytes", lambda: 32 << 30)
    monkeypatch.setattr(jgovernor, "host_available_bytes", lambda: 32 << 30)
    monkeypatch.setattr(jgovernor, "DEVICE_BYTES_PER_POINT", governor.DEVICE_BYTES_PER_POINT)
    monkeypatch.setattr(jgovernor, "HOST_BYTES_PER_POINT", governor.HOST_BYTES_PER_POINT)

    class CpuDev:
        device_kind = "cpu"

        def memory_stats(self):
            return None

    got = governor.budget(device="cpu", hard_cap=3_000_000)
    ref = jgovernor.budget(device=CpuDev(), hard_cap=3_000_000)
    assert (got.capacity, got.chunk_size, got.reason) == (ref.capacity, ref.chunk_size, ref.reason)


def test_estimate_points_from_las_header(tmp_path):
    from pointcloudhookup_tpu_torch.io.las import make_las, peek_point_count, write_las

    pts = np.random.default_rng(0).uniform(0, 100, (1234, 3))
    path = str(tmp_path / "t.las")
    write_las(make_las(pts), path)
    assert peek_point_count(path) == 1234
    assert governor.estimate_points(path) == 1234


def test_tile_streamer_auto_capacity():
    """capacity=None sizes itself and still yields every point once."""
    from pointcloudhookup_tpu_torch.core.streaming import TileStreamer

    pts = np.random.default_rng(1).uniform(0, 50, (3000, 3))
    ts = TileStreamer([pts], capacity=None, device="cpu")
    assert ts.capacity >= 3000
    assert sum(int(mask.sum()) for _, mask, _ in ts) == 3000


@pytest.mark.heavy
def test_stream_extract_governed_runs(rng):
    """stream_extract with no capacity runs end to end."""
    from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams
    from pointcloudhookup_tpu_torch.core.streaming import stream_extract
    from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

    pts, centers = synthetic_corridor(
        rng, n_ground=3000, n_veg=500, pts_per_tower=300, extent=200.0
    )
    params = ExtractParams(cluster=ClusterParams(eps=5.0, min_points=30))
    results = stream_extract([pts], params=params, device="cpu")
    assert len(results) >= 1
    found = sum(int(np.asarray(s["accepted"]).sum()) for s, _ in results)
    assert found >= len(centers) - 1
