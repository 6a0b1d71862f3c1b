"""The last line's keys, the run's refusal without a card, and the card
run itself (marked ``cuda``: skips here)."""

import json
import os
import subprocess
import sys

from portbench import harness
from portbench.tests.small import small_info

import pytest

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_last_line_has_the_contract_keys(tmp_path):
    r = harness.run_cell("tile4m.extract", 3, 0.2, False, device="cpu",
                         info=small_info("tile4m.extract"), workdir=str(tmp_path))
    assert list(r) == KEYS + ["check"]  # the numbers compared come last
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(r["metrics"]) == {"mpts_per_s", "tile_ms_p95", "peak_device_mib", "setup_s"}
    for v in r["check"].values():
        assert set(v) == {"value", "limit"}
    json.loads(json.dumps(r, allow_nan=False))


def test_traced_line_adds_busy_window_and_breakdown(tmp_path):
    r = harness.run_cell("stream1m.las", 3, 0.2, True, device="cpu",
                         info=small_info("stream1m.las"), workdir=str(tmp_path))
    assert list(r) == KEYS + ["breakdown", "check"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    assert "stream_step_ms" in r["metrics"]  # read from meta["step_seconds"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(harness.ROOT, "portbench", "run.py"),
                          "--workload", "tile4m.extract", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, env=env,
                         cwd=harness.ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_only_benchmark_files_is_no_run(tmp_path):
    import shutil

    shutil.copytree(os.path.join(harness.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tile4m.extract",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_tile_on_the_card(card, tmp_path):
    r = harness.run_cell("tile4m.extract", 5, 0.1, False, device="cuda", workdir=str(tmp_path))
    assert r["correct"] and r["device"]["platform"] == "gpu"
