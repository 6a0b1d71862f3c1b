"""BENCHMARK.json against the benchmark's contract, and a cell, a mix, a
configuration and a per-layer metric added as new files only."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_entries_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    names = []
    for section, allowed in keys.items():
        for e in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert set(e) - extra == allowed, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


def test_metrics_units_bounds_and_sources():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    info = harness.resolve(workload)
    reported = {m["name"] for m in info["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and info["per_layer"]
    for m in info["per_layer"]:
        mod = info["modules"][m["name"]]
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
        assert m["moves"] in reported
    assert info["config"]["name"] == info["cell"]["config"]
    for n in ("label_mismatch", "centre_gap_m", "count_gap"):
        assert n in info["config"]["check"]
    for key in {c["name"]: c for c in BENCH["configs"]}[info["cell"]["config"]]["reduced"]:
        assert key in info["config"]["reduced"]


NEW_METRIC = '''"""Throwaway: requests completed in the window."""

LAYER = "harness requests"
UNIT = "n"
MOVES = "mpts_per_s"


def read(window):
    return float(len(window.requests))
'''

NEW_ENTRY = '''"""Throwaway entry kind: extract() on the distinct tiles in reverse."""

from portbench.entries.extract import ExtractEntry


class Reversed(ExtractEntry):
    def request(self, i):
        return super().request(len(self.paths) - 1 - i % len(self.paths))


ENTRY = Reversed
'''


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A configuration, an entry kind, a mix, a per-layer metric and a cell,
    each a new file or a new BENCHMARK.json entry in a copy; no existing
    file or entry is edited.  The copy runs the cell (on the CPU, at a
    small size): it reports the new metric, and the existing host-span
    metrics that apply to it although their entries do not name it."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    from portbench.tests.small import SMALL, shrink

    config = shrink(json.load(open(os.path.join(ROOT, "portbench/configs/corridor_tile_4m.json"))),
                    SMALL["tile4m.extract"])
    config["name"] = "tiny_tile"
    (root / "portbench/configs/tiny_tile.json").write_text(json.dumps(config))
    (root / "portbench/entries/extract_reversed.py").write_text(NEW_ENTRY)
    (root / "portbench/traffic/reversed_las.json").write_text(json.dumps(
        {"entry": "extract_reversed", "why": "a test"}))
    (root / "portbench/metrics/requests_done.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "tiny_tile", "source": "a test", "reduced": [],
                             "file": "portbench/configs/tiny_tile.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny.reversed", "config": "tiny_tile",
                               "traffic": "reversed_las", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_done", "unit": "n", "better": "higher",
                               "source": "host_clock", "layer": "harness requests",
                               "moves": "mpts_per_s", "workloads": ["tiny.reversed"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(1, sys.argv[2]);"
            "from portbench import harness;"
            "r = harness.run_cell('tiny.reversed', 9, 0.5, True, device='cpu', root=sys.argv[1]);"
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code, str(root), ROOT], capture_output=True,
                         text=True, timeout=600, cwd=str(root))
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["requests_done"]["value"] >= 1
    for shared in ("las_read_ms", "extract_points_ms"):
        assert "tiny.reversed" not in {m["name"]: m for m in bench["per_layer"]}[shared]["workloads"]
        assert result["metrics"][shared]["value"] > 0
    assert "stream_step_ms" not in result["metrics"]  # nothing of the stream to read
