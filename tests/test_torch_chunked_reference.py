"""``extract`` with per-chunk clustering (``ClusterParams.per_chunk``) of
the port against the benchmark's plain NumPy reference
(``portbench/reference/chunked.py``), on the CPU.

Two seeded corridors of 120,000 rows in flight order (the benchmark cell
``tile4m.chunked`` cut small: 6 towers over 600 m, rows stably sorted by
x) are written as LAS by the cell's entry kind; the port's
``extract_from_points(..., device="cpu")`` clusters them in chunks of 8,192
rows, so a chunk is a ~40 m strip across the corridor and some towers are
cut at a chunk boundary.  Labels and ground flags are equal row for row;
the accepted towers are the same, each within:

* centre within 1e-4 m: the box centre is the float32 projections' mid
  range turned back through the angle, on coordinates of up to ~300 m
  (float32 spacing 3e-5 m), where the reference turns it in float64;
* extents within 1e-4 m, for the same reason;
* north angle within 1e-3 degrees: the port turns the long axis through
  its fused angle, the reference through the angle it projected on
  (1e-7 rad apart);
* member counts equal: they count the labelled rows, equal above.

The same reference in bfloat16 (centred coordinates rounded) breaks at
least one of them.
"""

import copy

import numpy as np
import pytest

from portbench import check as checking
from portbench.drive import extract_params, make_entry
from portbench.harness import resolve
from portbench.reference import chunked as ref

CENTRE_TOL_M = 1e-4
EXTENT_TOL_M = 1e-4
NORTH_TOL_DEG = 1e-3
CHUNK = 8192
SMALL = {"points": 120000, "towers": 6, "extent_m": 300.0, "span_m": 270.0, "sway_m": 20.0,
         "period_m": 125.0}


def small_config(info: dict) -> dict:
    config = copy.deepcopy(info["config"])
    config["tile"].update(SMALL)
    config["params"]["cluster"]["chunk_size"] = CHUNK
    config["distinct_tiles"] = 1
    return config


@pytest.fixture(scope="module", params=[2**31 + 29, 3220000013], ids=["seed_a", "seed_b"])
def tile(request, tmp_path_factory):
    """The port's extraction of one flight-order tile, and the reference in
    float32 and in bfloat16, over the same LAS rows."""
    from pointcloudhookup_tpu_torch.models import pipeline

    info = resolve("tile4m.chunked")
    config = small_config(info)
    entry = make_entry(config, info["traffic"], request.param, "cpu",
                       str(tmp_path_factory.mktemp("chunked")))
    try:
        entry.prepare()
        pts = entry.reference_input(0)
        towers, stats, _ = pipeline.extract_from_points(
            pts, extract_params(config["params"]), device="cpu")
        n = len(pts)
        got = dict(labels=stats["labels"][:n], ground_keep=stats["ground_keep"][:n],
                   towers=entry.form(dict(towers=towers))["towers"])
        return dict(pts=pts, centres=entry.centres[0], got=got, cap=len(stats["labels"]),
                    ref=checking.from_reference(ref.run(pts, config)),
                    low=checking.from_reference(ref.run(pts, config, lower="bfloat16")))
    finally:
        entry.cleanup()


def test_towers_are_cut_at_chunk_boundaries(tile):
    """No cluster spans two chunks, and some planted tower's labelled rows
    fall in two chunks: the fragmentation the per-chunk path keeps."""
    labels = tile["ref"]["labels"]
    chunk = np.arange(len(labels)) // CHUNK
    for lab in np.unique(labels[labels >= 0]):
        assert len(np.unique(chunk[labels == lab])) == 1, lab
    xy = tile["pts"][:, :2]
    cut = 0
    for c in tile["centres"]:
        on = (labels >= 0) & (np.abs(xy - c[:2]).max(axis=1) <= 6.0)
        cut += len(np.unique(chunk[on])) >= 2
    assert cut >= 1
    assert tile["cap"] % CHUNK == 0 and tile["cap"] >= len(labels)


def test_labels_and_ground_flags_equal_row_for_row(tile):
    got, r = tile["got"], tile["ref"]
    assert np.array_equal(got["ground_keep"], r["ground_keep"])
    assert np.array_equal(got["labels"], r["labels"])
    assert r["labels"].max() + 1 > len(r["towers"])  # fragments: clusters beyond the towers


def test_towers_within_tolerance(tile):
    got, r = tile["got"]["towers"], tile["ref"]["towers"]
    assert set(got) == set(r) and len(r) >= 5
    for i in r:
        tied = checking.nearest_tie(got[i], r[i])
        assert np.linalg.norm(got[i]["center"] - tied["center"]) <= CENTRE_TOL_M, i
        assert np.abs(got[i]["extent"] - tied["extent"]).max() <= EXTENT_TOL_M, i
        assert abs((got[i]["north"] - tied["north"] + 180.0) % 360.0 - 180.0) <= NORTH_TOL_DEG, i
        assert got[i]["count"] == r[i]["count"], i


def test_bfloat16_breaks_a_tolerance(tile):
    r, low = tile["ref"], tile["low"]
    nums = checking.compare(low, r)
    assert (nums["label_mismatch"] > 0 or nums["ground_mismatch"] > 0
            or nums["centre_gap_m"] > CENTRE_TOL_M or nums["extent_gap_m"] > EXTENT_TOL_M
            or nums["north_gap_deg"] > NORTH_TOL_DEG or nums["count_gap"] > 0)
