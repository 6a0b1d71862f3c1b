"""Geoid grids and the elevation report of the port against the JAX
package: .gtx / .npz round trips, ``GeoidGrid.interp`` on host floats
bit-equal to the JAX package's numpy branch, and the CSV (written with the
csv module, pandas' bytes) and text report byte-equal.  Also the properties
of the geoid half of tests/test_viz_and_validate.py and of
tests/test_streaming_and_reports.py's report tests."""

import numpy as np
import pytest

from pointcloudhookup_tpu.io import geoid as jgeoid
from pointcloudhookup_tpu.models import elevation_report as jrep
from pointcloudhookup_tpu.ops.geo import GeoidGrid as JGrid
from pointcloudhookup_tpu_torch.io import geoid
from pointcloudhookup_tpu_torch.models import elevation_report as rep
from pointcloudhookup_tpu_torch.ops.geo import GeoidGrid


def _grids():
    rng = np.random.default_rng(0)
    regional = dict(lat0=27.5, lon0=112.75, dlat=0.25, dlon=0.25,
                    values=rng.normal(-20, 3, (9, 13)).astype(np.float32))
    world = dict(lat0=-90.0, lon0=-180.0, dlat=0.25, dlon=0.25,
                 values=np.tile(np.linspace(0, 100, 1440), (721, 1)).astype(np.float32))
    return {"regional": regional, "global": world}


@pytest.mark.parametrize("kind", ["regional", "global"])
def test_interp_bit_equal(kind):
    g = _grids()[kind]
    mine, theirs = GeoidGrid(**g), JGrid(**g)
    rng = np.random.default_rng(1)
    lat = rng.uniform(g["lat0"] - 1, g["lat0"] + g["dlat"] * g["values"].shape[0] + 1, 400)
    lon = rng.uniform(-200, 380, 400) if kind == "global" else rng.uniform(112, 116.5, 400)
    for a, b in zip(lat, lon):
        got = float(mine.interp(float(a), float(b)))
        ref = float(theirs.interp(float(a), float(b), np))
        assert got == ref or (np.isnan(got) and np.isnan(ref))
    assert np.array_equal(mine.interp(lat, lon), theirs.interp(lat, lon, np))


def test_gtx_and_npz_round_trips(tmp_path):
    g = _grids()["regional"]
    geoid.save_gtx(GeoidGrid(**g), str(tmp_path / "t.gtx"))
    jgeoid.save_gtx(JGrid(**g), str(tmp_path / "j.gtx"))
    assert (tmp_path / "t.gtx").read_bytes() == (tmp_path / "j.gtx").read_bytes()
    back, ref = geoid.load_gtx(str(tmp_path / "t.gtx")), jgeoid.load_gtx(str(tmp_path / "t.gtx"))
    assert (back.lat0, back.lon0, back.dlat, back.dlon) == (ref.lat0, ref.lon0, ref.dlat,
                                                            ref.dlon)
    assert back.values.dtype == np.float32 and np.array_equal(back.values, g["values"])
    assert geoid.load_geoid(str(tmp_path / "t.gtx")).lat0 == 27.5

    lat, lon = np.linspace(-90, 90, 721), np.linspace(-180, 180, 1441)
    vals = (np.zeros((721, 1441)) + 25.0 + np.linspace(0, 1, 1441)).astype(np.float32)
    np.savez(str(tmp_path / "egm.npz"), lat=lat, lon=lon, geoid=vals)
    got, ref = geoid.load_npz(str(tmp_path / "egm.npz")), jgeoid.load_npz(str(tmp_path / "egm.npz"))
    assert (got.lat0, got.lon0, got.dlat, got.dlon) == (ref.lat0, ref.lon0, ref.dlat, ref.dlon)
    assert np.array_equal(got.values, ref.values)
    assert geoid.check_grid_effective(got) == jgeoid.check_grid_effective(ref)
    effective, mean_n = geoid.check_grid_effective(got)
    assert effective and abs(mean_n - 25.8) < 0.1
    with pytest.raises(ValueError, match="unknown geoid grid format"):
        geoid.load_geoid(str(tmp_path / "g.tif"))


def test_grid_not_effective_and_longitude_wrap():
    g = GeoidGrid(0.0, 0.0, 1.0, 1.0, np.zeros((10, 10), np.float32))
    assert geoid.check_grid_effective(g, sample_points=[(2.0, 3.0), (4.0, 5.0)]) == (False, 0.0)
    world = GeoidGrid(**_grids()["global"])
    assert abs(float(world.interp(40.0, -74.0)) - float(world.interp(40.0, 286.0))) < 1e-4


def _towers(rng, k):
    return [dict(id=f"P{41 + i}", lat=float(rng.uniform(27.8, 29.2)),
                 lon=float(rng.uniform(112.9, 115.6)), h=float(rng.uniform(40, 300)))
            for i in range(k)]


@pytest.mark.parametrize("with_grid", [True, False])
def test_report_bytes_equal(tmp_path, with_grid):
    """convert_to_orthometric's rows equal; the CSV and the text report are
    the JAX package's bytes; the chart is written where matplotlib is."""
    g = _grids()["regional"]
    towers = _towers(np.random.default_rng(2), 7) + [dict(id="", lat=28.0, lon=113.5, h=0.1)]
    kw = dict(geoid=GeoidGrid(**g) if with_grid else None, empirical_n=27.25)
    rows = rep.convert_to_orthometric(towers, **kw)
    ref_rows = jrep.convert_to_orthometric(
        towers, **dict(kw, geoid=JGrid(**g) if with_grid else None))
    assert [vars(r) for r in rows] == [vars(r) for r in ref_rows]
    assert rows[0].method == ("geoid_grid" if with_grid else "empirical_n")
    out = {}
    for tag, mod, rr in (("t", rep, rows), ("j", jrep, ref_rows)):
        out[tag] = mod.write_report(rr, csv_path=str(tmp_path / f"{tag}.csv"),
                                    text_path=str(tmp_path / f"{tag}.txt"),
                                    chart_path=str(tmp_path / f"{tag}.png"))
    assert out["t"] == out["j"] and "N statistics" in out["t"]
    for ext in ("csv", "txt"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    assert (tmp_path / "t.png").exists()


def test_report_edge_cases_bytes_equal(tmp_path):
    """No rows (pandas writes an empty header line), NaN heights (empty
    fields), ids that need quoting, and a grid of zeros (the warning)."""
    cases = {
        "empty": [],
        "odd": [dict(id='a,"b"', lat=1e-5, lon=1e16, h=float("nan")),
                dict(id=7, lat=-0.0, lon=0.1 + 0.2, h=1.0)],
    }
    for name, towers in cases.items():
        for tag, mod in (("t", rep), ("j", jrep)):
            rows = mod.convert_to_orthometric(towers)
            mod.write_report(rows, csv_path=str(tmp_path / f"{name}{tag}.csv"),
                             text_path=str(tmp_path / f"{name}{tag}.txt"))
        for ext in ("csv", "txt"):
            assert ((tmp_path / f"{name}t.{ext}").read_bytes()
                    == (tmp_path / f"{name}j.{ext}").read_bytes()), (name, ext)
    zero = GeoidGrid(0.0, 0.0, 1.0, 1.0, np.zeros((10, 10), np.float32))
    report = rep.write_report(rep.convert_to_orthometric(
        [dict(id="X", lat=5.0, lon=5.0, h=50.0)], geoid=zero))
    assert "not in effect" in report
    grid = GeoidGrid(20.0, 100.0, 1.0, 1.0, np.full((21, 21), 23.5, np.float32))
    rows = rep.convert_to_orthometric([dict(id="P41", lat=28.1, lon=113.2, h=100.0)], geoid=grid)
    assert abs(rows[0].h_orthometric - 76.5) < 1e-5


def test_no_pandas_or_matplotlib_needed(tmp_path, monkeypatch):
    """The CSV and text report are written with pandas and matplotlib
    unimportable; the chart is then skipped, as a best-effort extra."""
    import builtins

    real_import = builtins.__import__

    def refuse(name, *args, **kwargs):
        if name.split(".")[0] in ("pandas", "matplotlib"):
            raise ImportError(f"no {name} here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", refuse)
    rows = rep.convert_to_orthometric(_towers(np.random.default_rng(3), 3))
    rep.write_report(rows, csv_path=str(tmp_path / "r.csv"), text_path=str(tmp_path / "r.txt"),
                     chart_path=str(tmp_path / "r.png"))
    assert (tmp_path / "r.csv").read_text().startswith("tower_id,lat,lon")
    assert (tmp_path / "r.txt").exists() and not (tmp_path / "r.png").exists()
