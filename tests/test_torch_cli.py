"""The port's CLI and GIM workflow on the CPU (``--device cpu``), mirroring
``tests/test_cli.py`` on the same 3-tower corridor, and held against the
JAX package where the two must agree to the byte: the compressed LAS
(its centroids are bit-equal on the CPU, tests/test_torch_voxel.py), the
match tables' CSV (``MatchResult.to_csv``, pandas in the JAX package, the
csv module here) and the saved GIM for the same corrected rows."""

import json
import re
import os
import shutil

import numpy as np
import pytest

from pointcloudhookup_tpu.cli import main as jmain
from pointcloudhookup_tpu.io.las import read_las as jread_las
from pointcloudhookup_tpu.models import pipeline as jpipe
from pointcloudhookup_tpu.ops.geo import tm_inverse as jtm_inverse
from pointcloudhookup_tpu_torch.__main__ import main
from pointcloudhookup_tpu_torch.io.las import make_las, read_las, write_las
from pointcloudhookup_tpu_torch.io.synthetic import build_synthetic_gim, synthetic_corridor
from pointcloudhookup_tpu_torch.models import pipeline
from pointcloudhookup_tpu_torch.ops.geo import tm_forward, tm_inverse

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_cli.py's workspace: the corridor at tm_forward(113.5,
    28.2) as a LAS at 0.01 m scale, and a GIM of its three towers (h = z -
    25)."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(3)
    e0, n0 = (float(v) for v in tm_forward(113.5, 28.2))
    pts, centers = synthetic_corridor(
        rng, n_ground=2500, n_veg=400, pts_per_tower=350, extent=200.0,
        origin=(e0, n0, 80.0),
    )
    las = str(tmp / "c.las")
    write_las(make_las(pts, scales=[0.01, 0.01, 0.01]), las)
    gts = []
    for i, c in enumerate(centers):
        lon, lat = tm_inverse(c[0], c[1])
        gts.append(dict(id=f"P{i}", lat=float(lat), lng=float(lon), h=float(c[2]) - 25.0, r=5.0))
    gim = str(tmp / "c.gim")
    build_synthetic_gim(gim, gts, workdir=str(tmp / "tree"))
    return tmp, las, gim, centers


def test_cli_import_pc(workspace, capsys):
    tmp, las, gim, centers = workspace
    main(["import-pc", las] + CPU)
    info = json.loads(capsys.readouterr().out)
    assert info["points"] > 3000 and info["point_format"] == 0
    jmain(["import-pc", las])
    assert info == json.loads(capsys.readouterr().out)


def test_cli_import_gim(workspace, capsys, tmp_path):
    tmp, las, gim, centers = workspace
    main(["import-gim", gim, "--output-folder", str(tmp_path / "o"),
          "--table", str(tmp_path / "t.csv")] + CPU)
    out = capsys.readouterr().out
    assert "P0" in out and "parsed 3 towers" in out
    table = (tmp_path / "t.csv").read_text(encoding="utf-8").splitlines()
    assert table[0].split(",")[:3] == ["系统层级", "系统类型", "经度"]
    assert len(table) == 4
    jmain(["import-gim", gim, "--output-folder", str(tmp_path / "o"),
           "--table", str(tmp_path / "j.csv")])
    ref = capsys.readouterr().out
    assert out.splitlines()[1:-1] == ref.splitlines()[1:-1]  # the towers, in order
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("per_chunk", [False, True], ids=["global", "per-chunk"])
def test_cli_compress_matches_jax_bytes(workspace, capsys, tmp_path, per_chunk):
    tmp, las, gim, centers = workspace
    ds = str(tmp_path / "ds.las")
    extra = ["--per-chunk", "--chunk-size", "1024"] if per_chunk else []
    main(["compress", las, ds, "--voxel-size", "1.0"] + extra + CPU)
    assert "points written" in capsys.readouterr().out
    ref = str(tmp_path / "ref.las")
    jpipe.compress(las, ref, voxel_size=1.0, per_chunk=per_chunk, chunk_size=1024)
    with open(ds, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert 1000 < len(read_las(ds)) < len(read_las(las))


def test_cli_compress_and_extract(workspace, capsys, tmp_path):
    tmp, las, gim, centers = workspace
    ds = str(tmp_path / "ds.las")
    main(["compress", las, ds, "--voxel-size", "0.1"] + CPU)
    assert "points written" in capsys.readouterr().out
    main(["extract", ds, "--eps", "5", "--min-points", "30"] + CPU)
    out = capsys.readouterr().out
    assert out.count("tower_") == len(centers)


def test_cli_correct_save(workspace, capsys, tmp_path):
    tmp, las, gim, centers = workspace
    out_gim = str(tmp_path / "corrected.gim")
    main(["correct", gim, las, "--eps", "5", "--min-points", "30",
          "--output-folder", str(tmp_path / "og"),
          "--save", out_gim, "--csv", str(tmp_path / "r.csv"),
          "--html", str(tmp_path / "r.html")] + CPU)
    out = capsys.readouterr().out
    assert f"{len(centers)} pairs matched" in out
    assert "saved" in out
    assert (tmp_path / "r.html").exists()
    assert os.path.getsize(out_gim) > 776
    main(["match", gim, las, "--eps", "5", "--min-points", "30",
          "--output-folder", str(tmp_path / "om")] + CPU)
    assert f"{len(centers)} pairs matched" in capsys.readouterr().out


def test_cli_missing_file_exit_code(workspace):
    for argv in (["import-pc", "nonexistent.las"],
                 ["compress", "nonexistent.las", "x.las"],
                 ["import-gim", "nonexistent.gim"]):
        with pytest.raises(SystemExit) as e:
            main(argv + CPU)
        assert e.value.code == 2


def test_cli_run_all(workspace, capsys, tmp_path):
    """compress -> extract -> import GIM -> correct -> save: the saved GIM
    keeps the 776-byte header, re-parses, and every tower's BLHA line is
    rewritten to a position within 0.001 deg of the original."""
    tmp, las, gim, centers = workspace
    out_gim = str(tmp_path / "all.gim")
    with pytest.raises(SystemExit) as e:
        main(["run-all", las, gim, out_gim, "--eps", "5", "--min-points", "30",
              "--output-folder", str(tmp_path / "og"),
              "--csv", str(tmp_path / "r.csv")] + CPU)
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert f"{len(centers)} towers corrected" in out
    assert (tmp_path / "r.csv").exists()
    with open(gim, "rb") as f:
        orig_hdr = f.read(776)
    with open(out_gim, "rb") as f:
        new_hdr = f.read(776)
    assert len(new_hdr) == 776 and new_hdr == orig_hdr
    before, _, _ = pipeline.import_gim(gim, str(tmp_path / "reparse_a"))
    after, _, _ = pipeline.import_gim(out_gim, str(tmp_path / "reparse_b"))
    assert len(after) == len(centers)
    b = {r.name: (r.lat, r.lng, r.h) for r in before}
    a = {r.name: (r.lat, r.lng, r.h) for r in after}
    assert set(a) == set(b)
    assert sum(a[k] != b[k] for k in a) == len(centers)
    for k in a:
        assert abs(a[k][0] - b[k][0]) < 0.001 and abs(a[k][1] - b[k][1]) < 0.001


def _results(n_gim, n_pc, pairs, corrected=False):
    """The same MatchResult in both packages, built by their _build_result
    from n_gim GIM records (every third without a tower id) and n_pc
    converted towers."""
    def records(mod):
        from pointcloudhookup_tpu_torch.io.cbm import GimTowerRecord as T
        from pointcloudhookup_tpu.io.cbm import GimTowerRecord as J

        cls = T if mod is pipeline else J
        return [cls(name=f"塔{i}", type="TOWER", lat=28.1 + 1e-3 * i, lng=113.2 + 2e-3 * i,
                    h=50.0 + i, r=3.5 * i,
                    properties=None if i % 3 == 2 else {"杆塔编号": f"P,{i}" if i == 1 else f"P{i}"})
                for i in range(n_gim)]

    def converted(mod):
        return [mod.ConvertedTower(
            id=f"PC-{i + 1}", converted_center=[113.2 + 2e-3 * i, 28.1 + 1e-3 * i, 40.0 + i],
            height=30.0, north_angle=7.25 * i, original_center=[0.0, 0.0, 65.0 + i],
            ellipsoid_height=65.0 + i, orthometric_height=40.0 + i, n_value=25.0,
            height_conversion_applied=True) for i in range(n_pc)]

    return (pipeline._build_result(records(pipeline), converted(pipeline), list(pairs), corrected),
            jpipe._build_result(records(jpipe), converted(jpipe), list(pairs), corrected))


@pytest.mark.parametrize("n_gim,n_pc,pairs", [
    (3, 3, [(0, 0), (1, 1), (2, 2)]),  # same length, every row paired
    (4, 2, [(0, 1), (2, 0)]),  # the right table padded, unpaired GIM rows
    (2, 5, [(0, 3), (1, 3)]),  # the left table padded; one tower paired twice
    (3, 4, [(0, 0), (1, 1), (2, 2)]),  # the left table padded, all its rows paired
    (5, 2, [(0, 0), (1, 1), (2, 0), (3, 1), (4, 0)]),  # the right, all paired
    (0, 3, []),  # no GIM rows
    (2, 0, []),  # no point-cloud rows
    (0, 0, []),
])
def test_match_csv_matches_pandas_bytes(tmp_path, n_gim, n_pc, pairs):
    for corrected in (False, True):
        got, ref = _results(n_gim, n_pc, pairs, corrected)
        got.to_csv(str(tmp_path / "t.csv"))
        ref.to_csv(str(tmp_path / "j.csv"))
        assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
        got.to_html(str(tmp_path / "t.html"))
        ref.to_html(str(tmp_path / "j.html"))
        assert (tmp_path / "t.html").read_bytes() == (tmp_path / "j.html").read_bytes()


def test_save_gim_matches_jax_bytes(workspace, tmp_path):
    """The same corrected rows into two copies of the extracted tree: the
    saved GIM files are identical, at the default level 9 and at level 1."""
    tmp, las, gim, centers = workspace
    recs, folder, _ = pipeline.import_gim(gim, str(tmp_path / "x"))
    jrecs, jfolder, _ = jpipe.import_gim(gim, str(tmp_path / "y"))
    assert [r.name for r in recs] == [r.name for r in jrecs]
    pcs = [pipeline.ConvertedTower(
        id=f"PC-{i}", converted_center=[r.lng + 1e-5, r.lat - 2e-5, r.h + 0.5], height=30.0,
        north_angle=r.r, original_center=[0.0, 0.0, 0.0], ellipsoid_height=0.0,
        orthometric_height=0.0, n_value=25.0, height_conversion_applied=True)
        for i, r in enumerate(recs)]
    res = pipeline._build_result(recs, pcs, [(i, i) for i in range(len(recs))], True)
    for level in (9, 1):
        shutil.rmtree(tmp_path / "x")
        shutil.rmtree(tmp_path / "y")
        recs, folder, _ = pipeline.import_gim(gim, str(tmp_path / "x"))
        jrecs, jfolder, _ = jpipe.import_gim(gim, str(tmp_path / "y"))
        assert pipeline.save_gim(folder, pipeline.corrected_rows_from_result(res, recs),
                                 str(tmp_path / "t.gim"), original_gim_path=gim, level=level)
        assert jpipe.save_gim(jfolder, jpipe.corrected_rows_from_result(res, jrecs),
                              str(tmp_path / "j.gim"), original_gim_path=gim, level=level)
        assert (tmp_path / "t.gim").read_bytes() == (tmp_path / "j.gim").read_bytes()
    assert not pipeline.save_gim(folder, [], str(tmp_path / "t.gim" / "no"), gim)


def test_match_and_correct_match_jax(workspace):
    """match()/correct() on the same towers and records give the JAX
    package's pairs and tables; correct(icp=True) without the member clouds
    raises as the JAX package's does."""
    tmp, las, gim, centers = workspace
    recs, _, _ = pipeline.import_gim(gim, str(tmp / "mc_t"))
    jrecs, _, _ = jpipe.import_gim(gim, str(tmp / "mc_j"))
    towers = pipeline.extract(las, eps=5.0, min_points=30, device="cpu")
    for fn, jfn in ((pipeline.match, jpipe.match), (pipeline.correct, jpipe.correct)):
        got, ref = fn(recs, towers), jfn(jrecs, towers)
        assert got.pairs == ref.pairs and len(got.pairs) == len(centers)
        assert (got.gim_rows, got.pc_rows) == (ref.gim_rows, ref.pc_rows)
    with pytest.raises(ValueError, match="pc_clouds"):
        pipeline.correct(recs, towers, icp=True)
    with pytest.raises(ValueError, match="pc_clouds"):
        jpipe.correct(jrecs, towers, icp=True)


def test_cli_reproject(workspace, capsys, tmp_path):
    """Every point to lon/lat: the f32 deltas on the device path within
    2e-8 deg of the host f64 inverse, then stored at the LAS's 1e-7 deg
    scale (the JAX package's output agrees to one unit of that scale)."""
    tmp, las, gim, centers = workspace
    out = str(tmp_path / "deg.las")
    main(["reproject", las, out] + CPU)
    assert "points reprojected" in capsys.readouterr().out
    src = read_las(las).xyz()
    got = read_las(out)
    lon, lat = tm_inverse(src[:, 0], src[:, 1])
    xyz = got.xyz()
    assert np.abs(xyz[:, 0] - lon).max() < 5e-8 + 2e-8
    assert np.abs(xyz[:, 1] - lat).max() < 5e-8 + 2e-8
    np.testing.assert_array_equal(xyz[:, 2], src[:, 2])
    assert got.vlr_bytes == read_las(las).vlr_bytes
    ref = str(tmp_path / "ref.las")
    jpipe.reproject_las(las, ref)
    rxyz = jread_las(ref).xyz()
    assert np.abs(xyz - rxyz).max() <= 1.5e-7
    jlon, _ = jtm_inverse(src[:, 0], src[:, 1], xp=np)
    np.testing.assert_array_equal(lon, jlon)


def test_cli_reproject_matches_jax_bytes(workspace, tmp_path):
    """The f32 deltas round as XLA:CPU's fused multiply-adds, so the
    reprojected LAS is the JAX package's to the byte."""
    tmp, las, gim, centers = workspace
    out, ref = str(tmp_path / "deg.las"), str(tmp_path / "ref.las")
    main(["reproject", las, out] + CPU)
    jpipe.reproject_las(las, ref)
    with open(out, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_extract_table_matches_jax(workspace, tmp_path):
    """``extract --excel`` on the corridor: the north angle rounds as the
    jitted JAX expression, so the towers table (csv) is the JAX package's
    field for field."""
    tmp, las, gim, centers = workspace
    out, ref = str(tmp_path / "t.csv"), str(tmp_path / "ref.csv")
    main(["extract", las, "--eps", "5", "--min-points", "30", "--excel", out] + CPU)
    jmain(["extract", las, "--eps", "5", "--min-points", "30", "--excel", ref])
    with open(out, encoding="utf-8") as f, open(ref, encoding="utf-8") as g:
        got, want = f.read(), g.read()
    assert len(got.splitlines()) == len(centers) + 1
    assert got == want


_NUM = re.compile(r"[-+]?\d+\.\d+|[-+]?\d+")


def _same_lines(got, ref, tol):
    """The same lines with every number within ``tol`` of the reference's
    (printed to 2 or 3 decimals, so a last digit may round either way)."""
    assert len(got) == len(ref), (got, ref)
    for g, r in zip(got, ref):
        assert _NUM.sub("#", g) == _NUM.sub("#", r), (g, r)
        for a, b in zip(_NUM.findall(g), _NUM.findall(r)):
            assert abs(float(a) - float(b)) <= tol, (g, r)


def test_cli_correct_icp_matches_jax(workspace, capsys, tmp_path):
    """``correct --icp``: the same pairs and ICP rmse lines as the JAX CLI
    (rmse printed to 1 mm, equal within 1e-3 m), and a saved GIM."""
    tmp, las, gim, centers = workspace
    args = ["correct", gim, las, "--eps", "5", "--min-points", "30", "--icp"]
    main(args + ["--output-folder", str(tmp_path / "t"), "--save", str(tmp_path / "o.gim")] + CPU)
    got = capsys.readouterr().out.splitlines()
    jmain(args + ["--output-folder", str(tmp_path / "j")])
    ref = capsys.readouterr().out.splitlines()
    def pick(lines):
        return [ln for ln in lines
                if ln.startswith(("extraction complete", "  ")) or ln.endswith("pairs matched")]

    got_l, ref_l = pick(got), pick(ref)
    assert f"{len(centers)} pairs matched" in got_l
    assert sum("icp rmse" in ln for ln in got_l) == len(centers)
    _same_lines(got_l, ref_l, 1.1e-3)
    assert "saved" in got
    recs, _, _ = pipeline.import_gim(str(tmp_path / "o.gim"), str(tmp_path / "re"))
    assert len(recs) == len(centers)


def test_cli_register_matches_jax(workspace, capsys, tmp_path):
    """``register``: one transform a matched tower, the same as the JAX
    CLI's (t printed to 1 cm, rmse to 1 mm).  Each cloud is aligned onto
    itself, an exact fit whose rmse is rounding noise: where the JAX CLI
    prints nan (the root of a negative noise sum), the port prints its
    clamped root, below 0.03 m (tests/test_torch_registration.py)."""
    tmp, las, gim, centers = workspace
    args = ["register", gim, las, "--eps", "5", "--min-points", "30", "--iters", "10"]
    main(args + ["--output-folder", str(tmp_path / "t")] + CPU)
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("GIM[")]
    jmain(args + ["--output-folder", str(tmp_path / "j")])
    ref = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("GIM[")]
    assert len(got) == len(centers)
    rmse = re.compile(r"rmse=(\S+)")
    for g, r in zip(got, ref):
        a, b = rmse.search(g).group(1), rmse.search(r).group(1)
        assert float(a) < 0.03 if b == "nan" else abs(float(a) - float(b)) <= 1.1e-3
    _same_lines([rmse.sub("", g) for g in got], [rmse.sub("", r) for r in ref], 1.1e-2)


@pytest.mark.parametrize("fast", [False, True], ids=["modular", "fast"])
def test_cli_stream_extract_matches_jax(workspace, capsys, tmp_path, fast):
    """``stream-extract`` over two LAS tiles: the same towers after the
    cross-tile quality dedup as the JAX CLI."""
    tmp, las, gim, centers = workspace
    pts = read_las(las).xyz()
    tiles = []
    for i, shift in enumerate(((0.0, 0.0, 0.0), (600.0, 0.0, 2.0))):
        tiles.append(str(tmp_path / f"tile{i}.las"))
        write_las(make_las(pts + shift, scales=[0.01, 0.01, 0.01]), tiles[-1])
    args = ["stream-extract", *tiles, "--eps", "5", "--min-points", "30",
            "--capacity", "8192"] + (["--fast"] if fast else [])
    main(args + CPU)
    got = capsys.readouterr().out.splitlines()
    jmain(args)
    ref = capsys.readouterr().out.splitlines()
    assert got[0].startswith("governor: ") and got[0].endswith("(explicit --capacity)")
    assert got[1] == ref[1] == f"{2 * len(centers)} towers across 2 tiles (capacity 8,192)"
    _same_lines(got[2:], ref[2:], 1.1e-2)


@pytest.mark.parametrize("preset", ["kuangxuan_original", "symmetric_moderate"])
def test_cli_viz_export_matches_jax(workspace, capsys, tmp_path, preset):
    """``viz-export``: the wireframe JSON is the JAX CLI's, byte for byte
    (the towers' geometry is, as in test_extract_table_matches_jax)."""
    tmp, las, gim, centers = workspace
    args = ["--eps", "5", "--min-points", "30", "--preset", preset]
    main(["viz-export", las, str(tmp_path / "t.json")] + args + CPU)
    assert f"{len(centers)} tower boxes" in capsys.readouterr().out
    jmain(["viz-export", las, str(tmp_path / "j.json")] + args)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    boxes = json.loads((tmp_path / "t.json").read_text())
    assert len(boxes) == len(centers) and all(len(b["points"]) == 24 for b in boxes)


@pytest.mark.parametrize("out,towers", [("ply", True), ("ply", False), ("laz", True),
                                        ("las", False)])
def test_cli_export_scene_matches_jax(workspace, capsys, tmp_path, out, towers):
    """``export-scene``: the PLY (points, cluster colours, wireframes) or the
    coloured LAS/LAZ is the JAX CLI's, byte for byte."""
    from pointcloudhookup_tpu_torch.viz.export import read_ply_scene

    tmp, las, gim, centers = workspace
    args = ["--eps", "5", "--min-points", "30"] + (["--towers"] if towers else [])
    main(["export-scene", las, str(tmp_path / f"t.{out}")] + args + CPU)
    got = capsys.readouterr().out
    jmain(["export-scene", las, str(tmp_path / f"j.{out}")] + args)
    ref = capsys.readouterr().out
    assert got.replace("t.", "j.") == ref
    assert (tmp_path / f"t.{out}").read_bytes() == (tmp_path / f"j.{out}").read_bytes()
    if out == "ply":
        xyz, rgb, edges = read_ply_scene(str(tmp_path / "t.ply"))
        n = len(read_las(las))
        assert len(xyz) == n + (24 * len(centers) if towers else 0)
        assert len(edges) == (12 * len(centers) if towers else 0)
    else:
        scene = read_las(str(tmp_path / f"t.{out}"))
        np.testing.assert_allclose(scene.xyz(), read_las(las).xyz(), atol=1e-3)


def test_cli_render_matches_jax(workspace, capsys, tmp_path):
    """``render --towers``: the PNG, decoded, is the JAX CLI's image pixel for
    pixel (any differing pixel is counted and reported)."""
    Image = pytest.importorskip("PIL.Image")
    from pointcloudhookup_tpu_torch.viz.render import read_png

    tmp, las, gim, centers = workspace
    args = ["--towers", "--eps", "5", "--min-points", "30", "--width", "400", "--height",
            "300"]
    main(["render", las, str(tmp_path / "t.png")] + args + CPU)
    assert f"{len(centers)} tower boxes" in capsys.readouterr().out
    jmain(["render", las, str(tmp_path / "j.png")] + args)
    got = read_png(str(tmp_path / "t.png"))
    ref = np.asarray(Image.open(tmp_path / "j.png"))
    differ = int((got != ref).any(axis=2).sum())
    print(f"render: {differ} of {got.shape[0] * got.shape[1]} pixels differ from the JAX CLI")
    assert got.shape == (300, 400, 3) and differ == 0
    assert np.array_equal(np.asarray(Image.open(tmp_path / "t.png")), got)
    assert ((got == [255, 0, 0]).all(axis=2)).sum() > 100  # the red tower boxes


@pytest.mark.parametrize("grid", [True, False], ids=["geoid", "empirical"])
def test_cli_elevation_report_matches_jax(workspace, capsys, tmp_path, grid):
    """``elevation-report`` (no --device: host work only): the printed
    report, the CSV and the text report are the JAX CLI's bytes, with a
    .gtx grid written by the port's save_gtx and with the empirical N."""
    from pointcloudhookup_tpu_torch.io.geoid import save_gtx
    from pointcloudhookup_tpu_torch.ops.geo import GeoidGrid

    tmp, las, gim, centers = workspace
    args = ["--empirical-n", "27.5"]
    if grid:
        lat, lon = np.meshgrid(np.arange(17) * 0.25 + 26.2, np.arange(17) * 0.25 + 111.5,
                               indexing="ij")
        save_gtx(GeoidGrid(26.2, 111.5, 0.25, 0.25, (-20.0 + 0.8 * (lat - 28.0)
                                                    - 0.5 * (lon - 113.0)).astype(np.float32)),
                 str(tmp_path / "g.gtx"))
        args += ["--geoid", str(tmp_path / "g.gtx")]
    outs = {}
    for tag, fn in (("t", main), ("j", jmain)):
        fn(["elevation-report", gim, "--csv", str(tmp_path / f"{tag}.csv"), "--text",
            str(tmp_path / f"{tag}.txt"), "--output-folder", str(tmp_path / tag)] + args)
        outs[tag] = capsys.readouterr().out
    assert outs["t"] == outs["j"]
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    rows = (tmp_path / "t.csv").read_text().splitlines()
    assert len(rows) == len(centers) + 1
    assert rows[1].endswith("geoid_grid" if grid else "empirical_n")
    with pytest.raises(SystemExit):
        main(["elevation-report", gim, "--device", "cpu"])


def test_cli_lists_every_jax_command(capsys):
    """The port's CLI has every command of the JAX package's."""
    def commands(fn):
        with pytest.raises(SystemExit):
            fn(["--help"])
        text = capsys.readouterr().out
        return set(re.search(r"\{([a-z,-]+)\}", text).group(1).split(","))

    ref = commands(jmain)
    assert len(ref) == 14 and commands(main) == ref
