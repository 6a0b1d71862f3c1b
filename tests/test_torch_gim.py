"""The port's 7z, GIM and CBM modules and GIM tree builders against the
JAX package's, on the same inputs.  These are host modules copied into the
port, so the tolerance is none: identical entries, identical bytes,
identical records and identical files."""

import dataclasses
import os
import shutil

import pytest

from pointcloudhookup_tpu.io import cbm as jcbm
from pointcloudhookup_tpu.io import gim as jgim
from pointcloudhookup_tpu.io import sevenzip as jzip
from pointcloudhookup_tpu.io import synthetic as jsyn
from pointcloudhookup_tpu_torch.io import cbm as tcbm
from pointcloudhookup_tpu_torch.io import gim as tgim
from pointcloudhookup_tpu_torch.io import sevenzip as tzip
from pointcloudhookup_tpu_torch.io import synthetic as tsyn

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mixed_folders.7z")


def _towers(n=5):
    return [
        dict(id=f"P{40 + i}", lat=28.1 + 0.0041 * i, lng=113.2 + 0.0077 * i,
             h=55.5 + 1.25 * i, r=(37.0 * i) % 360.0)
        for i in range(n)
    ]


def _entries(mod):
    return [
        mod.Entry(name="Cbm", is_dir=True),
        mod.Entry(name="Cbm/project.cbm", data="SUBSYSTEM=F1.cbm\n".encode("utf-8")),
        mod.Entry(name="Cbm/F1.cbm", data="BLHA=28.1,113.2,55.5,3.0\n杆塔=塔\n".encode("utf-8")),
        mod.Entry(name="empty.txt", data=b""),
        mod.Entry(name="big.bin", data=bytes(range(256)) * 500),
    ]


def _as_dicts(entries):
    return [dataclasses.asdict(e) for e in entries]


def _tree_bytes(folder):
    out = {}
    for root, _dirs, files in os.walk(folder):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, folder)] = f.read()
    return out


def test_read_7z_fixture_identical():
    with open(FIXTURE, "rb") as f:
        blob = f.read()
    got, ref = tzip.read_7z(blob), jzip.read_7z(blob)
    assert len(got) == 3
    assert _as_dicts(got) == _as_dicts(ref)


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("store,encode_header", [(False, False), (False, True), (True, False)],
                         ids=["lzma2", "lzma2-encoded-header", "store"])
def test_write_7z_identical_bytes(level, store, encode_header):
    kw = dict(level=level, store=store, encode_header=encode_header)
    got = tzip.write_7z(_entries(tzip), **kw)
    assert got == jzip.write_7z(_entries(jzip), **kw)
    assert _as_dicts(tzip.read_7z(got)) == _as_dicts(jzip.read_7z(got))


@pytest.mark.parametrize("level", [1, 9])
def test_gim_files_identical_bytes(tmp_path, level):
    """build_gim_tree, pack_directory, write_gim and build_synthetic_gim
    give the JAX package's bytes; the port reads back the same tree."""
    towers = _towers()
    tsyn.build_gim_tree(str(tmp_path / "t"), towers, subsystems=2)
    jsyn.build_gim_tree(str(tmp_path / "j"), towers, subsystems=2)
    assert _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")
    for store in (False, True):
        kw = dict(level=level, store=store, encode_header=not store)
        assert (tzip.pack_directory(str(tmp_path / "t"), **kw)
                == jzip.pack_directory(str(tmp_path / "j"), **kw))
    header = b"GIMHDR\x01" + bytes(range(200))  # short: zero-padded to 776
    tgim.write_gim(str(tmp_path / "t"), str(tmp_path / "t.gim"), header=header, level=level)
    jgim.write_gim(str(tmp_path / "j"), str(tmp_path / "j.gim"), header=header, level=level)
    assert (tmp_path / "t.gim").read_bytes() == (tmp_path / "j.gim").read_bytes()
    tsyn.build_synthetic_gim(str(tmp_path / "ts.gim"), towers, workdir=str(tmp_path / "ts"))
    jsyn.build_synthetic_gim(str(tmp_path / "js.gim"), towers, workdir=str(tmp_path / "js"))
    assert (tmp_path / "ts.gim").read_bytes() == (tmp_path / "js.gim").read_bytes()

    out, hdr = tgim.extract_gim(str(tmp_path / "j.gim"), str(tmp_path / "x"))
    ref_out, ref_hdr = jgim.extract_gim(str(tmp_path / "j.gim"), str(tmp_path / "y"))
    assert hdr == ref_hdr and len(hdr) == tgim.HEADER_SIZE
    assert _tree_bytes(out) == _tree_bytes(ref_out)
    written = tzip.extract_to_directory(tzip.pack_directory(out), str(tmp_path / "z"))
    assert len(written) == len(_tree_bytes(out))


def test_gim_reader_rejects_what_the_jax_reader_rejects(tmp_path):
    bad = tmp_path / "x.7z"
    bad.write_bytes(b"\x00" * 800)
    for mod in (tgim, jgim):
        with pytest.raises(ValueError):
            mod.GimFile.read(str(bad))
    short = tmp_path / "s.gim"
    short.write_bytes(b"\x00" * 100)
    for mod in (tgim, jgim):
        with pytest.raises(ValueError):
            mod.GimFile.read(str(short))
    for mod in (tzip, jzip):
        with pytest.raises(ValueError):
            mod.safe_join(str(tmp_path), "../escape.cbm")


def test_cbm_records_and_corrections_identical(tmp_path):
    towers = _towers(7)
    towers[2]["props"] = {"杆塔编号": "Z9", "呼高": "30"}
    jsyn.build_gim_tree(str(tmp_path / "j"), towers, subsystems=3)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    log_t, log_j = [], []
    got = tcbm.load_towers_from_gim_folder(str(tmp_path / "t"), log_t.append)
    ref = jcbm.load_towers_from_gim_folder(str(tmp_path / "j"), log_j.append)
    assert len(got) == 7
    strip = lambda recs, root: [  # noqa: E731
        {**dataclasses.asdict(r), "cbm_path": os.path.relpath(r.cbm_path, root)} for r in recs]
    assert strip(got, tmp_path / "t") == strip(ref, tmp_path / "j")
    assert got[0].get("lat") == ref[0].get("lat")

    def rows(recs):
        out = []
        for i, r in enumerate(recs[:5]):
            row = {"杆塔编号": r.properties["杆塔编号"], "纬度": r.lat + 1e-4 * i,
                   "经度": r.lng - 2e-4, "高度": r.h + 0.123456, "北方向偏角": r.r + 0.5,
                   "CBM路径": r.cbm_path if i % 2 else ""}
            out.append(row)
        out.append({"tower_id": "nope", "lat": 1.0, "lon": 2.0})  # found nowhere
        return out

    assert (tcbm.apply_corrections(str(tmp_path / "t"), rows(got), log_t.append)
            == jcbm.apply_corrections(str(tmp_path / "j"), rows(ref), log_j.append))
    assert _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")
    assert log_t == [m.replace(str(tmp_path / "j"), str(tmp_path / "t")) for m in log_j]
    cbm = str(tmp_path / "t" / "Cbm" / "T0.cbm")
    assert tcbm.update_cbm_blha(cbm, 28.5, 113.9, 77.123456, 45.6789)
    with open(cbm, encoding="utf-8") as f:
        assert "BLHA=28.500000,113.900000,77.123,45.679\n" in f.read()
    assert tcbm.BLHA_FORMAT == jcbm.BLHA_FORMAT
    assert ([os.path.relpath(p, tmp_path / "t") for p in
             tcbm.find_cbm_for_tower(str(tmp_path / "t" / "Cbm"), "3")]
            == [os.path.relpath(p, tmp_path / "j") for p in
                jcbm.find_cbm_for_tower(str(tmp_path / "j" / "Cbm"), "3")])
