"""Tile streaming (``core/streaming.py``) and the native LAS reader of the
port on the CPU.

The first ten tests mirror the streaming half of
``tests/test_streaming_and_reports.py`` against the port (``device="cpu"``).
The rest hold it against the JAX package on the same tiles:

* ``_dequantize_u16`` and the streamer's staged coordinates and masks on
  both wires: bit-equal;
* ``stream_extract``, fast and modular: the same accepted towers, labels
  and counts; box centres and extents within 4 float32 ulp of the largest
  coordinate (the parity rule's f32 tolerance), centroids within the
  summation-order bound 2 n u |x| + 1e-5;
* the loss of a tower whose rows are split between two chunks of one file,
  as the JAX package loses it;
* the native LAS reader: bit-identical to both packages' Python readers.
"""

import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.config import ClusterParams as JClusterParams
from pointcloudhookup_tpu.config import ExtractParams as JExtractParams
from pointcloudhookup_tpu.config import GroundParams as JGroundParams
from pointcloudhookup_tpu.core import streaming as jstreaming
from pointcloudhookup_tpu.io.las import read_las as jread_las
from pointcloudhookup_tpu_torch.config import ClusterParams, ExtractParams, GroundParams
from pointcloudhookup_tpu_torch.core.streaming import TileStreamer, _dequantize_u16, stream_extract
from pointcloudhookup_tpu_torch.io.las import make_las, read_las, write_las
from pointcloudhookup_tpu_torch.io.synthetic import synthetic_corridor

CPU = "cpu"


def _params(j=False, **kw):
    cp, ep = (JClusterParams, JExtractParams) if j else (ClusterParams, ExtractParams)
    return ep(cluster=cp(eps=5.0, min_points=30), **kw)


# ----------------------------------------------- mirrors of the JAX tests
def test_tile_streamer_splits_and_prefetches(rng):
    tiles = [rng.uniform(0, 100, size=(900, 3)), rng.uniform(0, 100, size=(300, 3))]
    out = list(TileStreamer(tiles, capacity=512, origin=np.zeros(3), device=CPU))
    assert [m["n"] for _, _, m in out] == [512, 388, 300]
    xyz0, mask0, _ = out[0]
    assert xyz0.shape == (512, 3) and bool(mask0[511]) is True
    assert int(out[1][1].sum()) == 388
    np.testing.assert_allclose(xyz0.double().numpy(), tiles[0][:512], atol=1e-3)


def test_tile_streamer_u16_wire_roundtrip(rng):
    tiles = [rng.uniform(0, 2000, size=(800, 3))]
    exact = list(TileStreamer(tiles, capacity=1024, origin=np.zeros(3), device=CPU))[0]
    quant = list(TileStreamer(tiles, capacity=1024, origin=np.zeros(3), wire="u16",
                              device=CPU))[0]
    assert torch.equal(exact[1], quant[1])
    np.testing.assert_allclose(quant[0].numpy()[:800], tiles[0], atol=2000.0 / 65535.0)
    assert (quant[0].numpy()[800:] == 0).all()


def test_tile_streamer_u16_wire_extraction_equivalent(rng):
    pts, centers = synthetic_corridor(rng, n_ground=3000, n_veg=400, pts_per_tower=300,
                                      extent=200.0)
    r16 = stream_extract([pts], capacity=8192, params=_params(), wire="u16", device=CPU)
    r32 = stream_extract([pts], capacity=8192, params=_params(), wire="f32", device=CPU)
    a16, a32 = r16[0][0]["accepted"], r32[0][0]["accepted"]
    assert a16.sum() == a32.sum() >= len(centers) - 1
    c32 = r32[0][0]["center"][a32]
    for c in r16[0][0]["center"][a16]:
        assert np.linalg.norm(c32 - c, axis=1).min() < 0.5


def test_tile_streamer_rejects_bad_wire():
    with pytest.raises(ValueError):
        TileStreamer([], capacity=64, wire="f16", device=CPU)


def test_tile_streamer_error_propagates(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(TileStreamer([str(tmp_path / "missing.las")], capacity=128, device=CPU))


def _two_tower_tiles(rng):
    tiles = []
    for d in range(2):
        pts, _ = synthetic_corridor(
            rng, n_ground=1500, n_veg=0, towers=((0.0, 0.0),),
            pts_per_tower=400, extent=100.0, origin=(d * 500.0, 0.0, 0.0),
        )
        tiles.append(pts)
    return tiles


def _small_params(j=False):
    gp = JGroundParams if j else GroundParams
    return _params(j, ground=gp(min_points_after=64), max_clusters=16, obb_angles=32)


def test_stream_extract_finds_towers_per_tile(rng):
    results = stream_extract(_two_tower_tiles(rng), capacity=2048, params=_small_params(),
                             device=CPU)
    assert len(results) == 2
    for stats, _ in results:
        assert stats["accepted"].sum() == 1


def test_stream_extract_fast_mode_matches(rng):
    tiles = _two_tower_tiles(rng)
    slow = stream_extract(tiles, capacity=2048, params=_small_params(), device=CPU)
    fast = stream_extract(tiles, capacity=2048, params=_small_params(), fast=True, device=CPU)
    for (s, _), (f, _) in zip(slow, fast):
        assert s["accepted"].sum() == f["accepted"].sum() == 1
        cs, cf = s["center"][s["accepted"]], f["center"][f["accepted"]]
        assert np.linalg.norm(cs[:, :2] - cf[:, :2]) < 0.5


def test_native_las_codec_matches_python(tmp_path, rng):
    from pointcloudhookup_tpu_torch.native import (
        get_lib,
        las_probe,
        las_read_xyz,
        las_read_xyz_range,
    )

    assert get_lib() is not None, "g++ builds the LAS codec here"
    xyz = np.column_stack([rng.uniform(500000, 501000, 777),
                           rng.uniform(3100000, 3101000, 777), rng.uniform(0, 100, 777)])
    p = str(tmp_path / "n.las")
    write_las(make_las(xyz, scales=[0.001, 0.001, 0.001], point_format=1), p)
    n, scales, offsets, fmt = las_probe(p)
    assert n == 777 and fmt == 1
    got = las_read_xyz(p)
    np.testing.assert_array_equal(got, read_las(p).xyz())
    np.testing.assert_array_equal(las_read_xyz_range(p, 100, 50), got[100:150])
    assert las_read_xyz_range(p, 770, 100).shape == (7, 3)


def test_tile_streamer_u16_pitch_guard(rng):
    wide = rng.uniform(0, 8000, size=(600, 3))
    narrow = rng.uniform(0, 1000, size=(600, 3))
    out = list(TileStreamer([wide, narrow], capacity=1024, origin=np.zeros(3), wire="u16",
                            device=CPU))
    assert out[0][2]["wire"] == "f32"
    assert out[1][2]["wire"] == "u16"
    np.testing.assert_allclose(out[0][0].double().numpy()[:600], wide, atol=1e-2)
    off = list(TileStreamer([wide], capacity=1024, origin=np.zeros(3), wire="u16",
                            max_pitch=None, device=CPU))
    assert off[0][2]["wire"] == "u16"


def test_stream_extract_timings_hook(rng):
    pts, _ = synthetic_corridor(rng, n_ground=2000, n_veg=200, pts_per_tower=200, extent=200.0)
    res = stream_extract([pts], capacity=8192, params=_params(), prefetch=2, timings=True,
                         device=CPU)
    assert all(m["step_seconds"] > 0 for _, m in res)


# ----------------------------------------------- parity with the JAX package
def test_dequantize_u16_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    cap, n = 4096, 3000
    q = rng.integers(0, 65536, (cap, 3)).astype(np.uint16)
    for extent in (37.0, 900.0, 2000.0, 3300.0):
        scale = (np.full(3, extent) / 65535.0).astype(np.float32)
        shift = rng.uniform(-extent, 0, 3).astype(np.float32)
        ref_xyz, ref_mask = jstreaming._dequantize_u16(q, scale, shift, np.int32(n))
        xyz, mask = _dequantize_u16(torch.from_numpy(q.astype(np.int32)),
                                    torch.from_numpy(scale), torch.from_numpy(shift), n)
        np.testing.assert_array_equal(xyz.numpy(), np.asarray(ref_xyz))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


@pytest.fixture(scope="module")
def tiles():
    rng = np.random.default_rng(5)
    pts, centers = synthetic_corridor(rng, n_ground=3000, n_veg=400, pts_per_tower=300,
                                      extent=200.0)
    return [pts, pts + [300.0, 20.0, 1.5]], centers


@pytest.mark.parametrize("wire", ["u16", "f32"])
def test_tile_streamer_staging_bit_equal_to_jax(tiles, wire):
    tl, _ = tiles
    ref = list(jstreaming.TileStreamer(tl, capacity=8192, wire=wire))
    got = list(TileStreamer(tl, capacity=8192, wire=wire, device=CPU))
    assert len(got) == len(ref) == 2
    for (x, m, meta), (rx, rm, rmeta) in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
        np.testing.assert_array_equal(meta["origin"], rmeta["origin"])
        assert meta["wire"] == rmeta["wire"] == wire


@pytest.mark.parametrize("fast", [False, True], ids=["modular", "fast"])
def test_stream_extract_matches_jax(tiles, fast):
    tl, centers = tiles
    ref = jstreaming.stream_extract(tl, capacity=8192, params=_params(True), fast=fast,
                                    fetch_labels=True)
    got = stream_extract(tl, capacity=8192, params=_params(), fast=fast, fetch_labels=True,
                         device=CPU)
    assert len(got) == len(ref) == 2
    for (g, gm), (r, rm) in zip(got, ref):
        acc = r["accepted"].astype(bool)
        assert acc.sum() == len(centers)
        np.testing.assert_array_equal(g["accepted"], acc)
        np.testing.assert_array_equal(g["labels"], r["labels"])
        np.testing.assert_array_equal(g["count"], r["count"])
        np.testing.assert_array_equal(gm["origin"], rm["origin"])
        coord = np.abs(r["center"][acc]).max() + r["extent"][acc].max()
        tol = 4 * float(np.spacing(np.float32(coord)))
        for key in ("center", "extent"):
            np.testing.assert_allclose(g[key][acc], r[key][acc], rtol=0, atol=tol, err_msg=key)
        bound = 2 * r["count"][acc, None] * 2.0**-24 * np.abs(r["centroid"][acc]) + 1e-5
        assert (np.abs(g["centroid"][acc] - r["centroid"][acc]) <= bound).all()


def test_chunk_boundary_loss_reproduced():
    """A tower whose rows alternate between the two chunks of one file (as
    interleaved flight lines put them) leaves a half-density fragment in
    each chunk; each fragment falls below the clustering density and the
    tower is lost, by the JAX package and the port alike."""
    rng = np.random.default_rng(7)
    pts, centers = synthetic_corridor(rng, n_ground=3000, n_veg=400, pts_per_tower=200,
                                      extent=200.0)
    near = np.linalg.norm(pts[:, :2] - centers[1, :2], axis=1) < 12.0
    b, rest = np.nonzero(near)[0], np.nonzero(~near)[0]
    first = np.concatenate([rest, b[0::2]])
    tile = np.concatenate([pts[first], pts[b[1::2]]])
    cap = len(first)
    whole = stream_extract([tile], capacity=16384, params=_params(), wire="f32", device=CPU)
    assert int(whole[0][0]["accepted"].sum()) == len(centers)
    ref = jstreaming.stream_extract([tile], capacity=cap, params=_params(True), wire="f32")
    got = stream_extract([tile], capacity=cap, params=_params(), wire="f32", device=CPU)
    counts = [int(s["accepted"].sum()) for s, _ in got]
    assert counts == [int(s["accepted"].sum()) for s, _ in ref] == [len(centers) - 1, 0]


def test_native_reader_bit_identical_to_both_python_readers(tmp_path):
    from pointcloudhookup_tpu_torch.native import las_read_xyz

    rng = np.random.default_rng(8)
    xyz = rng.uniform(0, 1000, (20_000, 3)) + [496_000.0, 3_120_000.0, 50.0]
    for i, scale in enumerate((0.001, 0.01, 0.0025)):
        p = str(tmp_path / f"r{i}.las")
        write_las(make_las(xyz, scales=[scale] * 3, point_format=i), p)
        got = las_read_xyz(p)
        np.testing.assert_array_equal(got, read_las(p).xyz())
        np.testing.assert_array_equal(got, jread_las(p).xyz())
    ts = TileStreamer([p], capacity=32768, device=CPU)
    assert [m["reader"] for _, _, m in ts] == ["native"]
