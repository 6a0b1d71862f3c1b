"""The port's geodesy against the JAX package's ``ops/geo.py``, on the CPU.

Tolerances: the numpy (host f64) paths are the same operations as the JAX
module's ``xp=np`` paths and must be bit-identical; the torch f64 TM
projection within 1e-9 deg (~0.1 mm) of the numpy one; the torch f32
``LocalTaylor2D.eval_delta`` within 2e-8 deg of the f64 inverse over a
+-2 km tile, as ``tests/test_geo.py`` requires of the JAX device path;
float32 haversine, geoid interpolation and greedy matching against the
JAX functions (``xp=jnp``, float32) within float32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.ops import geo as jgeo
from pointcloudhookup_tpu_torch.ops import geo as tgeo

torch.set_num_threads(2)


def _bits_equal(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint64), ref.view(np.uint64))


def _lonlat(seed, n=500):
    rng = np.random.default_rng(seed)
    return rng.uniform(111.0, 117.0, n), rng.uniform(18.0, 45.0, n)


def test_numpy_paths_bit_identical():
    lon, lat = _lonlat(1)
    e, n = tgeo.tm_forward(lon, lat)
    je, jn = jgeo.tm_forward(lon, lat, xp=np)
    _bits_equal(e, je)
    _bits_equal(n, jn)
    for got, ref in zip(tgeo.tm_inverse(e, n), jgeo.tm_inverse(je, jn, xp=np)):
        _bits_equal(got, ref)
    for got, ref in zip(tgeo.cgcs2000_to_wgs84(e, n), jgeo.cgcs2000_to_wgs84(e, n, xp=np)):
        _bits_equal(got, ref)
    for got, ref in zip(tgeo.wgs84_to_cgcs2000(lon, lat),
                        jgeo.wgs84_to_cgcs2000(lon, lat, xp=np)):
        _bits_equal(got, ref)
    # scalars, as the tower conversion calls it
    got = tgeo.tm_inverse(float(e[0]), float(n[0]))
    ref = jgeo.tm_inverse(float(e[0]), float(n[0]), xp=np)
    assert [float(v) for v in got] == [float(v) for v in ref]
    # haversine, matrix and greedy matching
    _bits_equal(tgeo.haversine_m(lat[:50], lon[:50], lat[50:100], lon[50:100]),
                jgeo.haversine_m(lat[:50], lon[:50], lat[50:100], lon[50:100], xp=np))
    _bits_equal(tgeo.haversine_matrix(lat[:40], lon[:40], lat[40:70], lon[40:70]),
                jgeo.haversine_matrix(lat[:40], lon[:40], lat[40:70], lon[40:70], xp=np))


def test_local_taylor_host_build_bit_identical():
    e0, n0 = (float(v) for v in tgeo.tm_forward(113.7, 28.3))
    got = tgeo.local_cgcs2000_to_wgs84(e0, n0)
    ref = jgeo.local_cgcs2000_to_wgs84(e0, n0)
    assert (got.x0, got.y0, got.u0, got.v0) == (ref.x0, ref.y0, ref.u0, ref.v0)
    _bits_equal(got.cu, ref.cu)
    _bits_equal(got.cv, ref.cv)
    rng = np.random.default_rng(2)
    de, dn = rng.uniform(-2000, 2000, (2, 100))
    for g, r in zip(got.eval_delta(de, dn), ref.eval_delta(de, dn, np)):
        _bits_equal(g, r)
    for g, r in zip(got(e0 + de, n0 + dn), ref(e0 + de, n0 + dn, np)):
        _bits_equal(g, r)


def test_torch_f64_tm_within_1e9_deg():
    lon, lat = _lonlat(3)
    e, n = tgeo.tm_forward(lon, lat)
    te, tn = tgeo.tm_forward(torch.from_numpy(lon), torch.from_numpy(lat))
    assert te.dtype == torch.float64
    np.testing.assert_allclose(te.numpy(), e, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), n, rtol=0, atol=1e-6)
    tlon, tlat = tgeo.tm_inverse(torch.from_numpy(e), torch.from_numpy(n))
    np.testing.assert_allclose(tlon.numpy(), lon, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tlat.numpy(), lat, rtol=0, atol=1e-9)
    rlon, rlat = jgeo.tm_inverse(e, n, xp=np)
    np.testing.assert_allclose(tlon.numpy(), rlon, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tlat.numpy(), rlat, rtol=0, atol=1e-9)


def test_local_taylor_f32_delta_within_2e8_deg():
    """The reprojection's device path: f64 expansion on the host, f32
    deltas on the device, against the f64 inverse (and the JAX device
    path) over a +-2 km tile."""
    e0, n0 = (float(v) for v in tgeo.tm_forward(113.7, 28.3))
    lt = tgeo.local_cgcs2000_to_wgs84(e0, n0)
    rng = np.random.default_rng(0)
    de = rng.uniform(-2000, 2000, 4096)
    dn = rng.uniform(-2000, 2000, 4096)
    dlon, dlat = lt.eval_delta(torch.from_numpy(de.astype(np.float32)),
                               torch.from_numpy(dn.astype(np.float32)))
    assert dlon.dtype == torch.float32
    lon_ref, lat_ref = tgeo.tm_inverse(e0 + de, n0 + dn)
    np.testing.assert_allclose(lt.u0 + dlon.double().numpy(), lon_ref, rtol=0, atol=2e-8)
    np.testing.assert_allclose(lt.v0 + dlat.double().numpy(), lat_ref, rtol=0, atol=2e-8)
    jlt = jgeo.local_cgcs2000_to_wgs84(e0, n0)
    # jitted, as the JAX package's reproject_las evaluates it
    jlon, jlat = jax.jit(lambda a, b: jlt.eval_delta(a, b, jnp))(
        jnp.asarray(de, jnp.float32), jnp.asarray(dn, jnp.float32))
    np.testing.assert_allclose(dlon.numpy(), np.asarray(jlon), rtol=0, atol=1e-9)
    np.testing.assert_allclose(dlat.numpy(), np.asarray(jlat), rtol=0, atol=1e-9)


def test_haversine_f32_matches_jax():
    lon, lat = _lonlat(4, 64)
    lat2 = (lat + np.random.default_rng(5).uniform(-0.01, 0.01, 64)).astype(np.float32)
    lat, lon = lat.astype(np.float32), lon.astype(np.float32)
    got = tgeo.haversine_matrix(*(torch.from_numpy(v) for v in (lat, lon, lat2, lon)))
    ref = np.asarray(jgeo.haversine_matrix(*(jnp.asarray(v) for v in (lat, lon, lat2, lon))))
    assert got.dtype == torch.float32
    # a few metres of float32 cancellation at ~0.01 deg, the same on both sides
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=5.0)
    exact = tgeo.haversine_matrix(lat.astype(np.float64), lon.astype(np.float64),
                                  lat2.astype(np.float64), lon.astype(np.float64))
    assert np.abs(got.numpy() - exact).max() < 10.0


def _geoid_grid(values_as):
    lat = np.linspace(0, 20, 81)
    lon = np.linspace(100, 130, 121)
    vals = (25.0 + 3.0 * np.sin(lat / 3.0)[:, None] * np.cos(lon / 5.0)[None, :]
            ).astype(np.float32)
    return values_as(lat0=0.0, lon0=100.0, dlat=0.25, dlon=0.25, values=vals)


@pytest.mark.parametrize("global_grid", [False, True], ids=["regional", "global"])
def test_geoid_grid_interp_matches_jax(global_grid):
    rng = np.random.default_rng(6)
    if global_grid:
        vals = rng.normal(30, 5, (9, 360)).astype(np.float32)
        kw = dict(lat0=-4.0, lon0=0.0, dlat=1.0, dlon=1.0)
        lat, lon = rng.uniform(-6, 6, 300), rng.uniform(-200, 400, 300)
    else:
        g = _geoid_grid(dict)
        vals, kw = g.pop("values"), g
        lat, lon = rng.uniform(-1, 21, 300), rng.uniform(98, 132, 300)
    tg = tgeo.GeoidGrid(values=vals, **kw)
    jg = jgeo.GeoidGrid(values=jnp.asarray(vals), **kw)
    _bits_equal(tg.interp(lat, lon), jg.interp(lat, lon, np))
    got = tg.interp(torch.from_numpy(lat.astype(np.float32)),
                    torch.from_numpy(lon.astype(np.float32)))
    ref = np.asarray(jg.interp(jnp.asarray(lat, jnp.float32), jnp.asarray(lon, jnp.float32)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    h = tgeo.ellipsoid_to_orthometric(lat, lon, 100.0, tg)
    _bits_equal(h, jgeo.ellipsoid_to_orthometric(lat, lon, 100.0, jg, xp=np))
    assert float(tgeo.ellipsoid_to_orthometric(0, 0, 100.0, None)) == 75.0


def test_geoid_patch_matches_jax():
    tg = _geoid_grid(tgeo.GeoidGrid)
    jg = jgeo.GeoidGrid(tg.lat0, tg.lon0, tg.dlat, tg.dlon, jnp.asarray(tg.values))
    tp = tgeo.grid_window(tg, 10.0, 113.5, half_cells=8)
    jp = jgeo.grid_window(jg, 10.0, 113.5, half_cells=8)
    assert (tp.lat0, tp.lon0, tp.dlat, tp.dlon) == (jp.lat0, jp.lon0, jp.dlat, jp.dlon)
    np.testing.assert_array_equal(tp.values, np.asarray(jp.values))
    rng = np.random.default_rng(7)
    lat = rng.uniform(8.0, 11.75, 500)  # inside the window's 16 x 16 nodes
    lon = rng.uniform(111.5, 115.25, 500)
    _bits_equal(tp.interp(lat, lon), jp.interp(lat, lon, np))
    assert float(tp.interp(10.1, 113.2)) == float(jp.interp(10.1, 113.2, np))
    got = tp.interp(torch.from_numpy(lat.astype(np.float32)),
                    torch.from_numpy(lon.astype(np.float32)))
    ref = np.asarray(jp.interp(jnp.asarray(lat, jnp.float32), jnp.asarray(lon, jnp.float32)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tg.interp(lat, lon), rtol=0, atol=1e-4)
    scalar = tp.interp(torch.tensor(10.1), torch.tensor(113.2))
    assert scalar.dim() == 0


def test_greedy_match_arrays_matches_jax():
    rng = np.random.default_rng(8)
    g_lat, g_lon = rng.uniform(28.0, 28.02, 40), rng.uniform(113.0, 113.02, 40)
    pick = rng.integers(0, 40, 60)
    p_lat = g_lat[pick] + rng.normal(0, 2e-4, 60)
    p_lon = g_lon[pick] + rng.normal(0, 2e-4, 60)
    g_h, p_h = rng.uniform(50, 150, 40), rng.uniform(50, 150, 60)
    args = (g_lat, g_lon, g_h, p_lat, p_lon, p_h)
    got = tgeo.greedy_match_arrays(*args)
    ref = jgeo.greedy_match_arrays(*args, xp=np)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[0].any() and not got[0].all()
    f32 = [a.astype(np.float32) for a in args]
    tgot = tgeo.greedy_match_arrays(*(torch.from_numpy(a) for a in f32))
    jref = jgeo.greedy_match_arrays(*(jnp.asarray(a) for a in f32))
    np.testing.assert_array_equal(tgot[0].numpy(), np.asarray(jref[0]))
    assert tgot[1].dtype == torch.int32
    m = tgot[0].numpy()
    np.testing.assert_array_equal(tgot[1].numpy()[m], np.asarray(jref[1])[m])


def test_eval_delta_bit_equal_to_jitted_jax():
    """On tensors the f32 deltas round as XLA:CPU's fused multiply-adds:
    bit-equal to the jitted JAX expansion over 200,000 (dx, dy) in +-2 km."""
    e0, n0 = (float(v) for v in tgeo.tm_forward(113.5, 28.2))
    lt, jlt = tgeo.local_cgcs2000_to_wgs84(e0, n0), jgeo.local_cgcs2000_to_wgs84(e0, n0)
    rng = np.random.default_rng(0)
    dx, dy = rng.uniform(-2000, 2000, (2, 200_000)).astype(np.float32)
    ref = jax.jit(lambda a, b: jlt.eval_delta(a, b, jnp))(dx, dy)
    got = lt.eval_delta(torch.from_numpy(dx), torch.from_numpy(dy))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_reproject_las_bytes_equal_jax_on_a_2km_tile(tmp_path):
    """100,000 points over +-2 km at 0.001 m: the reprojected LAS (1e-7 deg
    scale) is the JAX package's to the byte."""
    from pointcloudhookup_tpu.models.pipeline import reproject_las as jreproject
    from pointcloudhookup_tpu_torch.io.las import make_las, write_las
    from pointcloudhookup_tpu_torch.models.pipeline import reproject_las

    e0, n0 = (float(v) for v in tgeo.tm_forward(113.5, 28.2))
    rng = np.random.default_rng(4)
    pts = np.column_stack([e0 + rng.uniform(-2000, 2000, 100_000),
                           n0 + rng.uniform(-2000, 2000, 100_000),
                           rng.uniform(50, 120, 100_000)])
    src, out, ref = (str(tmp_path / f) for f in ("src.las", "out.las", "ref.las"))
    write_las(make_las(pts, scales=[0.001] * 3), src)
    reproject_las(src, out, device="cpu")
    jreproject(src, ref)
    with open(out, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
