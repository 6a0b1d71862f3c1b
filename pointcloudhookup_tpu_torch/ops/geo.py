"""Geodesy: CGCS2000 Gauss-Krüger <-> WGS84, haversine, geoid lookup.

Counterpart of ``pointcloudhookup_tpu/ops/geo.py``.  The reference
delegates to PROJ (``Transformer.from_crs("EPSG:4547", "EPSG:4326")`` and
``+proj=vgridshift``); here both are closed form:

  * Transverse Mercator by Karney's (2011) Krüger series to n^6 (sub-mm
    against PROJ in f64).  EPSG:4547 = CGCS2000 / 3-degree Gauss-Kruger,
    central meridian 114E, false easting 500 000 m, k0 = 1.
  * Geoid undulation by bilinear interpolation over a regular grid.
  * Haversine with R = 6371 km, as the reference's matcher.

Where the JAX module takes an ``xp`` module, each function here takes
numpy arrays or Python numbers (the host f64 path, the same operations as
the JAX module with ``xp=np``) or torch tensors (the device path, in the
tensors' dtype and on their device), and picks the branch by the type of
its first argument.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

from pointcloudhookup_tpu_torch.ops.morton import fma_f32

# CGCS2000 ellipsoid (the WGS84 semi-major axis; the flattening differs in
# the 10th significant digit; PROJ treats the datum shift as null too)
A_CGCS2000 = 6378137.0
F_CGCS2000 = 1.0 / 298.257222101

_EARTH_R_M = 6371.0 * 1000.0  # the reference's haversine radius


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


@dataclasses.dataclass(frozen=True)
class TMProjection:
    """A transverse-Mercator projection definition."""

    lon0_deg: float = 114.0  # EPSG:4547 central meridian
    k0: float = 1.0
    false_easting: float = 500_000.0
    false_northing: float = 0.0
    a: float = A_CGCS2000
    f: float = F_CGCS2000


EPSG_4547 = TMProjection()


def _series_coeffs(f: float):
    """Karney (2011) alpha/beta series coefficients in n = f/(2-f)."""
    n = f / (2.0 - f)
    n2, n3, n4, n5, n6 = n**2, n**3, n**4, n**5, n**6
    rect_a = (1.0 + n2 / 4 + n4 / 64 + n6 / 256) / (1.0 + n)
    alpha = (
        n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180 - 127 * n5 / 288 + 7891 * n6 / 37800,
        13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630 - 1983433 * n6 / 1935360,
        61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880 + 167603 * n6 / 181440,
        49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
        34729 * n5 / 80640 - 3418889 * n6 / 1995840,
        212378941 * n6 / 319334400,
    )
    beta = (
        n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512 + 96199 * n6 / 604800,
        n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105 - 1118711 * n6 / 3870720,
        17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480 + 5569 * n6 / 90720,
        4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
        4583 * n5 / 161280 - 108847 * n6 / 3991680,
        20648693 * n6 / 638668800,
    )
    return rect_a, alpha, beta


def tm_forward(lon_deg, lat_deg, proj: TMProjection = EPSG_4547):
    """Geographic (deg) -> projected (easting, northing) in meters."""
    rect_a, alpha, _ = _series_coeffs(proj.f)
    big_a = proj.a * rect_a
    e = math.sqrt(proj.f * (2.0 - proj.f))
    if _is_tensor(lon_deg):
        lat = torch.deg2rad(lat_deg)
        dlon = torch.deg2rad(lon_deg - proj.lon0_deg)
        s = torch.sin(lat)
        t = torch.sinh(torch.atanh(s) - e * torch.atanh(e * s))
        xi = torch.atan2(t, torch.cos(dlon))
        eta = torch.asinh(torch.sin(dlon) / torch.sqrt(t * t + torch.cos(dlon) ** 2))
        xi_s, eta_s = xi, eta
        for j, aj in enumerate(alpha, start=1):
            xi_s = xi_s + aj * torch.sin(2 * j * xi) * torch.cosh(2 * j * eta)
            eta_s = eta_s + aj * torch.cos(2 * j * xi) * torch.sinh(2 * j * eta)
    else:
        lat = np.radians(np.asarray(lat_deg))
        dlon = np.radians(np.asarray(lon_deg) - proj.lon0_deg)
        s = np.sin(lat)
        t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
        xi = np.arctan2(t, np.cos(dlon))
        eta = np.arcsinh(np.sin(dlon) / np.sqrt(t * t + np.cos(dlon) ** 2))
        xi_s, eta_s = xi, eta
        for j, aj in enumerate(alpha, start=1):
            xi_s = xi_s + aj * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
            eta_s = eta_s + aj * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    easting = proj.false_easting + proj.k0 * big_a * eta_s
    northing = proj.false_northing + proj.k0 * big_a * xi_s
    return easting, northing


def tm_inverse(easting, northing, proj: TMProjection = EPSG_4547, newton_iters: int = 5):
    """Projected (m) -> geographic (lon_deg, lat_deg)."""
    rect_a, _, beta = _series_coeffs(proj.f)
    big_a = proj.a * rect_a
    e = math.sqrt(proj.f * (2.0 - proj.f))
    e2 = e * e
    if _is_tensor(easting):
        xi = (northing - proj.false_northing) / (proj.k0 * big_a)
        eta = (easting - proj.false_easting) / (proj.k0 * big_a)
        xi_p, eta_p = xi, eta
        for j, bj in enumerate(beta, start=1):
            xi_p = xi_p - bj * torch.sin(2 * j * xi) * torch.cosh(2 * j * eta)
            eta_p = eta_p - bj * torch.cos(2 * j * xi) * torch.sinh(2 * j * eta)
        dlon = torch.atan2(torch.sinh(eta_p), torch.cos(xi_p))
        tau_p = torch.sin(xi_p) / torch.sqrt(torch.sinh(eta_p) ** 2 + torch.cos(xi_p) ** 2)
        tau = tau_p / (1.0 - e2)
        for _ in range(newton_iters):
            sig = torch.sinh(e * torch.atanh(e * tau / torch.sqrt(1.0 + tau * tau)))
            f_val = tau * torch.sqrt(1.0 + sig * sig) - sig * torch.sqrt(1.0 + tau * tau) - tau_p
            dtau = (torch.sqrt((1.0 + sig * sig) * (1.0 + tau * tau)) - sig * tau) * (
                1.0 - e2
            ) * torch.sqrt(1.0 + tau * tau) / (1.0 + (1.0 - e2) * tau * tau)
            tau = tau - f_val / dtau
        return proj.lon0_deg + torch.rad2deg(dlon), torch.rad2deg(torch.atan(tau))
    xi = (np.asarray(northing) - proj.false_northing) / (proj.k0 * big_a)
    eta = (np.asarray(easting) - proj.false_easting) / (proj.k0 * big_a)
    xi_p, eta_p = xi, eta
    for j, bj in enumerate(beta, start=1):
        xi_p = xi_p - bj * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - bj * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    dlon = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    tau_p = np.sin(xi_p) / np.sqrt(np.sinh(eta_p) ** 2 + np.cos(xi_p) ** 2)
    # Newton-solve tau'(tau) = tau*sqrt(1+sigma^2) - sigma*sqrt(1+tau^2)
    tau = tau_p / (1.0 - e2)
    for _ in range(newton_iters):
        sig = np.sinh(e * np.arctanh(e * tau / np.sqrt(1.0 + tau * tau)))
        f_val = tau * np.sqrt(1.0 + sig * sig) - sig * np.sqrt(1.0 + tau * tau) - tau_p
        dtau = (np.sqrt((1.0 + sig * sig) * (1.0 + tau * tau)) - sig * tau) * (
            1.0 - e2
        ) * np.sqrt(1.0 + tau * tau) / (1.0 + (1.0 - e2) * tau * tau)
        tau = tau - f_val / dtau
    lat = np.degrees(np.arctan(tau))
    lon = proj.lon0_deg + np.degrees(dlon)
    return lon, lat


def cgcs2000_to_wgs84(easting, northing):
    """EPSG:4547 -> EPSG:4326 lon/lat (degrees); the datum shift is null,
    so this is the inverse TM projection."""
    return tm_inverse(easting, northing, EPSG_4547)


def wgs84_to_cgcs2000(lon_deg, lat_deg):
    return tm_forward(lon_deg, lat_deg, EPSG_4547)


@dataclasses.dataclass(frozen=True)
class LocalTaylor2D:
    """Second-order local expansion of a smooth R^2 -> R^2 map.

    Raw f32 evaluation of the TM series loses ~10 m at CGCS2000 easting
    magnitudes (~5e5); so the expansion is built around a tile reference
    point in f64 on the host (one call), and only origin-relative deltas
    are evaluated in f32 on the device.  The quadratic term's truncation
    error is < 1e-9 deg over a +-2 km tile; f32 rounding on the small
    deltas is ~1e-9 deg (~0.1 mm).
    """

    x0: float
    y0: float
    u0: float  # f64 outputs at the reference point (host-side adds)
    v0: float
    cu: np.ndarray  # f64[5]: du = cu . [dx, dy, dx^2, dx dy, dy^2]
    cv: np.ndarray

    def eval_delta(self, dx, dy):
        """(dx, dy) -> (du, dv) output deltas relative to (u0, v0): in f64
        for numpy inputs; for tensors with the coefficients rounded to f32,
        as the JAX module evaluates them on the device.  On tensors each
        product feeds the running sum through one fused multiply-add, as
        XLA:CPU compiles the jitted sum: c1 dy is rounded, then
        fma(c0, dx, .), then fma(c2, dx^2, .), fma(c3, dx dy, .) and
        fma(c4, dy^2, .) with the squares and the cross product rounded."""
        if _is_tensor(dx):
            def delta(c):
                c = torch.tensor(c, dtype=torch.float32, device=dx.device)
                s = fma_f32(c[0], dx, c[1] * dy)
                for ci, t in zip(c[2:], (dx * dx, dx * dy, dy * dy)):
                    s = fma_f32(ci, t, s)
                return s

            return delta(self.cu), delta(self.cv)
        dx, dy, cu, cv = np.asarray(dx), np.asarray(dy), self.cu, self.cv
        terms = [dx, dy, dx * dx, dx * dy, dy * dy]
        du = sum(c * t for c, t in zip(cu, terms))
        dv = sum(c * t for c, t in zip(cv, terms))
        return du, dv

    def __call__(self, x, y):
        """Full evaluation (host f64, or device tensors + f64 constants)."""
        if not _is_tensor(x):
            x, y = np.asarray(x), np.asarray(y)
        du, dv = self.eval_delta(x - self.x0, y - self.y0)
        return self.u0 + du, self.v0 + dv


def local_taylor(fn, x0: float, y0: float, h: float = 128.0) -> LocalTaylor2D:
    """Build a LocalTaylor2D of fn(x, y) -> (u, v) via f64 central
    differences with step h (meters for projected inputs)."""
    def g(x, y):
        u, v = fn(np.float64(x), np.float64(y))
        return np.array([np.float64(u), np.float64(v)])

    f0 = g(x0, y0)
    fx = (g(x0 + h, y0) - g(x0 - h, y0)) / (2 * h)
    fy = (g(x0, y0 + h) - g(x0, y0 - h)) / (2 * h)
    fxx = (g(x0 + h, y0) - 2 * f0 + g(x0 - h, y0)) / (h * h)
    fyy = (g(x0, y0 + h) - 2 * f0 + g(x0, y0 - h)) / (h * h)
    fxy = (
        g(x0 + h, y0 + h) - g(x0 + h, y0 - h) - g(x0 - h, y0 + h) + g(x0 - h, y0 - h)
    ) / (4 * h * h)
    cu = np.array([fx[0], fy[0], fxx[0] / 2, fxy[0], fyy[0] / 2])
    cv = np.array([fx[1], fy[1], fxx[1] / 2, fxy[1], fyy[1] / 2])
    return LocalTaylor2D(float(x0), float(y0), float(f0[0]), float(f0[1]), cu, cv)


def local_cgcs2000_to_wgs84(e0: float, n0: float, h: float = 128.0) -> LocalTaylor2D:
    """Device-evaluable EPSG:4547 -> lon/lat around a tile origin."""
    return local_taylor(lambda e, n: tm_inverse(e, n, EPSG_4547), e0, n0, h)


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle distance (m), R = 6371 km, broadcasting over inputs, as
    the reference's matcher computes it."""
    if _is_tensor(lat1):
        lat1, lon1, lat2, lon2 = (torch.deg2rad(v) for v in (lat1, lon1, lat2, lon2))
        dlat = lat2 - lat1
        dlon = lon2 - lon1
        a = (torch.sin(dlat / 2) ** 2
             + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2) ** 2)
        return _EARTH_R_M * 2.0 * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a))
    lat1, lon1, lat2, lon2 = (np.radians(np.asarray(v)) for v in (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return _EARTH_R_M * 2.0 * np.arctan2(np.sqrt(a), np.sqrt(1.0 - a))


def haversine_matrix(lats1, lons1, lats2, lons2):
    """Pairwise distances [len(1), len(2)] in meters."""
    if not _is_tensor(lats1):
        lats1, lons1, lats2, lons2 = (np.asarray(v) for v in (lats1, lons1, lats2, lons2))
    return haversine_m(lats1[:, None], lons1[:, None], lats2[None, :], lons2[None, :])


@contextlib.contextmanager
def _full_f32_matmul():
    """Matmuls in full float32 (no TF32) while the block runs."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@dataclasses.dataclass(frozen=True)
class GeoidGrid:
    """Regular lat/lon geoid-undulation grid (row 0 at lat0, increasing)."""

    lat0: float
    lon0: float
    dlat: float
    dlon: float
    values: Any  # f32[nlat, nlon], numpy or a tensor

    def interp(self, lat_deg, lon_deg):
        """Bilinear undulation N(lat, lon) in meters (clamped at the lat
        edges).  On global grids (nlon*dlon spans ~360 deg) longitude is
        wrapped into the grid window so -180..180 and 0..360 conventions
        both work; on regional grids queries clip in the grid's native
        window (wrapping would map points just west of lon0 to the far
        east edge)."""
        if _is_tensor(lat_deg):
            vals = torch.as_tensor(self.values, device=lat_deg.device)
            nlat, nlon = vals.shape
            fi = (lat_deg - self.lat0) / self.dlat
            lon = lon_deg
            if nlon * self.dlon >= 360.0 - 1e-6:
                lon = torch.remainder(lon - self.lon0, 360.0) + self.lon0
            fj = (lon - self.lon0) / self.dlon
            fi = torch.clamp(fi, 0.0, nlat - 1.000001)
            fj = torch.clamp(fj, 0.0, nlon - 1.000001)
            # in float32 the clamp's upper bound can round up to the last
            # row: the gathers clamp their indices, as XLA's do
            i0 = torch.floor(fi).long()
            j0 = torch.floor(fj).long()
            wi = fi - i0
            wj = fj - j0
            i1 = torch.clamp(i0 + 1, max=nlat - 1)
            j1 = torch.clamp(j0 + 1, max=nlon - 1)
        else:
            vals = np.asarray(self.values)
            nlat, nlon = vals.shape
            fi = (np.asarray(lat_deg) - self.lat0) / self.dlat
            lon = np.asarray(lon_deg)
            if nlon * self.dlon >= 360.0 - 1e-6:
                lon = np.mod(lon - self.lon0, 360.0) + self.lon0
            fj = (lon - self.lon0) / self.dlon
            fi = np.clip(fi, 0.0, nlat - 1.000001)
            fj = np.clip(fj, 0.0, nlon - 1.000001)
            i0 = np.floor(fi).astype(np.int32)
            j0 = np.floor(fj).astype(np.int32)
            wi = fi - i0
            wj = fj - j0
            i1, j1 = i0 + 1, j0 + 1
        v00 = vals[i0, j0]
        v01 = vals[i0, j1]
        v10 = vals[i1, j0]
        v11 = vals[i1, j1]
        return (
            v00 * (1 - wi) * (1 - wj)
            + v01 * (1 - wi) * wj
            + v10 * wi * (1 - wj)
            + v11 * wi * wj
        )


@dataclasses.dataclass(frozen=True)
class GeoidPatch:
    """Gather-free local window of a GeoidGrid.

    A K x K window extracted on the host evaluates the same piecewise-
    bilinear surface as hat-basis forms u(fi)^T W q(fj): two [N, K]
    elementwise basis builds and one skinny [N, K] x [K, K] matmul, in full
    float32 (no TF32).  Exact (to f32 summation) against GeoidGrid.interp
    for queries inside the window; queries outside clamp to the window
    edge.  ``interp(lat, lon)`` as GeoidGrid's, so every
    ellipsoid_to_orthometric caller can pass a patch instead of the grid.
    """

    lat0: float
    lon0: float
    dlat: float
    dlon: float
    values: Any  # f32[K, K] window, numpy or a tensor

    def interp(self, lat_deg, lon_deg):
        if _is_tensor(lat_deg):
            vals = torch.as_tensor(self.values, device=lat_deg.device)
            k, k2 = vals.shape
            scalar = lat_deg.dim() == 0
            fi = (torch.atleast_1d(lat_deg) - self.lat0) / self.dlat
            fj = (torch.atleast_1d(lon_deg) - self.lon0) / self.dlon
            fi = torch.clamp(fi, 0.0, k - 1.000001)
            fj = torch.clamp(fj, 0.0, k2 - 1.000001)
            grid_a = torch.arange(k, dtype=torch.float32, device=vals.device)
            grid_b = torch.arange(k2, dtype=torch.float32, device=vals.device)
            # hat (tent) basis: exactly two adjacent nonzeros per row, so
            # u @ W @ q reproduces bilinear interpolation exactly
            u = torch.clamp(1.0 - (fi[:, None] - grid_a[None, :]).abs(), min=0.0)
            q = torch.clamp(1.0 - (fj[:, None] - grid_b[None, :]).abs(), min=0.0)
            with _full_f32_matmul():
                uw = u @ vals.to(u.dtype)
            out = (uw * q).sum(dim=-1)
            return out[0] if scalar else out
        vals = np.asarray(self.values)
        k = vals.shape[0]
        fi = (np.atleast_1d(np.asarray(lat_deg)) - self.lat0) / self.dlat
        fj = (np.atleast_1d(np.asarray(lon_deg)) - self.lon0) / self.dlon
        scalar = np.asarray(lat_deg).ndim == 0
        fi = np.clip(fi, 0.0, k - 1.000001)
        fj = np.clip(fj, 0.0, vals.shape[1] - 1.000001)
        grid_a = np.arange(k, dtype=np.float32)
        grid_b = np.arange(vals.shape[1], dtype=np.float32)
        u = np.maximum(0.0, 1.0 - np.abs(fi[:, None] - grid_a[None, :]))
        q = np.maximum(0.0, 1.0 - np.abs(fj[:, None] - grid_b[None, :]))
        uw = u @ vals
        out = np.sum(uw * q, axis=-1)
        return out[0] if scalar else out


def grid_window(grid: GeoidGrid, lat_c: float, lon_c: float,
                half_cells: int = 8) -> GeoidPatch:
    """Extract a (2*half_cells) x (2*half_cells) GeoidPatch centered on
    (lat_c, lon_c), clamped inside the grid (and wrapped in longitude on
    global grids, matching GeoidGrid.interp's convention).  The window's
    values are numpy float32."""
    vals = np.asarray(grid.values.cpu() if _is_tensor(grid.values) else grid.values)
    nlat, nlon = vals.shape
    lon_q = lon_c
    if nlon * grid.dlon >= 360.0 - 1e-6:
        lon_q = (lon_c - grid.lon0) % 360.0 + grid.lon0
    k = 2 * half_cells
    i_c = int(round((lat_c - grid.lat0) / grid.dlat))
    j_c = int(round((lon_q - grid.lon0) / grid.dlon))
    i0 = max(0, min(i_c - half_cells, nlat - k))
    j0 = max(0, min(j_c - half_cells, nlon - k))
    return GeoidPatch(
        lat0=grid.lat0 + i0 * grid.dlat,
        lon0=grid.lon0 + j0 * grid.dlon,
        dlat=grid.dlat,
        dlon=grid.dlon,
        values=np.asarray(vals[i0:i0 + k, j0:j0 + k], np.float32),
    )


def ellipsoid_to_orthometric(lat_deg, lon_deg, h_ellip,
                             geoid: GeoidGrid | GeoidPatch | None,
                             region_n_value: float = 25.0):
    """h_ortho = h_ellip - N.  With no grid, fall back to the regional
    empirical N (the reference's default 25 m)."""
    if not _is_tensor(h_ellip):
        h_ellip = np.asarray(h_ellip)
    if geoid is None:
        return h_ellip - region_n_value
    return h_ellip - geoid.interp(lat_deg, lon_deg)


def greedy_match_arrays(
    g_lat, g_lon, g_h, p_lat, p_lon, p_h,
    distance_threshold: float = 50.0,
    height_threshold: float = 100.0,
):
    """Array form of the reference's greedy first-match loop: for each GIM
    tower, the first point-cloud tower (lowest index) within both the
    haversine and height thresholds; point-cloud towers are not consumed.

    Returns (matched bool[G], first int32[G]); ``first[i]`` is meaningful
    only where ``matched[i]``.  One [G, P] distance matrix and a per-row
    argmax of the first True."""
    dist = haversine_matrix(g_lat, g_lon, p_lat, p_lon)
    if _is_tensor(g_lat):
        ok = (dist <= distance_threshold) & (
            (g_h[:, None] - p_h[None, :]).abs() <= height_threshold)
        # argmax over bool is not defined for every device: take it over int8
        return ok.any(dim=1), torch.argmax(ok.to(torch.int8), dim=1).to(torch.int32)
    ok = (dist <= distance_threshold) & (
        np.abs(np.asarray(g_h)[:, None] - np.asarray(p_h)[None, :]) <= height_threshold)
    return ok.any(axis=1), np.argmax(ok, axis=1).astype(np.int32)
