"""EPSG:4547 (CGCS2000, 3-degree Gauss-Kruger, central meridian 114 E,
scale 1, false easting 500 km) and the haversine distance, in plain NumPy.

Written for the benchmark from the classical series of Snyder, "Map
Projections - A Working Manual", USGS Professional Paper 1395 (1987),
pp. 61-64: the forward formulas (8-9) to (8-10) and the inverse through
the footpoint latitude, (3-21), (7-19) and (8-17) to (8-25).  They are a
different formulation from the program's (Krueger's n-series with a Newton
solve), so a fault in either shows as a gap between the two; both are far
under a millimetre from the true projection within 3 degrees of the
central meridian.  The benchmark makes its GIM inputs with ``tm_inverse``
and the run-all reference converts its tower centres with it.
"""

from __future__ import annotations

import numpy as np

A = 6378137.0
F = 1.0 / 298.257222101
E2 = F * (2.0 - F)
EP2 = E2 / (1.0 - E2)
LON0_DEG, FALSE_EASTING = 114.0, 500_000.0
EARTH_R_M = 6371.0 * 1000.0  # the upstream tool's haversine radius


def _meridian_arc(lat):
    """Distance along the meridian from the equator to lat (radians), (3-21)."""
    e4, e6 = E2 * E2, E2 * E2 * E2
    return A * ((1 - E2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * lat
                - (3 * E2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * lat)
                + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * lat)
                - (35 * e6 / 3072) * np.sin(6 * lat))


def tm_forward(lon_deg, lat_deg):
    """(lon_deg, lat_deg) -> projected (easting, northing) metres."""
    lat = np.radians(np.asarray(lat_deg, np.float64))
    a_ = (np.radians(np.asarray(lon_deg, np.float64)) - np.radians(LON0_DEG)) * np.cos(lat)
    n = A / np.sqrt(1 - E2 * np.sin(lat) ** 2)
    t = np.tan(lat) ** 2
    c = EP2 * np.cos(lat) ** 2
    x = n * (a_ + (1 - t + c) * a_**3 / 6
             + (5 - 18 * t + t * t + 72 * c - 58 * EP2) * a_**5 / 120)
    y = _meridian_arc(lat) + n * np.tan(lat) * (
        a_**2 / 2 + (5 - t + 9 * c + 4 * c * c) * a_**4 / 24
        + (61 - 58 * t + t * t + 600 * c - 330 * EP2) * a_**6 / 720)
    return x + FALSE_EASTING, y


def tm_inverse(easting, northing):
    """Projected metres -> (lon_deg, lat_deg)."""
    x = np.asarray(easting, np.float64) - FALSE_EASTING
    e4, e6 = E2 * E2, E2 * E2 * E2
    mu = np.asarray(northing, np.float64) / (A * (1 - E2 / 4 - 3 * e4 / 64 - 5 * e6 / 256))
    e1 = (1 - np.sqrt(1 - E2)) / (1 + np.sqrt(1 - E2))
    lat1 = (mu + (3 * e1 / 2 - 27 * e1**3 / 32) * np.sin(2 * mu)
            + (21 * e1**2 / 16 - 55 * e1**4 / 32) * np.sin(4 * mu)
            + (151 * e1**3 / 96) * np.sin(6 * mu)
            + (1097 * e1**4 / 512) * np.sin(8 * mu))
    s2 = np.sin(lat1) ** 2
    c1 = EP2 * np.cos(lat1) ** 2
    t1 = np.tan(lat1) ** 2
    n1 = A / np.sqrt(1 - E2 * s2)
    r1 = A * (1 - E2) / (1 - E2 * s2) ** 1.5
    d = x / n1
    lat = lat1 - (n1 * np.tan(lat1) / r1) * (
        d**2 / 2 - (5 + 3 * t1 + 10 * c1 - 4 * c1 * c1 - 9 * EP2) * d**4 / 24
        + (61 + 90 * t1 + 298 * c1 + 45 * t1 * t1 - 252 * EP2 - 3 * c1 * c1) * d**6 / 720)
    lon = (d - (1 + 2 * t1 + c1) * d**3 / 6
           + (5 - 2 * c1 + 28 * t1 - 3 * c1 * c1 + 8 * EP2 + 24 * t1 * t1) * d**5 / 120
           ) / np.cos(lat1)
    return LON0_DEG + np.degrees(lon), np.degrees(lat)


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle distance in metres on the upstream tool's sphere."""
    p1, l1, p2, l2 = (np.radians(np.asarray(v, np.float64)) for v in (lat1, lon1, lat2, lon2))
    h = np.sin((p2 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin((l2 - l1) / 2) ** 2
    return 2.0 * EARTH_R_M * np.arcsin(np.sqrt(np.minimum(h, 1.0)))
