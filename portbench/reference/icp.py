"""Plain float64 PyTorch reference of ``correct(icp=True)`` (the 校对 step
with ICP) on one corridor section.

Written from the published description of the program's refinement
(``models/refine.py`` and ``ops/registration.py``'s docstrings) and the
upstream match (``utils/table_match_gim.py:145,190-193``), with no code of
the program:

  1. pairing: each tower's box centre to longitude and latitude
     (EPSG:4547, ``geo.py``) and orthometric height (ellipsoidal minus the
     regional N); each GIM tower in order takes the first tower within the
     distance (haversine) and height thresholds; a tower may pair more
     than once;
  2. every paired tower with at least 16 member rows is refined: an
     idealised frame of ``levels`` square rings of 4 * ``per_edge`` points
     whose half-width tapers linearly to (1 - ``taper``) at the top, centred
     on the box centre, at the GIM tower's 杆塔高 (the tower's own height
     without one) and the box's smaller horizontal extent, turned by the
     tower's yaw; the member rows taken to the box centre;
  3. three stages of max(iterations // 3, 5) iterations at radius inf,
     4 * max_corr_dist and max_corr_dist; each stage starts from the
     identity with the target re-based by the translation so far;
  4. an iteration: for each frame row moved by (R, t), the nearest member
     row by direct |a - b|^2 (the first on a tie); weights 1 + 1e-9 within
     the radius and 1e-9 beyond, normalised; weighted Kabsch, the
     reflection fixed by det(V U^T);
  5. a final sweep of each stage gives the rmse over the frame rows and the
     share of them within the radius;
  6. the refined centre is the box centre plus the three stages'
     translations; its BLHA is that centre's longitude, latitude and
     orthometric height, with the GIM tower's rotation.

Departures from the program: every number is float64 and the nearest
search takes |a - b|^2 directly (the program: float32 and |a|^2 + |b|^2 -
2 a.b, rounded); each tower is solved alone, so nothing is padded.
TF32 is off.  Imports nothing of the program or of JAX.

``lower="bfloat16"``: the control, the tower-local coordinates (the
frame, and the member rows after each re-basing) rounded to bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import geo

f64 = torch.float64


def frame(height: float, width: float, yaw: float, levels: int, per_edge: int,
          taper: float) -> np.ndarray:
    """The idealised tapered frame, float64[levels * 4 * per_edge, 3]."""
    rows = []
    for z in np.linspace(0.0, 1.0, levels):
        half = width / 2.0 * (1.0 - taper * z)
        s = np.linspace(-half, half, per_edge)
        lo, hi = np.full(per_edge, -half), np.full(per_edge, half)
        ring = np.concatenate([np.column_stack([s, lo]), np.column_stack([s, hi]),
                               np.column_stack([lo, s]), np.column_stack([hi, s])])
        rows.append(np.column_stack([ring, np.full(len(ring), z * height - height / 2.0)]))
    out = np.concatenate(rows)
    c, s = math.cos(yaw), math.sin(yaw)
    x, y = out[:, 0].copy(), out[:, 1].copy()
    out[:, 0], out[:, 1] = x * c - y * s, x * s + y * c
    return out


def nearest(a, b):
    """For each row of a [N, 3], the index and |a - b|^2 of its nearest row
    of b [M, 3]."""
    d2 = (a[:, None, :] - b[None, :, :]).square().sum(dim=-1)
    best, idx = d2.min(dim=1)
    return idx, best


def kabsch(src, dst, w):
    """R, t minimising sum w |R src + t - dst|^2, the reflection fixed."""
    w = w / w.sum()
    mu_s, mu_d = (w[:, None] * src).sum(dim=0), (w[:, None] * dst).sum(dim=0)
    h = ((src - mu_s) * w[:, None]).T @ (dst - mu_d)
    u, _, vt = torch.linalg.svd(h)
    v, ut = vt.T, u.T
    flip = torch.ones(3, dtype=f64, device=src.device)
    flip[2] = torch.sign(torch.linalg.det(v @ ut))
    r = (v * flip) @ ut
    return r, mu_d - r @ mu_s


def icp(src, dst, iters: int, radius: float):
    """One stage: (t [3], rmse, inlier share) of src aligned onto dst."""
    r = torch.eye(3, dtype=f64, device=src.device)
    t = torch.zeros(3, dtype=f64, device=src.device)
    lim2 = radius * radius
    for _ in range(iters):
        idx, d2 = nearest(src @ r.T + t, dst)
        w = (d2 <= lim2).to(f64) + 1e-9
        r, t = kabsch(src, dst[idx], w)
    _, d2 = nearest(src @ r.T + t, dst)
    return t, float(d2.mean().sqrt()), float((d2 <= lim2).to(f64).mean())


def _round(x: torch.Tensor, lower) -> torch.Tensor:
    return x.to(torch.bfloat16).to(f64) if lower == "bfloat16" else x


def refine(tower: dict, cloud: np.ndarray, height: float | None, icp_cfg: dict, device,
           lower=None) -> dict:
    """The refined centre (float64[3]), rmse and inlier share of one tower."""
    tp = icp_cfg["template"]
    src = torch.as_tensor(frame(height or tower["height"], float(tower["extent"][1]),
                                tower["angle"], tp["levels"], tp["per_edge"], tp["taper"]),
                          dtype=f64, device=device)
    src = _round(src, lower)
    centre = np.asarray(tower["center"], np.float64)
    dst = torch.as_tensor(np.asarray(cloud, np.float64) - centre, dtype=f64, device=device)
    d = icp_cfg["max_corr_dist_m"]
    it = max(icp_cfg["iterations"] // 3, 5)
    shift = torch.zeros(3, dtype=f64, device=device)
    for radius in (math.inf, 4.0 * d, d):
        t, rmse, inl = icp(src, _round(dst - shift, lower), it, radius)
        shift = shift + t
    return dict(center=centre + shift.cpu().numpy(), rmse=rmse, inlier_frac=inl)


def pairs(towers, gim_towers, gim_cfg: dict) -> list:
    """[(GIM index, tower index)] by the upstream rule, on the box centres."""
    if not towers:
        return []
    cen = np.array([t["center"] for t in towers], np.float64)
    lon, lat = geo.tm_inverse(cen[:, 0], cen[:, 1])
    h = cen[:, 2] - gim_cfg["region_n_value"]
    out = []
    for gi, g in enumerate(gim_towers):
        ok = (geo.haversine_m(g["lat"], g["lng"], lat, lon) <= gim_cfg["distance_threshold_m"]) \
            & (np.abs(g["h"] - h) <= gim_cfg["height_threshold_m"])
        if ok.any():
            out.append((gi, int(np.argmax(ok))))
    return out


def run(inputs: dict, config: dict, lower: str | None = None, device=None) -> dict:
    """The refined towers of one section in the check's reference form
    (``check.from_reference``), indexed by tower label, with ``blha``
    {GIM tower id: (lat, lng, h, r)} of the refined pairs, and ``pairs``,
    ``rmse`` and ``inlier_frac`` by label for the tests."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    towers, clouds, gim_towers = inputs["towers"], inputs["clouds"], inputs["gim_towers"]
    gim_cfg = config["gim"]
    matched = pairs(towers, gim_towers, gim_cfg)
    heights = {pi: gim_towers[gi].get("height") for gi, pi in matched}
    refined = {}
    for _, pi in matched:
        if pi not in refined and clouds[pi] is not None and len(clouds[pi]) >= 16:
            refined[pi] = refine(towers[pi], clouds[pi], heights[pi], config["icp"], device,
                                 lower)
    k = max((t["label"] for t in towers), default=-1) + 1
    accepted = np.zeros(k, bool)
    center, extent = np.zeros((k, 3)), np.zeros((k, 3))
    north, count = np.zeros(k), np.zeros(k, np.int64)
    rmse, inlier = {}, {}
    for pi, r in refined.items():
        t = towers[pi]
        lab = t["label"]
        accepted[lab] = True
        center[lab], extent[lab] = r["center"], t["extent"]
        north[lab], count[lab] = t["north"], t["count"]
        rmse[lab], inlier[lab] = r["rmse"], r["inlier_frac"]
    blha = {}
    for gi, pi in matched:
        if pi in refined:
            c = refined[pi]["center"]
            lon, lat = geo.tm_inverse(c[0], c[1])
            g = gim_towers[gi]
            blha[g["id"]] = (float(lat), float(lon), float(c[2] - gim_cfg["region_n_value"]),
                             float(g["r"]))
    return dict(labels=np.zeros(0, np.int64), ground_keep=np.zeros(0, bool), accepted=accepted,
                center=center, extent=extent, north=north, count=count, blha=blha,
                pairs=matched, rmse=rmse, inlier_frac=inlier)
