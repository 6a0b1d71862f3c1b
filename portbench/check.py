"""The comparison that decides ``correct``.

Each tile that a request of the window returned is held against the plain
reference (``reference/``) run once over the same input.  Both sides are
first put in one form (the entry kind's ``form`` for the program's
answer, ``from_reference`` for the reference's): per-row cluster labels and ground flags, the set of
accepted tower ids, and per tower its world centre, extents (long, short,
height), north angle and member count.  The numbers, each the worst over
the checked tiles:

* ``label_mismatch``: rows whose cluster id differs;
* ``ground_mismatch``: rows whose above-ground flag differs;
* ``centre_gap_m``: largest distance between the centres of a tower
  accepted on both sides; a tower accepted on one side only reads
  ``MISSING``.  Where the reference's least area is tied, within what
  float32 rounding can move, between neighbouring angles
  (``reference/exact.py::obb_stats``), the tower is compared at the tied
  angle nearest the program's (centre, extents and north angle);
* ``extent_gap_m``: largest difference of an extent of such a tower;
* ``north_gap_deg``: largest difference of its north angle (mod 360);
* ``count_gap``: largest difference of its member count; a tower accepted
  on one side only counts all its members;
* run-all only: ``downsample_gap_m``, the largest coordinate difference
  between the rows of the downsampled LAS (``MISSING`` when the row counts
  differ), and ``blha_gap_m``, the largest distance (haversine, or of
  height) between a GIM tower's written BLHA and the reference's
  (``MISSING`` when the towers or a rotation differ).

A number passes when it is at most its limit (the configuration's
``check``).  A tile fails when any number of its own is above its limit.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("label_mismatch", "ground_mismatch", "centre_gap_m", "extent_gap_m",
           "north_gap_deg", "count_gap")
MISSING = 1e9  # a gap of a tile that never came back (finite, so the line stays JSON)


def towers_form(accepted, center, extent, north, count, ties=None) -> dict:
    ids = [int(i) for i in np.flatnonzero(np.asarray(accepted))]
    out = {i: dict(center=np.asarray(center[i], np.float64),
                   extent=np.asarray(extent[i], np.float64),
                   north=float(north[i]), count=int(count[i])) for i in ids}
    if ties is not None:
        for i in ids:
            out[i]["ties"] = ties[i]
    return out


def from_reference(ref: dict) -> dict:
    out = dict(labels=np.asarray(ref["labels"]), ground_keep=np.asarray(ref["ground_keep"]),
               towers=towers_form(ref["accepted"], ref["center"], ref["extent"], ref["north"],
                                  ref["count"], ref.get("ties")))
    out.update({k: ref[k] for k in ("ds", "blha") if k in ref})
    return out


def nearest_tie(got: dict, ref: dict) -> dict:
    """The reference tower's answer at the tied angle nearest the
    program's north angle (its own when it has no tie)."""
    ties = ref.get("ties")
    if not ties or len(ties) < 2:
        return ref
    north, cxy, ext = min(ties, key=lambda c: abs((got["north"] - c[0] + 180.0) % 360.0 - 180.0))
    return dict(ref, north=north, center=np.r_[np.asarray(cxy, np.float64), ref["center"][2]],
                extent=np.r_[np.asarray(ext, np.float64), ref["extent"][2]])


def compare(got: dict | None, ref: dict) -> dict:
    """The numbers of one tile, got against ref (both in the common form);
    a tile with no answer (got None) differs in every row and tower."""
    if got is None:
        n = float(len(ref["labels"]))
        nums = dict(label_mismatch=n, ground_mismatch=n, centre_gap_m=MISSING,
                    extent_gap_m=MISSING, north_gap_deg=180.0, count_gap=MISSING)
        nums.update({name: MISSING for key, name in (("ds", "downsample_gap_m"),
                                                     ("blha", "blha_gap_m")) if key in ref})
        return nums
    nums = {}
    for key, name in (("labels", "label_mismatch"), ("ground_keep", "ground_mismatch")):
        g, r = got[key], ref[key]
        if g is None or np.shape(g) != np.shape(r):
            nums[name] = float(len(r))  # missing or misshapen: every row differs
        else:
            nums[name] = float(np.count_nonzero(np.asarray(g) != np.asarray(r)))
    gt, rt = got["towers"], ref["towers"]
    common = sorted(set(gt) & set(rt))
    rt = {**rt, **{i: nearest_tie(gt[i], rt[i]) for i in common}}
    one_side = [t for side, other in ((gt, rt), (rt, gt)) for i, t in side.items()
                if i not in other]
    nums["centre_gap_m"] = MISSING if one_side else max(
        (float(np.linalg.norm(gt[i]["center"] - rt[i]["center"])) for i in common), default=0.0)
    nums["extent_gap_m"] = max((float(np.abs(gt[i]["extent"] - rt[i]["extent"]).max())
                                for i in common), default=0.0)
    nums["north_gap_deg"] = max((abs((gt[i]["north"] - rt[i]["north"] + 180.0) % 360.0 - 180.0)
                                 for i in common), default=0.0)
    nums["count_gap"] = max([float(abs(gt[i]["count"] - rt[i]["count"])) for i in common]
                            + [float(t["count"]) for t in one_side], default=0.0)
    if "ds" in ref:
        g = got.get("ds")
        nums["downsample_gap_m"] = (float(np.abs(g - ref["ds"]).max(initial=0.0))
                                    if g is not None and g.shape == ref["ds"].shape else MISSING)
    if "blha" in ref:
        nums["blha_gap_m"] = blha_gap(got.get("blha") or {}, ref["blha"])
    return nums


def blha_gap(got: dict, ref: dict) -> float:
    """Largest distance (haversine, and height) between the BLHA a GIM
    tower got and the reference's; MISSING for a tower on one side only or
    a rotation that differs."""
    from portbench import geo

    if set(got) != set(ref):
        return MISSING
    gap = 0.0
    for k, (lat, lng, h, r) in ref.items():
        glat, glng, gh, gr = got[k]
        gap = max(gap, float(geo.haversine_m(glat, glng, lat, lng)), abs(gh - h),
                  MISSING if gr != r else 0.0)
    return gap


def judge(per_tile: list, limits: dict) -> dict:
    """Worst numbers over the tiles, tiles failed, and whether all hold."""
    names = list(per_tile[0]) if per_tile else list(NUMBERS)
    missing = [n for n in names if n not in limits]
    if missing:
        raise KeyError(f"the configuration states no limit for {missing}")
    worst = {n: max((t[n] for t in per_tile), default=0.0) for n in names}
    failed = sum(1 for t in per_tile if any(t[n] > limits[n] for n in names))
    return dict(worst=worst, failed=failed, checked=len(per_tile),
                ok=bool(per_tile) and failed == 0)
