"""Post-hoc tower validation and quality-ranked deduplication.

Counterpart of ``pointcloudhookup_tpu/utils/validate.py`` (host numpy, the
same operations): the h * w * log(points + 1) quality metric, the two-tier
dedup that merges towers across streamed tiles (a strict radius where the
higher-quality tower wins, a loose radius that skips the newcomer), the
``verify_towers`` sanity checks (pairwise proximity, size bounds, a point
floor) and the ground-truth comparison against known tower positions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def tower_quality(height: float, width: float, num_points: int) -> float:
    """Quality metric h * w * log(points + 1)."""
    return float(height) * float(width) * float(np.log(num_points + 1))


def quality_dedup(
    towers: Sequence,
    strict_radius: float = 2.0,
    loose_radius: float = 30.0,
) -> list:
    """Two-tier dedup: within strict_radius keep the higher-quality
    tower (replacing a previously accepted one if beaten); within
    loose_radius skip the newcomer."""
    kept: list = []
    for t in towers:
        center = np.asarray(t.center, float)
        replaced = False
        skip = False
        for i, k in enumerate(kept):
            d = float(np.linalg.norm(center - np.asarray(k.center, float)))
            if d < strict_radius:
                if tower_quality(t.height, t.width, t.num_points) > tower_quality(
                    k.height, k.width, k.num_points
                ):
                    kept[i] = t
                replaced = True
                break
            if d < loose_radius:
                skip = True
                break
        if not replaced and not skip:
            kept.append(t)
    return kept


def verify_towers(
    towers: Sequence,
    min_pair_distance: float = 5.0,
    min_height: float = 15.0,
    max_width: float = 50.0,
    min_width: float = 8.0,
    min_num_points: int = 50,
) -> list[str]:
    """Sanity checks returning human-readable warnings (never raises)."""
    warnings = []
    centers = np.array([np.asarray(t.center, float) for t in towers]) if towers else np.zeros((0, 3))
    for i, t in enumerate(towers):
        if not (t.height > min_height):
            warnings.append(f"{t.id}: height {t.height:.1f} below minimum {min_height}")
        if not (min_width < t.width < max_width):
            warnings.append(f"{t.id}: width {t.width:.1f} outside ({min_width}, {max_width})")
        if t.num_points < min_num_points:
            warnings.append(f"{t.id}: only {t.num_points} points")
        for j in range(i + 1, len(towers)):
            d = float(np.linalg.norm(centers[i] - centers[j]))
            if d < min_pair_distance:
                warnings.append(
                    f"{t.id} and {towers[j].id} are {d:.1f} m apart (< {min_pair_distance})"
                )
    return warnings


def check_against_known_towers(
    towers: Sequence,
    known_positions: Sequence,
    tolerance: float = 10.0,
) -> dict:
    """Ground-truth comparison: for each known (x, y) position, the
    nearest detected tower within tolerance counts as a hit.  Returns
    dict(hits, misses, extra, errors) — the KNOWN_TOWERS hook."""
    known = np.asarray(known_positions, float).reshape(-1, 2)
    det = (
        np.array([np.asarray(t.center, float)[:2] for t in towers])
        if towers
        else np.zeros((0, 2))
    )
    hits = []
    errors = []
    used = set()
    for kx, ky in known:
        if not len(det):
            continue
        d = np.linalg.norm(det - [kx, ky], axis=1)
        j = int(np.argmin(d))
        if d[j] <= tolerance:
            hits.append(j)
            used.add(j)
            errors.append(float(d[j]))
    return dict(
        hits=len(hits),
        misses=len(known) - len(hits),
        extra=len(det) - len(used),
        errors=errors,
    )
