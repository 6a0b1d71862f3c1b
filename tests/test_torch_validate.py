"""The port's tower validation (``utils/validate.py``), mirroring the
validate half of ``tests/test_viz_and_validate.py``, and held bit-equal to
the JAX module on the same tower lists: the same quality floats, the same
towers kept in the same order, the same warnings and the same ground-truth
counts and errors (host numpy on both sides)."""

import numpy as np
import pytest

from pointcloudhookup_tpu.utils import validate as jvalidate
from pointcloudhookup_tpu_torch.models.towers import Tower
from pointcloudhookup_tpu_torch.utils.validate import (
    check_against_known_towers,
    quality_dedup,
    tower_quality,
    verify_towers,
)


def _tower(cx=0.0, cy=0.0, cz=20.0, h=35.0, w=12.0, n=1000, tid="t0"):
    return Tower(id=tid, center=np.array([cx, cy, cz]), extent=np.array([w, w * 0.8, h]),
                 height=h, width=w, north_angle=10.0, angle=0.3, num_points=n, label=0)


def test_quality_metric_and_dedup():
    good = _tower(n=5000, tid="good")
    bad = _tower(cx=1.0, n=100, tid="bad")
    far = _tower(cx=100.0, tid="far")
    near = _tower(cx=20.0, tid="near")
    assert tower_quality(35, 12, 5000) > tower_quality(35, 12, 100)
    ids = [t.id for t in quality_dedup([bad, good, far, near])]
    assert "good" in ids and "bad" not in ids
    assert "far" in ids and "near" not in ids


def test_verify_towers_warnings():
    ok = _tower(tid="ok")
    short = _tower(cx=200, h=10.0, tid="short")
    close_a = _tower(cx=400, tid="a")
    close_b = _tower(cx=402, tid="b")
    few = _tower(cx=600, n=10, tid="few")
    text = "\n".join(verify_towers([ok, short, close_a, close_b, few]))
    assert "short" in text and "height" in text
    assert "a and b" in text
    assert "few" in text and "points" in text
    assert "ok:" not in text


def test_known_towers_check():
    det = [_tower(cx=0), _tower(cx=100), _tower(cx=500)]
    res = check_against_known_towers(det, [(1.0, 0.0), (101.0, 0.0), (300.0, 0.0)])
    assert res["hits"] == 2 and res["misses"] == 1 and res["extra"] == 1
    assert all(e < 2.0 for e in res["errors"])


def _random_towers(seed, k=60):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (k, 2))
    return [
        _tower(cx=x, cy=y, cz=rng.uniform(0, 40), h=rng.uniform(5, 60), w=rng.uniform(4, 60),
               n=int(rng.integers(5, 20_000)), tid=f"t{i}")
        for i, (x, y) in enumerate(xy)
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validate_bit_equal_to_jax(seed):
    towers = _random_towers(seed)
    for t in towers[:8]:
        assert tower_quality(t.height, t.width, t.num_points) == jvalidate.tower_quality(
            t.height, t.width, t.num_points)
    for strict, loose in ((2.0, 30.0), (25.0, 60.0)):
        got = quality_dedup(towers, strict_radius=strict, loose_radius=loose)
        ref = jvalidate.quality_dedup(towers, strict_radius=strict, loose_radius=loose)
        assert [t.id for t in got] == [t.id for t in ref]
    assert verify_towers(towers) == jvalidate.verify_towers(towers)
    assert verify_towers([]) == jvalidate.verify_towers([]) == []
    known = np.random.default_rng(seed + 10).uniform(0, 400, (20, 2))
    got = check_against_known_towers(towers, known, tolerance=25.0)
    ref = jvalidate.check_against_known_towers(towers, known, tolerance=25.0)
    assert got == ref
    assert check_against_known_towers([], known) == jvalidate.check_against_known_towers([], known)
