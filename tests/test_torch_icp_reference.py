"""``correct(icp=True)`` of the port against the benchmark's plain float64
reference (``portbench/reference/icp.py``), on the CPU.

A seeded section of 5 towers of ~2,200 member rows (the benchmark cell
``icp50.correct`` cut small: 150,000 points) is extracted by the port; the
port's ``correct(icp=True, device="cpu")`` and the reference refine the
same towers, member rows and GIM towers (``portbench/entries/icp.py``).
Tolerances:

* refined centres within 1e-4 m: the frame and the member rows are float32
  tower-local coordinates of up to ~21 m, rounded by ~1e-6 m, and the
  sweeps carry that rounding (1e-6 m measured here) unless a near-tied
  correspondence swaps, which these sections never see;
* rmse within 1e-4 m, for the same reason;
* the inlier share within one frame row (1 / 280): a row whose distance
  lies within rounding of the radius may fall on either side.

The same reference in bfloat16 (tower-local coordinates rounded) breaks at
least one of them.  The reference alone recovers a planted rigid motion.
"""

import math

import numpy as np
import pytest
import torch

from portbench.drive import make_entry
from portbench.reference import icp as ref
from portbench.tests.test_portbench_icp import small_icp_info

CENTRE_TOL_M = 1e-4
RMSE_TOL_M = 1e-4
FRAME_ROWS = 280


@pytest.fixture(scope="module", params=[2**31 + 21, 3180000017], ids=["seed_a", "seed_b"])
def section(request, tmp_path_factory):
    """The port's correct(icp=True) on one section, what its
    refine_tower_centers returned inside it (by tower label), and the
    reference in float64 and in bfloat16."""
    from pointcloudhookup_tpu_torch.models import refine

    info = small_icp_info()
    entry = make_entry(info["config"], info["traffic"], request.param, "cpu",
                       str(tmp_path_factory.mktemp("icp")))
    inner, kept = refine.refine_tower_centers, []

    def capture(*args, **kwargs):
        kept.append(inner(*args, **kwargs))
        return kept[-1]
    try:
        entry.prepare()
        refine.refine_tower_centers = capture
        req = entry.request(0)
        refine.refine_tower_centers = inner
        towers = entry.sections[0]["towers"]
        inputs = entry.reference_input(0)
        return dict(result=req.outputs[0]["result"],
                    refined={int(towers[pi].label): r for pi, r in kept[0].items()},
                    ref=ref.run(inputs, entry.config, device="cpu"),
                    low=ref.run(inputs, entry.config, lower="bfloat16", device="cpu"))
    finally:
        refine.refine_tower_centers = inner
        entry.cleanup()


def test_same_pairs_and_refined_towers(section):
    r = section["ref"]
    assert section["result"].pairs == r["pairs"] and len(r["pairs"]) == 5
    assert set(section["refined"]) == set(np.flatnonzero(r["accepted"])) == set(r["rmse"])


def test_refined_centres_within_tolerance(section):
    r, res = section["ref"], section["result"]
    for lab, got in section["refined"].items():
        assert np.linalg.norm(got["center"] - r["center"][lab]) <= CENTRE_TOL_M, lab
    # correct() writes back the refined centres
    written = [c.original_center for c in res.converted_towers if c.icp_rmse is not None]
    assert sorted(map(tuple, written)) == sorted(tuple(g["center"]) for g in section["refined"].values())


def test_rmse_and_inlier_share_within_tolerance(section):
    r = section["ref"]
    for lab, got in section["refined"].items():
        assert abs(got["rmse"] - r["rmse"][lab]) <= RMSE_TOL_M, lab
        assert abs(got["inlier_frac"] - r["inlier_frac"][lab]) <= 1.0 / FRAME_ROWS + 1e-9, lab


def test_bfloat16_breaks_a_tolerance(section):
    r, low = section["ref"], section["low"]
    labs = sorted(r["rmse"])
    centre = max(np.linalg.norm(low["center"][k] - r["center"][k]) for k in labs)
    rmse = max(abs(low["rmse"][k] - r["rmse"][k]) for k in labs)
    inlier = max(abs(low["inlier_frac"][k] - r["inlier_frac"][k]) for k in labs)
    assert centre > CENTRE_TOL_M or rmse > RMSE_TOL_M or inlier > 1.0 / FRAME_ROWS


def _rot(axis, angle):
    c, s = math.cos(angle), math.sin(angle)
    i, j = [k for k in range(3) if k != axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


@pytest.mark.parametrize("kind", ["icp", "refine"])
def test_reference_recovers_a_planted_rigid_motion(kind):
    """float64 throughout: a motion smaller than half the rows' spacing
    pairs every row with its own image at the first sweep, and Kabsch
    solves it exactly."""
    rng = np.random.default_rng(5)
    t_true = np.array([0.31, -0.22, 0.14])
    if kind == "icp":
        src = rng.uniform(-10, 10, (300, 3))
        r_true = _rot(2, 0.02) @ _rot(0, 0.01)
        dst = src @ r_true.T + 0.1 * t_true
        t, rmse, inlier = ref.icp(torch.as_tensor(src), torch.as_tensor(dst), 10, 2.0)
        np.testing.assert_allclose(t.numpy(), 0.1 * t_true, rtol=0, atol=1e-9)
        assert rmse < 1e-9 and inlier == 1.0
        return
    cfg = small_icp_info()["config"]["icp"]
    tower = dict(center=np.array([450900.0, 3120700.0, 98.0]), extent=np.array([12.0, 11.0, 35.0]),
                 height=35.0, angle=0.3)
    tp = cfg["template"]
    frame = ref.frame(35.0, 11.0, 0.3, tp["levels"], tp["per_edge"], tp["taper"])
    cloud = frame + tower["center"] + t_true
    got = ref.refine(tower, cloud, None, cfg, "cpu")
    np.testing.assert_allclose(got["center"], tower["center"] + t_true, rtol=0, atol=1e-9)
    assert got["rmse"] < 1e-9 and got["inlier_frac"] == 1.0
