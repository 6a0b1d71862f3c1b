"""The plain references' own parts: the EPSG:4547 projection, the OBB
angle table and the area ties that rounding can flip."""

import json
import math
import os

import numpy as np
import pytest

from portbench import check, geo, harness
from portbench.reference import exact, fused

RNG = np.random.default_rng(0)
LON = 113.5 + RNG.uniform(-0.6, 0.6, 20000)
LAT = 28.2 + RNG.uniform(-0.3, 0.3, 20000)


def test_projection_round_trips():
    e, n = geo.tm_forward(LON, LAT)
    lon, lat = geo.tm_inverse(e, n)
    assert geo.haversine_m(LAT, LON, lat, lon).max() < 1e-3


def test_projection_agrees_with_the_programs_other_formulation():
    """A second witness: the program's Krueger series with its Newton
    solve and this file's footpoint-latitude series, written apart."""
    from pointcloudhookup_tpu_torch.ops import geo as program_geo

    e, n = (np.asarray(v, np.float64) for v in program_geo.tm_forward(LON, LAT))
    be, bn = geo.tm_forward(LON, LAT)
    assert max(np.abs(be - e).max(), np.abs(bn - n).max()) < 1e-3
    plon, plat = (np.asarray(v, np.float64) for v in program_geo.tm_inverse(e, n))
    lon, lat = geo.tm_inverse(e, n)
    assert geo.haversine_m(plat, plon, lat, lon).max() < 1e-3


def test_projection_fault_shows():
    """A wrong ellipsoid in either side moves a tower by metres, far over
    the 1 mm the two formulations agree to."""
    from pointcloudhookup_tpu_torch.ops import geo as program_geo

    e, n = geo.tm_forward(113.5, 28.2)
    lon, lat = program_geo.tm_inverse(float(e) + 1.0, float(n))
    assert geo.haversine_m(28.2, 113.5, float(lat), float(lon)) > 0.9


def test_angle_table_is_correctly_rounded_and_within_an_ulp_of_pytorch():
    import torch

    a = 256
    cos_a, sin_a = exact.angle_table(a)
    step = np.float32(math.pi / 2.0 / a)
    for j in range(a):
        ang = float(np.float32(j) * step)
        assert cos_a[j] == np.float32(math.cos(ang)) and sin_a[j] == np.float32(math.sin(ang))
    ang = torch.arange(a, dtype=torch.float32) * torch.tensor(math.pi / 2.0 / a,
                                                               dtype=torch.float32)
    for mine, theirs in ((cos_a, ang.cos().numpy()), (sin_a, ang.sin().numpy())):
        assert np.abs(mine.view(np.int32) - theirs.view(np.int32)).max() <= 1


def _rectangle(theta: float, long: float = 12.0, short: float = 9.0, shift=(700.0, -400.0)):
    """Rows on the edges of a long x short rectangle turned by theta."""
    s = np.linspace(-0.5, 0.5, 41)
    edges = np.concatenate([np.c_[s * long, np.full_like(s, sign * short / 2)] for sign in (-1, 1)]
                           + [np.c_[np.full_like(s, sign * long / 2), s * short]
                              for sign in (-1, 1)])
    rot = np.array([[math.cos(theta), -math.sin(theta)], [math.sin(theta), math.cos(theta)]])
    xy = edges @ rot.T + np.asarray(shift)
    return xy[:, 0].astype(np.float32), xy[:, 1].astype(np.float32)


def test_a_tie_between_neighbouring_angles_accepts_either():
    a = 256
    step = math.pi / 2.0 / a
    x, y = _rectangle((40 + 0.5) * step)
    z = np.linspace(0.0, 30.0, len(x)).astype(np.float32)
    stats = exact.obb_stats(x, y, z, np.zeros(len(x), np.int64), 1, a)
    ties = stats["ties"][0]
    assert len(ties) >= 2
    ref = check.towers_form([True], stats["center"], stats["extent"], stats["north"],
                            stats["count"], stats["ties"])[0]
    for north, cxy, ext in ties:  # each tied answer compares as equal
        got = dict(north=north, center=np.r_[cxy, stats["center"][0][2]],
                   extent=np.r_[ext, stats["extent"][0][2]])
        near = check.nearest_tie(got, ref)
        assert abs(near["north"] - north) < 1e-9
    far = dict(north=(stats["north"][0] + 5.0) % 360.0)
    assert abs((check.nearest_tie(far, ref)["north"] - far["north"] + 180) % 360 - 180) > 4.0


def test_no_tie_far_from_one():
    a = 256
    step = math.pi / 2.0 / a
    x, y = _rectangle(40 * step)
    z = np.zeros(len(x), np.float32)
    stats = exact.obb_stats(x, y, z, np.zeros(len(x), np.int64), 1, a)
    assert len(stats["ties"][0]) == 1


def test_the_tile_whose_tie_flipped_compares_under_either_table(monkeypatch):
    """Seed 4200000003, tile 4 of corridor_stream_1m (float64 rows): the
    correctly rounded table and PyTorch's float32 cos and sin (the
    program's) choose neighbouring angles for one tower; each answer holds
    against the other's reference."""
    import torch

    from portbench.synthetic import make_tiles

    config = json.load(open(os.path.join(harness.ROOT, "portbench/configs/corridor_stream_1m.json")))
    pts = make_tiles(config, 4200000003, 5)[4][0]
    mine = fused.run(pts, config)

    def torch_table(a):
        ang = torch.arange(a, dtype=torch.float32) * torch.tensor(math.pi / 2.0 / a,
                                                                   dtype=torch.float32)
        return ang.cos().numpy(), ang.sin().numpy()
    monkeypatch.setattr(exact, "angle_table", torch_table)
    theirs = fused.run(pts, config)
    assert np.any(np.abs(mine["north"] - theirs["north"])[mine["accepted"]] > 0.3)
    limits = config["check"]
    for a, b in ((mine, theirs), (theirs, mine)):
        nums = check.compare(check.from_reference(a), check.from_reference(b))
        assert all(nums[k] <= limits[k] for k in nums), nums


@pytest.mark.parametrize("lower", ["bfloat16"])
def test_ties_do_not_save_the_control(lower):
    """The control still fails a small tile with ties allowed."""
    from portbench.tests.small import small_info

    info = small_info("tile4m.extract")
    from portbench.synthetic import make_tiles

    pts = make_tiles(info["config"], 21, 1)[0][0]
    ref = check.from_reference(exact.run(pts, info["config"]))
    low = check.from_reference(exact.run(pts, info["config"], lower=lower))
    nums = check.compare(low, ref)
    assert any(nums[k] > info["config"]["check"][k] for k in nums), nums
