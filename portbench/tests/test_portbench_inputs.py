"""The yardstick's inputs: seeded tiles and the frozen LAS writer."""

import numpy as np

from portbench.tests.small import small_info


def test_seeded_tiles_repeat_byte_for_byte():
    from portbench.synthetic import make_tiles

    config = small_info("tile4m.extract")["config"]
    seed = 2**31 + 11  # seeds are wider than 32 signed bits
    a = make_tiles(config, seed, 2)
    b = make_tiles(config, seed, 2)
    for (pa, ca), (pb, cb) in zip(a, b):
        assert pa.tobytes() == pb.tobytes() and ca.tobytes() == cb.tobytes()
    other = make_tiles(config, seed + 1, 1)[0][0]
    assert other.shape == a[0][0].shape and not np.array_equal(other, a[0][0])
    assert a[0][0].tobytes() != a[1][0].tobytes()  # distinct tiles of one run


def test_negative_seed_is_a_seed():
    from portbench.synthetic import make_tiles

    config = small_info("tile4m.extract")["config"]
    assert make_tiles(config, -5, 1)[0][0].shape == (config["tile"]["points"], 3)


def test_centred_tiles_shift_along_x():
    from portbench.synthetic import make_tiles

    config = small_info("stream1m.las")["config"]
    (p0, _), (p1, _) = make_tiles(config, 3, 2)
    assert abs(p0[:, 0].mean()) < 1.0
    assert abs(p1[:, 0].mean() - config["tile"]["shift_m"]) < 1.0


def test_las_writer_round_trips(tmp_path):
    from pointcloudhookup_tpu_torch.io.las import read_las as program_read_las

    from portbench import lasio

    rng = np.random.default_rng(0)
    pts = rng.uniform(-500, 500, (1000, 3)) + np.array([450909.8, 3120707.2, 80.0])
    path = str(tmp_path / "t.las")
    lasio.write_las(path, pts, 0.01)
    got = lasio.read_las(path)
    assert np.abs(got - pts).max() <= 0.005 + 1e-9
    assert np.array_equal(program_read_las(path).xyz(), got)
    lasio.write_las(str(tmp_path / "u.las"), got, 0.01)
    assert np.array_equal(lasio.read_las(str(tmp_path / "u.las")), got)
