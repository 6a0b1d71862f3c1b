"""Each kernel function's bytes and operations against hand counts at
small shapes (the calls run the plain versions on the CPU)."""

import pytest
import torch

from portbench import roofline


def counted(name, *args, **kwargs):
    import importlib

    module, attr = roofline.FUNCTIONS[name]
    out = getattr(importlib.import_module(module), attr)(*args, **kwargs)
    return roofline.cost(name, args, kwargs, out).totals()


def test_compact_rows_multi():
    keep = torch.tensor([1, 0, 1, 0, 0, 1, 0, 0], dtype=torch.bool)
    chans = (torch.arange(8, dtype=torch.int32), torch.arange(8, dtype=torch.int32))
    # keep 8 B, 3 kept rows x 2 channels read (24), 4 slots x 2 written (32), count 4
    assert counted("compact_rows_multi", keep, chans, 4) == (8 + 24 + 32 + 4, 0.0)
    # more kept rows than the capacity: only the capacity's rows move
    assert counted("compact_rows_multi", torch.ones(8, dtype=torch.bool), chans, 4) == (
        8 + 32 + 32 + 4, 0.0)


def test_compact_rows():
    keep = torch.tensor([1, 1, 0, 1], dtype=torch.bool)
    hi = torch.zeros(4, dtype=torch.int32)
    assert counted("compact_rows", keep, hi, hi.clone(), 2) == (4 + 16 + 16 + 4, 0.0)


def test_segmented_scan():
    v = torch.ones(10, 3, dtype=torch.float32)
    f = torch.zeros(10, dtype=torch.bool)
    assert counted("segmented_scan", v, f, "add") == (2 * 120 + 10, 0.0)


def test_pair_kernels():
    m = 8
    xyz = torch.zeros(m, 3)
    lab = torch.zeros(m, dtype=torch.int32)
    w = torch.ones(m)
    alive = torch.ones(m, dtype=torch.bool)
    # inputs 12 + 4 + 4 + 1 bytes a row, two [M] outputs of 4 bytes
    assert counted("neighbor_reduce", xyz, lab, w, alive, 64.0, mode="pop") == (m * 29, 0.0)
    assert counted("cluster_cells", xyz, w, alive, lab, 64.0, 1.0) == (m * 29, 0.0)


def test_obb_accumulate_xyz():
    x = torch.zeros(5)
    labels = torch.tensor([0, 1, -1, 1, 7], dtype=torch.int32)
    nbytes, flops = counted("obb_accumulate_xyz", x, x.clone(), x.clone(), labels,
                            max_clusters=2, num_angles=4)
    assert nbytes == 5 * 16 + 4 * (6 * 2 + 4 * 2 * 4)
    assert flops == 6 * 4 * 3  # three labelled rows below K, four angles


def test_sort_kernels():
    k1 = torch.zeros(16, dtype=torch.int64)
    w = torch.zeros(16, dtype=torch.int32)
    assert counted("first_occurrence_flags", k1, w, 2) == (16 * 8 + 16 * 4 + 16, 0.0)
    assert counted("window_sort_w", k1, w, 8) == (16 * 8 + 2 * 16 * 4, 0.0)
    assert counted("compact_indices", torch.zeros(16, dtype=torch.bool), 4) == (16 + 16, 0.0)


def test_bound_is_the_larger_term():
    c = roofline.Cost(3.35e12)
    assert c.bound_s() == pytest.approx(1.0)
    c = roofline.Cost(0, flops_per_count=67e12, counts=(torch.tensor(2.0),))
    assert c.bound_s() == pytest.approx(2.0)
