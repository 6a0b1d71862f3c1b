"""The rest of ops/segments.py on the port, against the JAX package on the
same sorted keys: segment_spans, the per-row segment sum, max and min
(through segmented_scan, whose plain version on the CPU is the JAX
package's own doubling scan, so sums are bit-equal), and pack_segments
(one stable sort: the rows whose key is below capacity are compared, in
order where keys are distinct and as sets within a run of equal keys)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloudhookup_tpu.ops import segments as jseg
from pointcloudhookup_tpu_torch.ops import segments as seg


def _sorted_keys(rng, n, n_keys):
    return np.sort(rng.integers(0, n_keys, n)).astype(np.int32)


@pytest.mark.parametrize("n,n_keys", [(1, 1), (7, 3), (1000, 40), (4096, 4096), (5000, 1)])
def test_segment_spans_equal(n, n_keys):
    keys = _sorted_keys(np.random.default_rng(n), n, n_keys)
    j_start = jseg.boundary_flags(jnp.asarray(keys))
    t_start = seg.boundary_flags(torch.from_numpy(keys))
    assert np.array_equal(t_start.numpy(), np.asarray(j_start))
    got = seg.segment_spans(t_start)
    ref = jseg.segment_spans(j_start)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("cols", [None, 1, 3, 4])
def test_segment_rows_equal(dtype, cols):
    rng = np.random.default_rng(3 + (cols or 0))
    n = 3000
    keys = _sorted_keys(rng, n, 300)
    shape = (n,) if cols is None else (n, cols)
    vals = (rng.integers(-1000, 1000, shape) if dtype == np.int32
            else rng.normal(0, 50, shape)).astype(dtype)
    j_start = jseg.boundary_flags(jnp.asarray(keys))
    t_start = torch.from_numpy(np.array(j_start))
    _, j_nxt = jseg.segment_spans(j_start)
    _, t_nxt = seg.segment_spans(t_start)
    pairs = (
        (seg.segment_sum_rows(torch.from_numpy(vals), t_start, t_nxt),
         jseg.segment_sum_rows(jnp.asarray(vals), j_start, j_nxt)),
        (seg.segment_max_rows(torch.from_numpy(vals), t_start),
         jseg.segment_max_rows(jnp.asarray(vals), j_start)),
        (seg.segment_min_rows(torch.from_numpy(vals), t_start),
         jseg.segment_min_rows(jnp.asarray(vals), j_start)),
    )
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert got.numpy().dtype == ref.dtype and np.array_equal(got.numpy(), ref)
    # the sum is each segment's, on every one of its rows
    total = np.zeros((300,) + shape[1:], np.float64)
    np.add.at(total, keys, vals)
    np.testing.assert_allclose(pairs[0][0].numpy(), total[keys], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("capacity", [50, 200, 6000])
def test_pack_segments_equal(capacity):
    """One row a segment: its representative (the first row) carries the
    segment's index clipped to capacity, every other row a key above
    capacity.  The rows whose key is below capacity are the JAX package's,
    in order; the stable sort orders the rest by row."""
    rng = np.random.default_rng(capacity)
    n = 5000
    keys = _sorted_keys(rng, n, 400)
    j_start = jseg.boundary_flags(jnp.asarray(keys))
    seg_id = np.cumsum(np.asarray(j_start)) - 1
    sort_key = np.where(np.asarray(j_start), np.minimum(seg_id, capacity), capacity + 7)
    sort_key = sort_key.astype(np.int32)
    payloads = (rng.normal(size=n).astype(np.float32), keys, np.arange(n, dtype=np.int32))
    ref = jseg.pack_segments(jnp.asarray(sort_key), tuple(jnp.asarray(p) for p in payloads),
                             capacity)
    got = seg.pack_segments(torch.from_numpy(sort_key),
                            tuple(torch.from_numpy(p) for p in payloads), capacity)
    assert len(got) == len(ref) == len(payloads)
    live = min(int((sort_key < capacity).sum()), capacity)
    order = np.argsort(sort_key, kind="stable")[:min(capacity, n)]
    for g, r, p in zip(got, ref, payloads):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape == (capacity,) and g.dtype == r.dtype
        assert np.array_equal(g[:live], r[:live])
        assert np.array_equal(g[:min(capacity, n)], p[order])
        if capacity > n:
            assert not g[n:].any() and not r[n:].any()
