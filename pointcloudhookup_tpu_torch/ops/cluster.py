"""DBSCAN-equivalent Euclidean clustering.

Counterpart of ``pointcloudhookup_tpu/ops/cluster.py`` (``dbscan``,
``dbscan_chunked``, ``merge_cluster_fragments``, ``compact_labels``).
Semantics are the JAX package's: a core point has at least min_points
masked points (itself included) within eps, core points within eps share a
cluster, a border point adopts the minimum label of its core neighbours,
and compact ids are numbered by ascending minimum core-point index.

Both JAX branches (the tiled XLA passes and the Pallas ``neighbor_reduce``)
compute one contract: pop over the masked rows, the core rule, the
min-index fixpoint over the core graph, border adoption.  That contract is
``cluster_cells`` (``ops/kernels/cluster_converge.py``), called once with
the original row index as the seed label: on the card six launches and no
host read, where the JAX package runs up to ``max_iters`` Jacobi rounds.
The kernel culls pairs by 32-row subtile boxes, so the rows go in sorted
by a Morton key of their eps cell and the results are scattered back; the
seed labels keep the original indices, so neither the fixpoint nor the
compact ids depend on that order.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels.build import f32_scalar
from pointcloudhookup_tpu_torch.ops.kernels.cluster_converge import cluster_cells
from pointcloudhookup_tpu_torch.ops.morton import morton_encode
from pointcloudhookup_tpu_torch.utils import trace

_BIG = 3.0e38
_DEAD_KEY = 1 << 62  # sorts after every 60-bit Morton code
_MERGE_ROUNDS = 16  # the JAX merge_cluster_fragments' default max_iters


def compact_labels(raw, inf: int):
    """Map representative-index labels (``inf`` = noise) to compact ids
    0..K-1 ordered by ascending representative; noise -> -1.

    Sort, rank each run of equal values, and deliver the ranks back
    through the inverse permutation (a scatter, which Hopper does
    natively; the TPU version sorted a second time)."""
    sorted_lab, src = torch.sort(raw, stable=True)
    is_new = sorted_lab != torch.roll(sorted_lab, 1)
    is_new[:1].fill_(True)  # a fill kernel: item assignment would copy from the host
    valid = is_new & (sorted_lab < inf)
    rank = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    rank_orig = torch.empty_like(rank)
    rank_orig[src] = rank
    return torch.where(raw < inf, rank_orig, -1)


def _cell_order(xyz, mask, eps):
    """Permutation that sorts the rows by the Morton key of their eps-sized
    cell (masked rows first, the rest after them in row order): a 32-row
    run of the result is spatially compact, which is what the pair
    kernels' culling needs.  Any order gives the same clustering."""
    mn = torch.where(mask[:, None], xyz, _BIG).amin(dim=0)
    inv = 1.0 / eps
    ijk = torch.floor(torch.where(mask[:, None], xyz - mn, 0.0) * inv).to(torch.int32)
    hi, lo = morton_encode(ijk[:, 0], ijk[:, 1], ijk[:, 2])
    key = (hi.to(torch.int64) << 30) | lo.to(torch.int64)
    return torch.sort(torch.where(mask, key, _DEAD_KEY), stable=True).indices


def dbscan(xyz, mask, eps, min_points: int, *, max_iters: int | None = None):
    """Cluster points within eps (DBSCAN semantics).

    xyz float32[N,3], mask bool[N], eps a number or a 0-d tensor.  Returns
    (labels int32[N] compact cluster ids ordered by min core index, -1 for
    noise or masked-out rows; core bool[N]).

    max_iters=None computes the converged fixpoint, which the JAX
    function's 64 rounds reach on every tile the tests hold
    (tests/test_torch_cluster.py::test_reference_rounds_have_converged).
    An int bounds the plain version's rounds and, below N, raises on the
    card (``cluster_cells``): tests/test_torch_cluster.py::
    test_max_iters_64_matches_jax and tests/test_torch_cuda.py::
    test_modular_clustering_max_iters_cuda hold both."""
    n = xyz.shape[0]
    dev = xyz.device
    eps_t = f32_scalar(eps, dev).reshape(())  # no host-to-device copy
    order = _cell_order(xyz, mask, eps_t)
    alive = mask[order]
    centers = torch.where(alive[:, None], xyz[order], _BIG).contiguous()
    labels_s, pop = cluster_cells(
        centers, alive.to(torch.float32), alive, order.to(torch.int32),
        eps_t * eps_t, float(min_points), max_iter=max_iters,
    )
    core_s = alive & (pop >= float(min_points))
    raw = torch.empty(n, dtype=torch.int32, device=dev)
    raw[order] = labels_s
    core = torch.empty(n, dtype=torch.bool, device=dev)
    core[order] = core_s
    return compact_labels(raw, n), core


def dbscan_chunked(xyz, mask, eps, min_points: int, *, chunk_size: int = 50_000,
                   max_iters: int | None = None):
    """Reference-parity chunked clustering: each contiguous chunk of
    ``chunk_size`` rows is clustered on its own and its labels are offset
    by ``chunk * chunk_size`` so they stay globally unique (the reference
    never merges across chunks).  N must be a multiple of chunk_size.
    Each chunk counts as ``cluster.chunks``."""
    n = xyz.shape[0]
    if n % chunk_size:
        raise ValueError(f"capacity {n} not a multiple of chunk_size {chunk_size}")
    labels, core = [], []
    for c0 in range(0, n, chunk_size):
        trace.count("cluster.chunks")
        lab, cor = dbscan(xyz[c0 : c0 + chunk_size], mask[c0 : c0 + chunk_size], eps,
                          min_points, max_iters=max_iters)
        labels.append(torch.where(lab >= 0, lab + c0, -1))
        core.append(cor)
    return torch.cat(labels), torch.cat(core)


def merge_cluster_fragments(labels, xyz, mask, merge_radius, *, max_clusters: int = 256):
    """Cross-chunk cluster merging: clusters whose centroids lie within
    ``merge_radius`` are unioned.  labels int32[N] ids in [0, max_clusters)
    or -1.  Returns compact int32[N] labels (-1 noise kept).

    Plain PyTorch on the tensors' device (K <= 256 clusters): the centroid
    sums are ``index_add_`` (on the card they may add in another order, so
    centroids agree to f32 summation order), then 16 rounds of
    min-label propagation with one pointer jump.  The JAX function stops
    early once a round changes nothing; the rounds after that change
    nothing either, so running all of them needs no host read."""
    k = max_clusters
    dev = labels.device
    ok = (labels >= 0) & mask
    lab = torch.where(ok, labels, k).long()
    w = ok.to(torch.float32)
    sums = torch.zeros((k + 1, 3), dtype=torch.float32, device=dev).index_add_(
        0, lab, xyz * w[:, None])[:k]
    cnts = torch.zeros(k + 1, dtype=torch.float32, device=dev).index_add_(0, lab, w)[:k]
    cent = sums / torch.clamp(cnts, min=1.0)[:, None]
    alive = cnts > 0
    d2 = (cent[:, None, :] - cent[None, :, :]).square().sum(dim=-1)
    r2 = torch.tensor(merge_radius, dtype=torch.float32, device=dev).square()
    adj = (d2 <= r2) & alive[:, None] & alive[None, :]
    sent = torch.tensor(k, dtype=torch.int32, device=dev)
    rep = torch.where(alive, torch.arange(k, dtype=torch.int32, device=dev), sent)
    for _ in range(_MERGE_ROUNDS):
        nm = torch.where(adj, rep[None, :], sent).amin(dim=1)
        new = torch.where(alive, torch.minimum(rep, nm), rep)
        rep = torch.where(alive, torch.minimum(new, new[torch.clamp(new, 0, k - 1).long()]),
                          new)
    merged = torch.where(labels >= 0, rep[torch.clamp(labels, 0, k - 1).long()], sent)
    return compact_labels(merged, k)
