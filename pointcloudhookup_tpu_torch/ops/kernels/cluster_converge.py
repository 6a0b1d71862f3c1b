"""Cell-graph DBSCAN: population, core rule, min-label fixpoint, border
adoption.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/cluster_converge.py::
cluster_cells`` with the semantics of its ``cluster_cells_reference``.  The
CUDA kernels are ``csrc/cluster_converge.cu``: six launches in a fixed
sequence (boxes, pop and core, core boxes, union-find hooks, compression,
border) and no host synchronisation; the union-find reaches the min-label
fixpoint of the reference's rounds directly.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace
from pointcloudhookup_tpu_torch.ops.kernels.neighbor import eps_ball_reduce_plain


def cluster_cells(centers, ccount, alive, labels0, eps2, min_points, *,
                  max_iter: int | None = None):
    """centers float32[M,3] (dead rows at +3e38), ccount float32[M], alive
    bool[M], labels0 int32[M] seed labels (used on rows that turn out
    core), eps2 a number or a one-element tensor.  Returns (labels int32[M]
    in [0, M) with M = no cluster, pop float32[M]).

    max_iter bounds the plain version's min-label rounds.  The kernels run
    no rounds: they compute the fixpoint, which max_iter=None or >= M
    reaches, and a smaller max_iter raises on the card (a truncated flood is
    no shared contract: the TPU kernel's sweeps and the reference's rounds
    truncate differently)."""
    m = centers.shape[0]
    if centers.device.type == "cpu":
        return cluster_cells_plain(
            centers, ccount, alive, labels0, eps2, min_points, max_iter=max_iter
        )
    if max_iter is not None and max_iter < m:
        raise ValueError(
            f"cluster_cells: max_iter={max_iter} < M={m}; the CUDA kernels "
            "compute the fixpoint (no rounds to truncate)"
        )
    build.require_cuda("cluster_cells", centers, ccount, alive, labels0)
    if centers.dtype != torch.float32 or centers.shape != (m, 3):
        raise ValueError("centers must be float32[M, 3]")
    if ccount.dtype != torch.float32 or ccount.shape != (m,):
        raise ValueError("ccount must be float32[M]")
    if alive.dtype != torch.bool or alive.shape != (m,):
        raise ValueError("alive must be bool[M]")
    if labels0.dtype != torch.int32 or labels0.shape != (m,):
        raise ValueError("labels0 must be int32[M]")
    lib = build.library()
    dev = centers.device
    eps2 = build.f32_scalar(eps2, dev)
    scratch = torch.empty(lib.pch_cluster_cells_scratch(m), dtype=torch.uint8, device=dev)
    pop = torch.empty(m, dtype=torch.float32, device=dev)
    labels = torch.empty(m, dtype=torch.int32, device=dev)
    build.check(
        lib.pch_cluster_cells(
            centers.data_ptr(), ccount.data_ptr(), alive.data_ptr(),
            labels0.data_ptr(), m, eps2.data_ptr(), float(min_points),
            scratch.data_ptr(), pop.data_ptr(), labels.data_ptr(), build.stream(dev),
        ),
        "cluster_cells",
    )
    trace.count("kernel.cluster_cells")
    return labels, pop


def cluster_cells_plain(centers, ccount, alive, labels0, eps2, min_points, *,
                        max_iter: int | None = None):
    """Plain PyTorch version: same contract."""
    m = centers.shape[0]
    if max_iter is None:
        max_iter = m
    sent = torch.tensor(m, dtype=torch.int32, device=centers.device)
    pop, _ = eps_ball_reduce_plain(centers, alive, eps2, weights=ccount)
    pop = torch.where(centers[:, 0].abs() < 1e37, pop, 0.0)
    core = alive & (pop >= torch.tensor(float(min_points), dtype=torch.float32))
    labels = torch.where(core, labels0, sent)
    for _ in range(max_iter):
        _, lmin = eps_ball_reduce_plain(
            centers, core, eps2, labels=labels, sentinel=m
        )
        new = torch.where(core, torch.minimum(labels, lmin), labels)
        done = bool(torch.equal(new, labels))
        labels = new
        if done:
            break
    _, border = eps_ball_reduce_plain(centers, core, eps2, labels=labels, sentinel=m)
    labels = torch.where(core, labels, torch.where(alive, border, sent))
    return labels, pop
