"""Cell-graph DBSCAN: population, core rule, min-label fixpoint, border
adoption.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/cluster_converge.py::
cluster_cells`` with the semantics of its ``cluster_cells_reference``.  The
CUDA kernels are ``csrc/cluster_converge.cu``: one launch for the
population, one per Jacobi round (this wrapper loops until a device flag
stays clear, at most ``max_iter`` rounds), one for the border.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.ops.kernels.neighbor import eps_ball_reduce_plain

launches = 0  # cluster_cells calls that ran the kernels (read and reset by chip_smoke.py)
rounds = 0  # Jacobi rounds of the last such call (chip_smoke.py's bound)


def cluster_cells(centers, ccount, alive, labels0, eps2, min_points, *,
                  max_iter: int | None = None):
    """centers float32[M,3] (dead rows at +3e38), ccount float32[M], alive
    bool[M], labels0 int32[M] seed labels (used on rows that turn out
    core).  Returns (labels int32[M] in [0, M) with M = no cluster,
    pop float32[M])."""
    m = centers.shape[0]
    if max_iter is None:
        max_iter = m  # worst-case chain length
    if centers.device.type == "cpu":
        return cluster_cells_plain(
            centers, ccount, alive, labels0, eps2, min_points, max_iter=max_iter
        )
    global launches, rounds
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
    st = build.stream(dev)
    eps2 = float(eps2)
    pop = torch.empty(m, dtype=torch.float32, device=dev)
    core = torch.empty(m, dtype=torch.bool, device=dev)
    cur = torch.empty(m, dtype=torch.int32, device=dev)
    nxt = torch.empty_like(cur)
    changed = torch.empty(1, dtype=torch.int32, device=dev)
    build.check(
        lib.pch_cluster_pop(
            centers.data_ptr(), ccount.data_ptr(), alive.data_ptr(),
            labels0.data_ptr(), m, eps2, float(min_points), pop.data_ptr(),
            core.data_ptr(), cur.data_ptr(), st,
        ),
        "cluster_cells pop",
    )
    for rounds in range(1, max_iter + 1):
        build.check(
            lib.pch_cluster_round(
                centers.data_ptr(), core.data_ptr(), cur.data_ptr(), m, eps2,
                nxt.data_ptr(), changed.data_ptr(), st,
            ),
            "cluster_cells round",
        )
        cur, nxt = nxt, cur
        if int(changed.item()) == 0:
            break
    labels = torch.empty(m, dtype=torch.int32, device=dev)
    build.check(
        lib.pch_cluster_border(
            centers.data_ptr(), core.data_ptr(), alive.data_ptr(),
            cur.data_ptr(), m, eps2, labels.data_ptr(), st,
        ),
        "cluster_cells border",
    )
    launches += 1
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
