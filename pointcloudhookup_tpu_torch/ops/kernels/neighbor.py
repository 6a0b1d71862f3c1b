"""Fused eps-neighborhood population + min-label reduction.

Counterpart of ``pointcloudhookup_tpu/ops/pallas/neighbor.py::
neighbor_reduce``.  The CUDA kernel is ``csrc/neighbor.cu``: a box prepass
and the culled pair pass of ``csrc/eps_ball.cuh`` (two launches, one
count).  The plain PyTorch version ``eps_ball_reduce_plain`` is shared with
``cluster_converge.py``: rows in chunks (a dense [65536, 65536] d2 would
take 17 GB) against the allowed columns near the chunk only, which leaves
pop and lmin unchanged.
"""

from __future__ import annotations

import torch

from pointcloudhookup_tpu_torch.ops.kernels import build
from pointcloudhookup_tpu_torch.utils import trace


_MODES = {"both": 0, "pop": 1, "lmin": 2}
_CHUNK_ROWS = 512  # rows per chunk of the plain version


def neighbor_reduce(xyz, labels, weights, allowed, eps2, *, sentinel=None,
                    mode: str = "both"):
    """pop[i] = sum_j [d2(i,j) <= eps2 & allowed_j] * w_j and
    lmin[i] = min label_j over the same set (``sentinel`` if empty).

    xyz float32[M,3], labels int32[M], weights float32[M], allowed bool[M];
    eps2 a number or a one-element tensor (read on the card: no host sync);
    d2 from coordinate differences.  mode "pop" / "lmin" skips the other
    reduction, whose output then holds its identity (zeros / sentinel).
    The kernel adds pop's terms in another order than the plain version:
    identical for integer-valued weights (every caller's), within the f32
    summation bound otherwise.  Returns (pop float32[M], lmin int32[M])."""
    if mode not in _MODES:
        raise ValueError(f"bad mode {mode!r}")
    m = xyz.shape[0]
    if sentinel is None:
        sentinel = m
    if xyz.device.type == "cpu":
        return neighbor_reduce_plain(
            xyz, labels, weights, allowed, eps2, sentinel=sentinel, mode=mode
        )
    build.require_cuda("neighbor_reduce", xyz, labels, weights, allowed)
    if xyz.dtype != torch.float32 or xyz.shape != (m, 3):
        raise ValueError("xyz must be float32[M, 3]")
    if labels.dtype != torch.int32 or labels.shape != (m,):
        raise ValueError("labels must be int32[M]")
    if weights.dtype != torch.float32 or weights.shape != (m,):
        raise ValueError("weights must be float32[M]")
    if allowed.dtype != torch.bool or allowed.shape != (m,):
        raise ValueError("allowed must be bool[M]")
    lib = build.library()
    dev = xyz.device
    eps2 = build.f32_scalar(eps2, dev)
    scratch = torch.empty(lib.pch_neighbor_scratch(m), dtype=torch.uint8, device=dev)
    pop = torch.empty(m, dtype=torch.float32, device=dev)
    lmin = torch.empty(m, dtype=torch.int32, device=dev)
    rc = lib.pch_neighbor_reduce(
        xyz.data_ptr(), labels.data_ptr(), weights.data_ptr(),
        allowed.data_ptr(), m, eps2.data_ptr(), int(sentinel), _MODES[mode],
        scratch.data_ptr(), pop.data_ptr(), lmin.data_ptr(), build.stream(dev),
    )
    build.check(rc, "neighbor_reduce")
    trace.count("kernel.neighbor_reduce")
    return pop, lmin


def neighbor_reduce_plain(xyz, labels, weights, allowed, eps2, *,
                          sentinel=None, mode: str = "both"):
    """Plain PyTorch version: same contract."""
    m = xyz.shape[0]
    if sentinel is None:
        sentinel = m
    pop, lmin = eps_ball_reduce_plain(
        xyz, allowed, eps2,
        weights=weights if mode in ("both", "pop") else None,
        labels=labels if mode in ("both", "lmin") else None,
        sentinel=sentinel,
    )
    if pop is None:
        pop = torch.zeros(m, dtype=torch.float32, device=xyz.device)
    if lmin is None:
        lmin = torch.full((m,), sentinel, dtype=torch.int32, device=xyz.device)
    return pop, lmin


def eps_ball_reduce_plain(xyz, allowed, eps2, *, weights=None, labels=None,
                          sentinel: int = 0):
    """Pairwise eps-ball pass over the allowed columns, rows in chunks:
    (sum of weights or None, min of labels / sentinel or None).

    Each chunk of _CHUNK_ROWS rows (cell-ordered, so spatially compact)
    only tests the columns inside its bounding box widened by 2 eps on
    every axis: a column outside is farther than eps from every row of the
    chunk, so pop and lmin are unchanged (pop sums integer-valued weights,
    exact in any order)."""
    m = xyz.shape[0]
    dev = xyz.device
    eps2 = torch.tensor(float(eps2), dtype=torch.float32, device=dev)
    margin = 2.0 * torch.sqrt(eps2)
    cols = torch.nonzero(allowed).squeeze(1)
    cxyz = xyz[cols]
    cw = weights[cols] if weights is not None else None
    cl = labels[cols] if labels is not None else None
    pop = torch.zeros(m, dtype=torch.float32, device=dev) if cw is not None else None
    lmin = (
        torch.full((m,), sentinel, dtype=torch.int32, device=dev)
        if cl is not None else None
    )
    if cols.numel() == 0 or m == 0:
        return pop, lmin
    sent = torch.tensor(sentinel, dtype=torch.int32, device=dev)
    for r0 in range(0, m, _CHUNK_ROWS):
        r = xyz[r0 : r0 + _CHUNK_ROWS]
        near = ((cxyz >= r.amin(0) - margin) & (cxyz <= r.amax(0) + margin)).all(1)
        sel = torch.nonzero(near).squeeze(1)
        if sel.numel() == 0:
            continue  # pop stays 0, lmin the sentinel
        c = cxyz[sel]
        dx = r[:, 0:1] - c[None, :, 0]
        dy = r[:, 1:2] - c[None, :, 1]
        dz = r[:, 2:3] - c[None, :, 2]
        nb = dx * dx + dy * dy + dz * dz <= eps2
        if pop is not None:
            pop[r0 : r0 + _CHUNK_ROWS] = torch.where(nb, cw[sel][None, :], 0.0).sum(dim=1)
        if lmin is not None:
            lmin[r0 : r0 + _CHUNK_ROWS] = torch.where(nb, cl[sel][None, :], sent).amin(dim=1)
    return pop, lmin
