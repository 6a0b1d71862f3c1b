"""Cluster-label helpers.

Counterpart of ``pointcloudhookup_tpu/ops/cluster.py``; only
``compact_labels`` is on the exact extraction path so far.
"""

from __future__ import annotations

import torch


def compact_labels(raw, inf: int):
    """Map representative-index labels (``inf`` = noise) to compact ids
    0..K-1 ordered by ascending representative; noise -> -1.

    Sort, rank each run of equal values, and deliver the ranks back
    through the inverse permutation (a scatter, which Hopper does
    natively; the TPU version sorted a second time)."""
    sorted_lab, src = torch.sort(raw, stable=True)
    is_new = sorted_lab != torch.roll(sorted_lab, 1)
    is_new[0] = True
    valid = is_new & (sorted_lab < inf)
    rank = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    rank_orig = torch.empty_like(rank)
    rank_orig[src] = rank
    return torch.where(raw < inf, rank_orig, -1)
